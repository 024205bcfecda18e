"""CLI: ``python -m pvraft_tpu_torch.analysis {lint,concurrency,
determinism,sharding}``.

``lint`` (graftlint) runs GL006 (mutable default arguments) and GL007
(an f-string passed to ``*.debug.print``) over the port's own Python
(default scope the ``pvraft_tpu_torch`` package, ``chip_smoke.py`` and
``tests/test_torch_*.py``; the JAX package's ``lint`` requires paths);
pure stdlib AST. ``--stats`` prints the suppression-debt report instead
of findings: every active pragma under the paths, counted per rule id of
the port's one namespace (GC, GD, GS and GL), a warning for an unknown
id, exit 1 on a pragma without a ``-- reason``.

``concurrency`` (threadcheck) runs the GC001+ rules (guarded-by
discipline, lock-order cycles, check-then-act shapes, un-joined threads)
over the port's hand-threaded planes (default scope ``serve/``,
``fleet/``, ``obs/``, ``data/loader.py``); pure stdlib AST.

``determinism`` (detcheck) runs the GD001+ rules (a seed stream derived
twice alike, RNG constructors or time-derived seeds outside the
``rng.py`` stream contract, hazard-op programs without a
``determinism=`` stance, backend determinism flags written outside
``device.py``, unsorted glob or set iteration) over the whole package.
With ``--replay`` it runs the bitwise replay harness instead
(``analysis/determinism/replay.py``): the train step and a serve
dispatch, each built twice from scratch and run once, every output and
state tensor compared bit for bit; prints the ``pvraft_determinism/v1``
report (``--out`` writes it), ``--check R`` holds it against a saved
report. The replay runs on the card unless ``--device cpu``; ``--size``
defaults to "flagship" on the card and "tiny" on the CPU.

``sharding`` (shardcheck) runs GS004 (a filesystem write that no
process-0 test dominates) over the port's every-rank planes (default
scope ``engine/``, ``obs/``, ``parallel/``); pure stdlib AST. With
``--plan`` it builds the ``pvraft_pod_plan/v1`` document instead
(``analysis/sharding/planner.py``): per-device bytes, the ring's
traffic and a fits verdict for each (data, seq) mesh of one 8-GPU node
and each scene size, from a costs document (``--costs``, default
``programs/costs.py::default_costs_path()``; without one there, the two
programs the plan reads are counted on ``--device``) and the port's
model; ``--out`` writes it, ``--check P`` holds it against a saved plan.
``--measure`` then runs one remat train step on the card at the largest
scene the plan says fits one card and prints the plan's prediction
beside ``max_memory_allocated``.

The static checks print one line per finding and exit 1 on any; the
replay exits 1 on a divergence or a failed check; the plan exits 1 when
it cannot be built (a GS004 finding, a failed cross-check).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _list_rules(rules) -> int:
    for rule in rules:
        doc = (rule.__doc__ or "").strip().splitlines()[0]
        print(f"{rule.id}  {rule.title:<28} {doc}")
    return 0


def _report(tool: str, diags, nfiles: int) -> int:
    for d in diags:
        print(d.format())
    print(f"{tool}: {len(diags)} finding(s) in {nfiles} file(s)",
          file=sys.stderr)
    return 1 if diags else 0


def _select(args):
    return tuple(args.select.split(",")) if args.select else ()


def _cmd_lint(args) -> int:
    from pvraft_tpu_torch.analysis.lint import default_scope, lint_paths
    from pvraft_tpu_torch.analysis.rules import all_lint_rules

    if args.list_rules:
        return _list_rules(all_lint_rules())
    paths = args.paths or list(default_scope())
    if args.stats:
        return _lint_stats(paths)
    diags, nfiles = lint_paths(paths, rule_ids=_select(args))
    return _report("graftlint", diags, nfiles)


def _lint_stats(paths) -> int:
    """Suppression-debt report: what the checks are not checking, per
    rule. Exit 1 on any reason-less suppression."""
    from pvraft_tpu_torch.analysis.engine import (
        collect_suppressions,
        known_rule_ids,
    )

    pragmas = collect_suppressions(paths)
    known = known_rule_ids()
    per_rule: dict = {}
    reasonless = []
    unknown = []
    for p in pragmas:
        for rid in p.ids:
            stats = per_rule.setdefault(
                rid, {"line": 0, "next": 0, "file": 0, "reasonless": 0})
            stats[p.kind] += 1
            if not p.reason:
                stats["reasonless"] += 1
            if rid != "all" and rid not in known:
                unknown.append((p, rid))
        if not p.reason:
            reasonless.append(p)
    for rid in sorted(per_rule):
        s = per_rule[rid]
        total = s["line"] + s["next"] + s["file"]
        print(f"{rid:<7} {total:>3} suppression(s)  "
              f"(line={s['line']} next={s['next']} file={s['file']}, "
              f"{s['reasonless']} without reason)")
    for p, rid in unknown:
        print(f"{p.path}:{p.line}: warning: suppression names unknown "
              f"rule {rid}")
    for p in reasonless:
        print(f"{p.path}:{p.line}: reason-less suppression of "
              f"{','.join(p.ids)} (append `-- why`)")
    print(f"graftlint --stats: {len(pragmas)} active pragma(s), "
          f"{len(reasonless)} without reason", file=sys.stderr)
    return 1 if reasonless else 0


def _cmd_concurrency(args) -> int:
    from pvraft_tpu_torch.analysis.concurrency.check import (
        check_paths,
        default_scope,
    )
    from pvraft_tpu_torch.analysis.concurrency.rules import (
        all_concurrency_rules,
    )

    if args.list_rules:
        return _list_rules(all_concurrency_rules())
    diags, nfiles = check_paths(args.paths or list(default_scope()),
                                rule_ids=_select(args))
    return _report("threadcheck", diags, nfiles)


def _cmd_determinism(args) -> int:
    from pvraft_tpu_torch.analysis.determinism.check import (
        check_paths,
        default_scope,
    )
    from pvraft_tpu_torch.analysis.determinism.rules import (
        all_determinism_rules,
    )

    if args.list_rules:
        return _list_rules(all_determinism_rules())
    if args.replay or args.check:
        return _determinism_replay(args)
    diags, nfiles = check_paths(args.paths or list(default_scope()),
                                rule_ids=_select(args))
    return _report("detcheck", diags, nfiles)


def _cmd_sharding(args) -> int:
    from pvraft_tpu_torch.analysis.sharding.check import (
        check_paths,
        default_scope,
    )
    from pvraft_tpu_torch.analysis.sharding.rules import all_sharding_rules

    if args.list_rules:
        return _list_rules(all_sharding_rules())
    if args.plan or args.check or args.measure:
        return _sharding_plan(args)
    diags, nfiles = check_paths(args.paths or list(default_scope()),
                                rule_ids=_select(args))
    return _report("shardcheck", diags, nfiles)


def _sharding_plan(args) -> int:
    from pvraft_tpu_torch.analysis.sharding.planner import (
        basis_inventory,
        build_plan,
        check_plan_file,
        fold_chunk,
        largest_fitting_scene,
        measure_step_peak,
        predict_step_bytes,
        write_plan,
    )
    from pvraft_tpu_torch.programs.costs import default_costs_path

    costs = args.costs or default_costs_path()
    if not args.costs and not os.path.exists(costs):
        print(f"sharding --plan: no costs document at {costs}; counting "
              f"the plan's two programs", file=sys.stderr)
        costs = basis_inventory(args.device)
    if args.check:
        problems = check_plan_file(args.check, costs)
        for p in problems:
            print(p, file=sys.stderr)
        if not problems:
            print(f"{args.check}: OK (matches the plan rebuilt from the "
                  f"costs document and the port's model)")
        return 1 if problems else 0
    try:
        plan = build_plan(costs)
    except (OSError, ValueError) as e:
        print(f"sharding --plan: {e}", file=sys.stderr)
        return 1
    if args.out:
        write_plan(plan, args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    elif not args.measure:
        print(json.dumps(plan, indent=1, sort_keys=True))
    for n_points, verdict in sorted(plan["scene_verdicts"].items(),
                                    key=lambda kv: int(kv[0])):
        print(f"[pod] {n_points} points: {verdict}", file=sys.stderr)
    if args.measure:
        points = largest_fitting_scene(plan)
        if points is None:
            print("sharding --measure: no scene fits one card",
                  file=sys.stderr)
            return 1
        chunk = fold_chunk(points)
        predicted = predict_step_bytes(plan, points, 1, chunk)
        got = measure_step_peak(points, chunk=chunk, device=args.device)
        measured = got.get("max_memory_allocated")
        print(json.dumps({"predicted": predicted, "measured": got,
                          "ratio": (predicted["total_bytes"] / measured
                                    if measured else None)},
                         sort_keys=True))
    return 0


def _determinism_replay(args) -> int:
    from pvraft_tpu_torch.device import fix_cublas_workspace, resolve_device

    fix_cublas_workspace()
    from pvraft_tpu_torch.analysis.determinism.replay import (
        check_report,
        replay_report,
        write_report,
    )

    device = resolve_device(args.device)
    size = args.size or ("flagship" if device.type == "cuda" else "tiny")
    report = replay_report(device, size)
    if args.out:
        write_report(args.out, report)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(json.dumps(report, indent=2, sort_keys=True))
    for e in report["programs"]:
        tag = "bitwise" if e["bitwise_identical"] else "DIVERGENT"
        print(f"[replay] {e['name']}: {tag} ({e['n_output_leaves']} leaves, "
              f"{e['digest'][:16]})", file=sys.stderr)
    problems = check_report(args.check, report) if args.check else []
    for p in problems:
        print(p, file=sys.stderr)
    return 0 if report["verdict"] == "bitwise" and not problems else 1


def _static_args(p, family: str, scope: str) -> None:
    p.add_argument("paths", nargs="*",
                   help=f"files/directories to check (default: {scope})")
    p.add_argument("--list-rules", action="store_true",
                   help=f"print the {family} rule table and exit")
    p.add_argument("--select", default="",
                   help=f"comma-separated {family} rule ids (default all)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pvraft_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_lint = sub.add_parser(
        "lint", help="graftlint: GL006 and GL007 over the port's Python")
    _static_args(p_lint, "GL", "the pvraft_tpu_torch package, chip_smoke.py "
                               "and tests/test_torch_*.py; the JAX "
                               "package's lint requires paths")
    p_lint.add_argument("--stats", action="store_true",
                        help="suppression-debt report (exit 1 on "
                             "reason-less suppressions)")
    p_lint.set_defaults(fn=_cmd_lint)
    p_conc = sub.add_parser(
        "concurrency", help="threadcheck: the GC rules over the "
                            "hand-threaded planes")
    _static_args(p_conc, "GC", "serve/, fleet/, obs/, data/loader.py")
    p_conc.set_defaults(fn=_cmd_concurrency)
    p_det = sub.add_parser(
        "determinism", help="detcheck: the GD rules over the package, or "
                            "the bitwise replay harness (--replay)")
    _static_args(p_det, "GD", "the whole pvraft_tpu_torch package")
    p_det.add_argument("--replay", action="store_true",
                       help="build each program twice and compare bitwise")
    p_det.add_argument("--out", default="", help="write the report here")
    p_det.add_argument("--check", default="", metavar="REPORT",
                       help="hold the fresh replay against a saved report")
    p_det.add_argument("--device", default=None, choices=["cpu", "cuda"],
                       help="cpu: replay on the CPU (default: the card)")
    p_det.add_argument("--size", default=None, choices=["flagship", "tiny"])
    p_det.set_defaults(fn=_cmd_determinism)
    p_shard = sub.add_parser(
        "sharding", help="shardcheck: GS004 over the every-rank planes, "
                         "or the pod plan (--plan)")
    _static_args(p_shard, "GS", "engine/, obs/, parallel/")
    p_shard.add_argument("--plan", action="store_true",
                         help="build the pvraft_pod_plan/v1 document")
    p_shard.add_argument("--costs", default="", metavar="PATH",
                         help="the costs document (default: "
                              "programs/costs.py::default_costs_path())")
    p_shard.add_argument("--out", default="", help="write the plan here")
    p_shard.add_argument("--check", default="", metavar="PLAN",
                         help="hold the rebuilt plan against a saved one")
    p_shard.add_argument("--measure", action="store_true",
                         help="one remat train step at the largest scene "
                              "that fits one card, against the plan")
    p_shard.add_argument("--device", default=None, choices=["cpu", "cuda"],
                         help="cpu: count and measure on the CPU (default: "
                              "the card)")
    p_shard.set_defaults(fn=_cmd_sharding)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
