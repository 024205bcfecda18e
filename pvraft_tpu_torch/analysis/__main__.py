"""CLI: ``python -m pvraft_tpu_torch.analysis {concurrency,determinism}``.

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

Both static checks print one line per finding and exit 1 on any; the
replay exits 1 on a divergence or a failed check.
"""

from __future__ import annotations

import argparse
import json
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
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
