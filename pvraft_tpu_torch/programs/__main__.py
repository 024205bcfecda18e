"""CLI: ``python -m pvraft_tpu_torch.programs {list,describe,costs,params}``
(the JAX package's subcommands of the same names, over the port's
catalog).

``list`` renders the inventory (nothing is built). ``describe`` builds
one spec and runs it once, printing its inputs' and outputs' shapes.
``costs`` counts every selected spec into the ``pvraft_costs/v1``
inventory (``programs/costs.py``; on the card unless ``--device cpu``,
at ``--size flagship`` or ``tiny``), or with ``--check`` validates a
document (schema and both-direction coverage of the registry) without
running anything. ``params`` writes the ``pvraft_params_tree/v1`` leaf
inventory of the port's flagship model (the JAX parameter paths, shapes
and dtypes), or with ``--check`` compares it against a document.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PARAMS_TREE_SCHEMA = "pvraft_params_tree/v1"


def _selected(args):
    from pvraft_tpu_torch.programs import load_catalog, specs

    load_catalog()
    out = list(specs().values())
    for tag in getattr(args, "tag", None) or ():
        out = [s for s in out if tag in s.tags]
    only = getattr(args, "only", None) or ()
    if only:
        out = [s for s in out if any(sub in s.name for sub in only)]
    return out


def _cmd_list(args) -> int:
    sel = _selected(args)
    header = (f"{'name':<40} {'tags':<16} {'precision':<10} "
              f"{'kernels':<32} about")
    print(header)
    print("-" * len(header))
    for s in sorted(sel, key=lambda s: s.name):
        print(f"{s.name:<40} {','.join(s.tags):<16} {s.precision:<10} "
              f"{','.join(s.kernels) or '-':<32} {s.description}")
    print(f"programs: {len(sel)} spec(s)", file=sys.stderr)
    return 0


def _shapes(tensors) -> str:
    return ", ".join(f"{str(t.dtype).replace('torch.', '')}"
                     f"{list(t.shape)}" for t in tensors)


def _device(name):
    from pvraft_tpu_torch.device import resolve_device

    return resolve_device(name)


def _cmd_describe(args) -> int:
    from pvraft_tpu_torch.programs import get, load_catalog
    from pvraft_tpu_torch.programs.costs import _tensors

    load_catalog()
    try:
        s = get(args.name)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    print(f"name:        {s.name}")
    print(f"tags:        {','.join(s.tags)}")
    print(f"precision:   {s.precision}")
    print(f"kernels:     {','.join(s.kernels) or '-'}")
    print(f"geometry:    {json.dumps(s.geometry, sort_keys=True)}")
    if s.description:
        print(f"about:       {s.description}")
    print(f"declared:    {s.path}:{s.line}")
    fn, inputs = s.build(_device(args.device), args.size)
    print(f"args:        {_shapes(_tensors(list(inputs)))}")
    print(f"out:         {_shapes(_tensors(fn(*inputs)))}")
    return 0


def _cmd_costs(args) -> int:
    from pvraft_tpu_torch.programs.costs import (
        default_costs_path,
        run_costs,
        validate_costs_file,
    )

    if args.check:
        problems = validate_costs_file(args.check, coverage=True)
        for p in problems:
            print(p, file=sys.stderr)
        if not problems:
            print(f"{args.check}: OK (schema + registry coverage)")
        return 1 if problems else 0
    doc = run_costs(_selected(args), _device(args.device), args.size,
                    log=lambda line: print(line, flush=True))
    out = args.out or default_costs_path()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    print(json.dumps({"ok": doc["ok"], "total_s": doc["total_s"],
                      "out": out,
                      "programs": [(r["name"], r["ok"])
                                   for r in doc["programs"]]}))
    return 0 if doc["ok"] else 1


def build_params_tree():
    """The ``pvraft_params_tree/v1`` document of the port's flagship
    PVRaft: every parameter under its JAX path (``weights.params_to_jax``),
    sorted, with shape and dtype, and the totals."""
    import numpy as np

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.models.raft import PVRaft
    from pvraft_tpu_torch.programs.geometries import FLAGSHIP_TRUNCATE_K
    from pvraft_tpu_torch.weights import params_to_jax

    tree = params_to_jax(PVRaft(ModelConfig(
        truncate_k=FLAGSHIP_TRUNCATE_K)).state_dict())

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(value, dict):
                yield from walk(value, path)
            else:
                yield path, np.asarray(value)

    leaves = sorted(({"path": path, "shape": [int(d) for d in arr.shape],
                      "dtype": str(arr.dtype)} for path, arr in walk(tree, "")),
                    key=lambda leaf: leaf["path"])
    sizes = [int(np.prod(leaf["shape"], dtype=np.int64)) for leaf in leaves]
    return {"schema": PARAMS_TREE_SCHEMA, "model": "PVRaft",
            "truncate_k": FLAGSHIP_TRUNCATE_K, "leaves": leaves,
            "total_parameters": sum(sizes),
            "total_bytes": sum(4 * n for n in sizes)}


def _cmd_params(args) -> int:
    fresh = build_params_tree()
    if args.check:
        try:
            with open(args.check, "r", encoding="utf-8") as f:
                committed = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{args.check}: {e}", file=sys.stderr)
            return 1
        if committed != fresh:
            drift = [k for k in sorted(set(committed) | set(fresh))
                     if committed.get(k) != fresh.get(k)]
            print(f"{args.check}: the port's parameter tree differs "
                  f"(keys: {', '.join(drift)})", file=sys.stderr)
            return 1
        print(f"{args.check}: OK (the port's flagship PVRaft, "
              f"{len(fresh['leaves'])} leaves, "
              f"{fresh['total_parameters']} parameters)")
        return 0
    text = json.dumps(fresh, indent=1, sort_keys=True) + "\n"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {args.out} ({len(fresh['leaves'])} leaves, "
              f"{fresh['total_parameters']} parameters)", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pvraft_tpu_torch.programs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--tag", action="append", default=[],
                       help="keep specs carrying TAG (repeatable, ANDed)")
        p.add_argument("--only", action="append", default=[],
                       metavar="SUBSTR",
                       help="keep specs whose name contains SUBSTR "
                            "(repeatable, ORed)")

    def where(p):
        p.add_argument("--device", default=None, choices=["cpu", "cuda"],
                       help="cpu: build on the CPU (default: the card)")
        p.add_argument("--size", default="flagship",
                       choices=["flagship", "tiny"])

    p_list = sub.add_parser("list", help="render the program inventory")
    common(p_list)
    p_list.set_defaults(fn=_cmd_list)

    p_desc = sub.add_parser("describe", help="build and run one spec")
    p_desc.add_argument("name")
    where(p_desc)
    p_desc.set_defaults(fn=_cmd_describe)

    p_costs = sub.add_parser(
        "costs", help="count the pvraft_costs/v1 inventory (or --check a "
                      "document)")
    common(p_costs)
    where(p_costs)
    p_costs.add_argument("--out", default="",
                         help="where to write the inventory (default: "
                              "pvraft_tpu_torch/_build/programs_costs.json)")
    p_costs.add_argument("--check", default="", metavar="PATH",
                         help="validate a document (schema + registry "
                              "coverage) instead of counting")
    p_costs.set_defaults(fn=_cmd_costs)

    p_par = sub.add_parser(
        "params", help="the pvraft_params_tree/v1 leaf inventory (or "
                       "--check a document)")
    p_par.add_argument("--out", default="")
    p_par.add_argument("--check", default="", metavar="PATH")
    p_par.set_defaults(fn=_cmd_params)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
