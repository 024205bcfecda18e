"""CLI: ``python -m pvraft_tpu_torch.analysis determinism --replay``.

The bitwise replay harness (``analysis/determinism/replay.py``): the
train step and a serve dispatch, each built twice from scratch and run
once, every output and state tensor compared bit for bit. Prints the
``pvraft_determinism/v1`` report (``--out`` writes it), ``--check R``
holds it against a saved report. On the card unless ``--device cpu``;
``--size`` defaults to "flagship" on the card and "tiny" on the CPU.
Exit 1 on a divergence or a failed check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_determinism(args) -> int:
    if not args.replay:
        print("determinism: only --replay is ported (the static rules read "
              "jaxprs)", file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace, set before its
    # first call.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from pvraft_tpu_torch.analysis.determinism.replay import (
        check_report,
        replay_report,
        write_report,
    )
    from pvraft_tpu_torch.device import resolve_device

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pvraft_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_det = sub.add_parser("determinism", help="the bitwise replay harness")
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
