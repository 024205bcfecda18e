"""CLI of the port's artifact validators (port of
``pvraft_tpu/obs/__main__.py``).

    python -m pvraft_tpu_torch.obs validate RUN.events.jsonl
    python -m pvraft_tpu_torch.obs validate-trace LOAD.trace.json
    python -m pvraft_tpu_torch.obs validate-slo LOAD.slo.json
    python -m pvraft_tpu_torch.obs validate-capacity CAPACITY.json
    python -m pvraft_tpu_torch.obs validate-calibration CALIBRATION.json

Each prints ``PATH: OK`` for a valid file and its problems on stderr
otherwise, and exits 1 if any file has one. ``validate-bench`` is
refused: ``pvraft_bench/v1`` belongs to the benchmark cell (ROADMAP,
"The order for the next PRs", item 3).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from pvraft_tpu_torch.obs.calibration import validate_calibration_file
from pvraft_tpu_torch.obs.capacity import validate_capacity_file
from pvraft_tpu_torch.obs.events import validate_events_file
from pvraft_tpu_torch.obs.slo import validate_slo_report_file
from pvraft_tpu_torch.obs.trace import validate_trace_artifact_file


def _run(paths, validate) -> int:
    failed = 0
    for path in paths:
        try:
            problems = validate(path)
        except OSError as e:
            problems = [f"{path}: unreadable: {e}"]
        if problems:
            failed += 1
            for p in problems:
                print(p, file=sys.stderr)
        else:
            print(f"{path}: OK")
    return 1 if failed else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser("python -m pvraft_tpu_torch.obs",
                                     allow_abbrev=False)
    sub = parser.add_subparsers(dest="cmd", required=True)
    if argv and argv[0] == "validate-bench":
        parser.error("validate-bench is not ported yet: pvraft_bench/v1 "
                     "comes with the benchmark cell (ROADMAP order item 3)")
    for name, what, validate in (
            ("validate", "pvraft_events/v1 JSONL files",
             validate_events_file),
            ("validate-trace", "pvraft_trace/v1 artifacts",
             validate_trace_artifact_file),
            ("validate-slo", "pvraft_slo/v1 reports",
             validate_slo_report_file),
            ("validate-capacity", "pvraft_capacity/v1 plans",
             validate_capacity_file),
            ("validate-calibration", "pvraft_cost_calibration/v1 evidence",
             validate_calibration_file)):
        cmd = sub.add_parser(name, help=f"validate {what}")
        cmd.add_argument("paths", nargs="+")
        cmd.set_defaults(validate=validate)
    args = parser.parse_args(argv)
    return _run(args.paths, args.validate)


if __name__ == "__main__":
    sys.exit(main())
