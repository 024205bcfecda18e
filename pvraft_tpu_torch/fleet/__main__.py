"""CLI of the fleet tier (port of ``pvraft_tpu/fleet/__main__.py``).

    python -m pvraft_tpu_torch.fleet run --target HOST:PORT \
        --target HOST:PORT [--port N] [--events F] [--cost_surface C]
    python -m pvraft_tpu_torch.fleet validate FLEET_CHAOS.json ...

``run`` puts the router in front of serve hosts that already run
(``python -m pvraft_tpu_torch.serve serve``); ``--events`` writes its
``fleet_route`` and ``canary_verdict`` records as a ``pvraft_events/v1``
stream, ``--cost_surface`` prices its routing from a ``pvraft_costs/v1``
inventory (a bad path fails at once). SIGINT stops it. ``validate``
checks ``pvraft_fleet_chaos/v1`` documents and exits 1 on any problem.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_validate(args) -> int:
    from pvraft_tpu_torch.fleet.artifact import validate_fleet_artifact

    rc = 0
    for path in args.paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            rc = 1
            continue
        problems = validate_fleet_artifact(doc, path=path)
        if problems:
            for p in problems:
                print(f"{path}: {p}", file=sys.stderr)
            rc = 1
        else:
            print(f"{path}: ok (pvraft_fleet_chaos/v1)")
    return rc


def _cmd_run(args) -> int:
    import threading

    from pvraft_tpu_torch.fleet.router import build_fleet

    surface = None
    if args.cost_surface:
        from pvraft_tpu_torch.programs.costs import CostSurface

        surface = CostSurface.load(args.cost_surface)
    telemetry = None
    if args.events:
        from pvraft_tpu_torch.serve.events import ServeTelemetry

        telemetry = ServeTelemetry(args.events)
    router = build_fleet(args.target, telemetry=telemetry,
                         cost_surface=surface, host=args.host,
                         port=args.port, quiet=not args.verbose)
    router.start()
    print(f"fleet router on {router.host}:{router.port} over "
          f"{[b.client.endpoint for b in router.backends]} "
          f"(cost surface {'armed' if surface else 'off'})",
          file=sys.stderr, flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        router.shutdown()
        if telemetry is not None:
            telemetry.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pvraft_tpu_torch.fleet",
                                 allow_abbrev=False)
    sub = ap.add_subparsers(dest="cmd", required=True)
    val = sub.add_parser(
        "validate", help="validate pvraft_fleet_chaos/v1 artifacts")
    val.add_argument("paths", nargs="+")
    val.set_defaults(fn=_cmd_validate)
    run = sub.add_parser(
        "run", help="run the fleet router over N serve hosts")
    run.add_argument("--target", action="append", required=True,
                     metavar="HOST:PORT",
                     help="a backend serve host (repeatable)")
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--port", type=int, default=0,
                     help="router port (0 = ephemeral)")
    run.add_argument("--events", default="",
                     help="fleet event log path (pvraft_events/v1)")
    run.add_argument("--cost_surface", "--cost-surface",
                     dest="cost_surface", default="",
                     help="pvraft_costs/v1 inventory to price routing "
                          "decisions with (python -m pvraft_tpu_torch."
                          "programs costs)")
    run.add_argument("-v", "--verbose", action="store_true",
                     help="log HTTP requests")
    run.set_defaults(fn=_cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
