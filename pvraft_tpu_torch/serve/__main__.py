"""CLI of the port's scene-flow service.

    python -m pvraft_tpu_torch.serve serve --ckpt CKPT.msgpack \
        [--port 8000] [--buckets 2048,4096,8192] [--platform cpu] ...

The JAX package's ``serve`` flags and defaults
(``pvraft_tpu/serve/__main__.py``). The service runs on the card;
``--platform cpu`` is the only way onto the CPU. ``--events F`` writes
the ``pvraft_events/v1`` stream to F; ``--trace_sample N`` traces 1
request in N (16; 1: all, 0: off); ``--trace_dir`` is where
``/debug/trace`` windows go; ``--strict_retrace`` fails a dispatch that
compiles; ``--devmem_interval`` is the memory monitor's period (10 s; 0:
off). ``--cost_surface PATH`` arms the cost plane from a
``pvraft_costs/v1`` inventory (``python -m pvraft_tpu_torch.programs
costs``): it loads before the program table is captured, so a bad path
fails at once. SIGINT drains the service, writes the ``serve_shutdown``
record, closes the stream and exits 0.

    python -m pvraft_tpu_torch.serve loadgen --out LOAD.json \
        [--ckpt CKPT.msgpack] [--requests 64] [--device cpu] ...
    python -m pvraft_tpu_torch.serve loadgen --target HOST:PORT ...
    python -m pvraft_tpu_torch.serve validate-load LOAD.json ...

``loadgen`` stands the service up in the process (seeded weights, or
``--ckpt``; tracing every request) with ``serve``'s model, geometry
and batching flags and defaults, drives it over HTTP
(``serve/loadgen.py::run_load``) and writes the ``pvraft_serve_load/v1``
artifact, its event stream (``<out stem>.events.jsonl``) and its
``pvraft_trace/v1`` sibling (``<out stem>.trace.json``). With
``--target`` it drives services that already run, a fleet router among
them, and writes the load artifact alone (the events are theirs). The
service runs on the card; ``--device cpu`` puts it on the CPU.
``validate-load`` checks load artifacts and exits 1 on any problem.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

from pvraft_tpu_torch.serve.engine import (
    SERVE_DEFAULT_BATCH_SIZES,
    SERVE_DEFAULT_BUCKETS,
    SERVE_DEFAULT_DTYPE,
    SERVE_DEFAULT_ITERS,
    SERVE_DEFAULT_REPLICAS,
)


def _ints(text: str):
    return tuple(int(x) for x in text.split(",") if x.strip())


def _cmd_serve(args) -> int:
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.serve.events import ServeTelemetry
    from pvraft_tpu_torch.serve.server import build_service
    from pvraft_tpu_torch.serve.supervisor import SupervisorConfig

    cfg = ServeConfig(
        model=ModelConfig(truncate_k=args.truncate_k,
                          corr_knn=args.corr_knn, graph_k=args.graph_k),
        buckets=_ints(args.buckets), batch_sizes=_ints(args.batch_sizes),
        num_iters=args.iters, refine=args.refine, dtype=args.dtype,
        replicas=args.replicas)
    telemetry = (ServeTelemetry(args.events, cfg=cfg)
                 if args.events else None)
    # The surface loads before the capture: a bad path fails at once.
    cost_surface = None
    if args.cost_surface:
        from pvraft_tpu_torch.programs.costs import CostSurface

        cost_surface = CostSurface.load(args.cost_surface)
        print(f"[serve] cost surface armed: {args.cost_surface} "
              f"({len(cost_surface)} program records)", flush=True)
    print(f"[serve] capturing {len(cfg.buckets) * len(cfg.batch_sizes)} "
          f"predict programs per replica (buckets={cfg.buckets}, "
          f"batch_sizes={cfg.batch_sizes}, dtype={cfg.dtype}, "
          f"replicas={cfg.replicas or 'all'})...", flush=True)
    engine = InferenceEngine.from_checkpoint(args.ckpt, cfg,
                                             device=args.platform,
                                             telemetry=telemetry)
    print(f"[serve] replica pool: "
          f"{[str(r.device) for r in engine.replicas]}", flush=True)
    for rec in engine.compile_report():
        print(f"[serve]   {rec['name']}: warm-up {rec['warmup_s']}s "
              f"capture {rec['capture_s']}s", flush=True)
    supervisor_cfg = (SupervisorConfig(probe_interval_s=args.probe_interval)
                      if args.probe_interval is not None else None)
    server = build_service(engine, max_wait_ms=args.max_wait_ms,
                           queue_depth=args.queue_depth, host=args.host,
                           port=args.port, telemetry=telemetry,
                           quiet=not args.verbose,
                           trace_sample_every=args.trace_sample,
                           trace_dir=args.trace_dir,
                           strict_retrace=args.strict_retrace,
                           devmem_interval_s=args.devmem_interval,
                           supervise=not args.no_supervise,
                           supervisor_cfg=supervisor_cfg,
                           cost_surface=cost_surface)
    server.start()
    tracing = (f"1-in-{args.trace_sample}" if args.trace_sample
               else "off")
    print(f"[serve] listening on http://{server.host}:{server.port} "
          f"(/predict /healthz /metrics /debug/trace /admin/reload); "
          f"tracing {tracing}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        # A second SIGINT must not cut the drain short.
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        print("[serve] draining...", flush=True)
        server.shutdown(drain=True)
        if telemetry is not None:
            telemetry.close()
    return 0


def _bucket_point_counts(buckets, lo: int) -> List[int]:
    """Point counts at ~75% and ~95% of each bucket's span (at least
    the model's minimum): the padding and the bucket choice both run."""
    counts, prev = [], 0
    for b in buckets:
        span = b - prev
        counts.append(max(lo, prev + int(0.75 * span)))
        counts.append(max(lo, prev + int(0.95 * span)))
        prev = b
    return counts


def _summary(artifact) -> str:
    return json.dumps({
        "ok": artifact["requests"]["ok"],
        "rejected": artifact["requests"]["rejected"],
        "p50_ms": artifact["latency_ms"]["p50"],
        "p99_ms": artifact["latency_ms"]["p99"],
        "throughput_rps": artifact["throughput_rps"]})


def _drive_targets(args) -> int:
    """Drive services that already run: the geometry and the program
    report come from the first target's ``/healthz``."""
    from pvraft_tpu_torch.serve.loadgen import (SCHEMA_VERSION, _endpoints,
                                                _get_json, run_load,
                                                validate_load_artifact)

    eps = _endpoints(None, args.target)
    health = _get_json(*eps[0], "/healthz")
    counts = _bucket_point_counts(health["buckets"],
                                  int(health.get("min_points", 1)))
    measurement = run_load(None, n_requests=args.requests,
                           concurrency=args.concurrency,
                           point_counts=counts, seed=args.seed,
                           retries=args.retries, targets=args.target)
    artifact = {
        "schema": SCHEMA_VERSION,
        "config": {"targets": ["%s:%s" % e for e in eps],
                   "buckets": list(health["buckets"]),
                   "batch_sizes": list(health.get("batch_sizes", [])),
                   "requests": args.requests,
                   "concurrency": args.concurrency,
                   "point_counts": counts, "retries": args.retries},
        "compile": health.get("programs", []),
        **measurement,
    }
    problems = validate_load_artifact(artifact, path=args.out)
    if problems:
        for p in problems:
            print(f"[loadgen] SCHEMA PROBLEM: {p}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(artifact, f, indent=2)
    print(f"[loadgen] wrote {args.out}", flush=True)
    print(_summary(artifact), flush=True)
    return 0


def _cmd_loadgen(args) -> int:
    if args.target:
        return _drive_targets(args)
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.serve.events import ServeTelemetry
    from pvraft_tpu_torch.serve.loadgen import (SCHEMA_VERSION, run_load,
                                                write_load_and_trace)
    from pvraft_tpu_torch.serve.server import build_service
    from pvraft_tpu_torch.weights import seeded_state_dict

    model = ModelConfig(truncate_k=args.truncate_k, graph_k=args.graph_k,
                        corr_knn=args.corr_knn)
    cfg = ServeConfig(model=model, buckets=_ints(args.buckets),
                      batch_sizes=_ints(args.batch_sizes),
                      num_iters=args.iters, dtype=args.dtype,
                      replicas=args.replicas)
    events_path = args.events or (
        os.path.splitext(args.out)[0] + ".events.jsonl")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # One run per stream: a tail of an earlier run would lie about this one.
    if os.path.exists(events_path):
        os.unlink(events_path)
    telemetry = ServeTelemetry(events_path, cfg=cfg)
    if args.ckpt:
        engine = InferenceEngine.from_checkpoint(
            args.ckpt, cfg, device=args.device, telemetry=telemetry)
    else:
        engine = InferenceEngine(seeded_state_dict(model, args.seed), cfg,
                                 device=args.device, telemetry=telemetry)
    # Every request traced: the SLO report joins the spans by trace id.
    server = build_service(engine, max_wait_ms=args.max_wait_ms,
                           queue_depth=args.queue_depth,
                           telemetry=telemetry, trace_sample_every=1)
    server.start()
    print(f"[loadgen] serving on port {server.port} "
          f"({len(engine.replicas)} replicas, dtype {cfg.dtype}); "
          f"{args.requests} requests x {args.concurrency} clients",
          flush=True)
    counts = _bucket_point_counts(cfg.buckets, cfg.min_points)
    try:
        measurement = run_load(server, n_requests=args.requests,
                               concurrency=args.concurrency,
                               point_counts=counts, seed=args.seed,
                               retries=args.retries)
    finally:
        server.shutdown(drain=True)
        telemetry.close()
    artifact = {
        "schema": SCHEMA_VERSION,
        "config": {
            "buckets": list(cfg.buckets),
            "batch_sizes": list(cfg.batch_sizes),
            "num_iters": cfg.num_iters,
            "truncate_k": model.truncate_k,
            "graph_k": model.graph_k,
            "corr_knn": model.corr_knn,
            "compute_dtype": cfg.dtype,
            "requests": args.requests,
            "concurrency": args.concurrency,
            "max_wait_ms": args.max_wait_ms,
            "queue_depth": args.queue_depth,
            "point_counts": counts,
            "weights": args.ckpt or "seeded",
            "platform": engine.platform,
            "replicas": len(engine.replicas),
            "retries": args.retries,
        },
        "compile": engine.compile_report(),
        **measurement,
    }
    trace_path, trace_doc = write_load_and_trace(args.out, artifact,
                                                 events_path)
    print(f"[loadgen] wrote {args.out}, {events_path} and {trace_path}; "
          f"traces {trace_doc['counts']}", flush=True)
    print(_summary(artifact), flush=True)
    return 0


def _cmd_validate_load(args) -> int:
    from pvraft_tpu_torch.serve.loadgen import validate_load_artifact_file

    failed = 0
    for path in args.paths:
        problems = validate_load_artifact_file(path)
        if problems:
            failed += 1
            for p in problems:
                print(p, file=sys.stderr)
        else:
            print(f"{path}: OK")
    return 1 if failed else 0


def _add_service_flags(p: argparse.ArgumentParser) -> None:
    """The model, geometry and batching flags that ``serve`` and
    ``loadgen`` share, with the service's defaults (the flagship model,
    ``SERVE_DEFAULT_*``)."""
    p.add_argument("--buckets",
                   default=",".join(map(str, SERVE_DEFAULT_BUCKETS)),
                   help="comma-separated point-count buckets (ascending)")
    p.add_argument("--batch_sizes",
                   default=",".join(map(str, SERVE_DEFAULT_BATCH_SIZES)),
                   help="comma-separated captured batch sizes (ascending)")
    p.add_argument("--iters", type=int, default=SERVE_DEFAULT_ITERS,
                   help="GRU refinement iterations per predict")
    p.add_argument("--truncate_k", type=int, default=512)
    p.add_argument("--corr_knn", type=int, default=32)
    p.add_argument("--graph_k", type=int, default=32)
    p.add_argument("--dtype", default=SERVE_DEFAULT_DTYPE,
                   choices=["bfloat16", "float32"],
                   help="serving compute dtype (parameters stay float32)")
    p.add_argument("--replicas", type=int, default=SERVE_DEFAULT_REPLICAS,
                   help="replica pool size (0 = one per CUDA device)")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--queue_depth", type=int, default=64)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("python -m pvraft_tpu_torch.serve",
                                     allow_abbrev=False)
    sub = parser.add_subparsers(dest="cmd", required=True)

    srv = sub.add_parser("serve", help="run the inference service",
                         allow_abbrev=False)
    srv.add_argument("--ckpt", required=True,
                     help="msgpack checkpoint (the port's or the JAX "
                          "package's)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    _add_service_flags(srv)
    srv.add_argument("--refine", action="store_true",
                     help="serve a stage-2 (PVRaftRefine) checkpoint")
    srv.add_argument("--events", default="",
                     help="pvraft_events/v1 JSONL path for serve telemetry")
    srv.add_argument("--trace_sample", type=int, default=16,
                     help="trace 1-in-N requests (1 = all, 0 = off); "
                          "spans ride the --events stream")
    srv.add_argument("--trace_dir", default="",
                     help="base directory for /debug/trace profiler "
                          "windows (default: a temp dir)")
    srv.add_argument("--strict_retrace", "--strict-retrace",
                     dest="strict_retrace", action="store_true",
                     help="fail a dispatch (HTTP 500) when a graph "
                          "capture or kernel build is observed after "
                          "startup sealed the program set; without it the "
                          "retrace watchdog only emits `recompile` events "
                          "+ the pvraft_serve_recompiles_total counter")
    srv.add_argument("--devmem_interval", type=float, default=10.0,
                     help="seconds between torch.cuda.memory_stats() "
                          "samples (device_memory events + "
                          "pvraft_device_hbm_bytes gauge; 0 disables)")
    srv.add_argument("--no-supervise", dest="no_supervise",
                     action="store_true",
                     help="serve without the replica supervisor")
    srv.add_argument("--probe_interval", type=float, default=None,
                     help="supervisor probe cadence in seconds (default: "
                          "the supervisor's 0.5); also the 503 "
                          "Retry-After")
    srv.add_argument("--cost_surface", "--cost-surface",
                     dest="cost_surface", default="",
                     help="arm the cost plane from a pvraft_costs/v1 "
                          "inventory (python -m pvraft_tpu_torch.programs "
                          "costs): every dispatch priced in predicted "
                          "device-seconds and measured against the price "
                          "(Prometheus, cost_calibration events, the "
                          "/healthz cost block); empty: disarmed")
    srv.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                     help="cpu: serve on the CPU (default: the card)")
    srv.add_argument("--verbose", action="store_true",
                     help="log every HTTP request")
    srv.set_defaults(fn=_cmd_serve)

    lg = sub.add_parser("loadgen", help="drive the service over HTTP and "
                        "write a pvraft_serve_load/v1 artifact",
                        allow_abbrev=False)
    lg.add_argument("--out", required=True,
                    help="the load artifact's path (.json)")
    lg.add_argument("--events", default="",
                    help="events path (default: <out stem>.events.jsonl)")
    lg.add_argument("--ckpt", default="",
                    help="checkpoint to serve (default: seeded weights)")
    _add_service_flags(lg)
    lg.add_argument("--requests", type=int, default=64)
    lg.add_argument("--concurrency", type=int, default=8)
    lg.add_argument("--seed", type=int, default=0,
                    help="the weights' and the payloads' seed")
    lg.add_argument("--retries", type=int, default=0,
                    help="client retries of a 503 (jittered backoff that "
                         "honours Retry-After; every attempt recorded)")
    lg.add_argument("--target", action="append", default=[],
                    help="drive a running service at HOST:PORT instead "
                         "(repeatable: requests round-robin)")
    lg.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="cpu: serve on the CPU (default: the card)")
    lg.set_defaults(fn=_cmd_loadgen)

    val = sub.add_parser("validate-load",
                         help="validate pvraft_serve_load/v1 artifacts",
                         allow_abbrev=False)
    val.add_argument("paths", nargs="+")
    val.set_defaults(fn=_cmd_validate_load)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
