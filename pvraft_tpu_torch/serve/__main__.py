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
off). ``--cost_surface`` is refused by name (the cost plane arrives with
ROADMAP queue 1 item 9c), and so is the ``validate-load`` subcommand,
which needs the load generator. SIGINT drains the service, writes the
``serve_shutdown`` record, closes the stream and exits 0.
"""

from __future__ import annotations

import argparse
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

# JAX serve flags whose feature a later slice of the port brings: parsed
# with default None, refused when given.
LATER_FLAGS = ("cost_surface",)


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
                           supervisor_cfg=supervisor_cfg)
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


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser("python -m pvraft_tpu_torch.serve",
                                     allow_abbrev=False)
    sub = parser.add_subparsers(dest="cmd", required=True)
    if argv and argv[0] == "validate-load":
        parser.error("validate-load is not ported yet: it needs the load "
                     "generator (serve/loadgen.py), which comes later")

    srv = sub.add_parser("serve", help="run the inference service",
                         allow_abbrev=False)
    srv.add_argument("--ckpt", required=True,
                     help="msgpack checkpoint (the port's or the JAX "
                          "package's)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    srv.add_argument("--buckets",
                     default=",".join(map(str, SERVE_DEFAULT_BUCKETS)),
                     help="comma-separated point-count buckets (ascending)")
    srv.add_argument("--batch_sizes",
                     default=",".join(map(str, SERVE_DEFAULT_BATCH_SIZES)),
                     help="comma-separated captured batch sizes "
                          "(ascending)")
    srv.add_argument("--iters", type=int, default=SERVE_DEFAULT_ITERS,
                     help="GRU refinement iterations per predict")
    srv.add_argument("--truncate_k", type=int, default=512)
    srv.add_argument("--corr_knn", type=int, default=32)
    srv.add_argument("--graph_k", type=int, default=32)
    srv.add_argument("--refine", action="store_true",
                     help="serve a stage-2 (PVRaftRefine) checkpoint")
    srv.add_argument("--dtype", default=SERVE_DEFAULT_DTYPE,
                     choices=["bfloat16", "float32"],
                     help="serving compute dtype (parameters stay "
                          "float32)")
    srv.add_argument("--replicas", type=int, default=SERVE_DEFAULT_REPLICAS,
                     help="replica pool size (0 = one per CUDA device)")
    srv.add_argument("--max_wait_ms", type=float, default=5.0)
    srv.add_argument("--queue_depth", type=int, default=64)
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
                     dest="cost_surface", default=None,
                     help="not ported yet (ROADMAP queue 1 item 9c)")
    srv.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                     help="cpu: serve on the CPU (default: the card)")
    srv.add_argument("--verbose", action="store_true",
                     help="log every HTTP request")
    srv.set_defaults(fn=_cmd_serve)
    args = parser.parse_args(argv)
    for name in LATER_FLAGS:
        if getattr(args, name) is not None:
            parser.error(f"--{name} is not ported yet: it arrives with the "
                         f"cost plane (ROADMAP queue 1 item 9c)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
