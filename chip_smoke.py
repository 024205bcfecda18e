#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pvraft_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed S]

Run from the root of a checkout on a machine with one NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA. It builds the port's
CUDA kernels from ``pvraft_tpu_torch/csrc`` and then:

  phase 0  prints the card (``nvidia-smi`` name and power limit), the
           torch and CUDA versions and the kernel build time; turns TF32
           off for matmuls and convolutions;
  phase 1  holds each kernel against its plain PyTorch version on the
           card at the serve path's shapes (B=1 and B=4 at N=8192, B=4 at
           N=4096, B=1 at N=2048; K=512, knn=32, width 64): identical kNN
           indices, atol 1e-5, two launches bitwise equal; times kernel,
           plain version and, where there is one, the library call with
           CUDA events (median of 25 after warm-up);
  phase 2  serves the flagship ModelConfig (8 GRU iterations, buckets
           2048/4096/8192) with seeded random weights: one 8,192-point
           request, a batch of 4 requests of 3,000-4,096 points, one
           2,048-point request; once with fused_gru=False and once with
           fused_gru=True, counting kernel launches; the same requests
           through the plain versions (use_pallas=False) bound the flow
           difference (see ``serve_phase``).

Each phase prints one JSON line. Then the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line; so does a machine without CUDA, or a directory without the port.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# CUDA-core FLOP/s. The bound of a kernel is the larger of its bytes over
# the memory rate and its operations over the compute rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

LOOKUP_SHAPES = ((1, 8192), (4, 8192), (4, 4096), (1, 2048))
K, KNN, LEVELS, BASE_SCALE, RESOLUTION = 512, 32, 3, 0.25, 3
WIDTH = 64
REPS = 25
MAIN_SHAPE = (1, 8192)       # the shape the kernels line reports
FLOW_BOUND_1 = 1e-4          # kernels vs plain versions, 1 iteration
FLOW_BOUND = 1e-3            # kernels vs plain versions, 8 iterations (median)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 1 --


def lookup_inputs(rng, b, n, dev):
    """Candidates around the query coords with continuous offsets (no
    exact distance ties), spread over all three voxel levels."""
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = coords[:, :, None, :] + rng.normal(0, 0.6, (b, n, K, 3)).astype(np.float32)
    corr = rng.normal(size=(b, n, K)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (corr, xyz, coords))


def check_lookup(rng, b, n, dev):
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup_plain, fused_corr_lookup)

    args = (*lookup_inputs(rng, b, n, dev), LEVELS, BASE_SCALE, RESOLUTION, KNN)
    got = fused_corr_lookup(*args)
    again = fused_corr_lookup(*args)
    want = corr_lookup_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[3], want[3]),
          f"lookup {b}x{n}: kNN indices differ from the plain version")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    check(err <= 1e-5, f"lookup {b}x{n}: max |err| {err} > 1e-5")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"lookup {b}x{n}: two launches are not bitwise equal")
    check(bool((got[0] != 0).float().mean() > 0.05),
          f"lookup {b}x{n}: the voxel cells are empty")
    vox_n = LEVELS * RESOLUTION**3
    bytes_ = 4 * b * n * (K + 3 * K + 3) + 4 * b * n * (vox_n + 5 * KNN)
    # Per candidate: 3 offsets, 5 for the distance, per level 3 divisions,
    # 3 roundings and 3 range tests; KNN argmin comparisons.
    ops = b * n * K * (3 + 5 + 9 * LEVELS + KNN)
    return {
        "shape": [b, n, K], "max_abs_err": err, "bitwise_repeat": True,
        "ms": cuda_ms(lambda: fused_corr_lookup(*args)),
        "plain_ms": cuda_ms(lambda: corr_lookup_plain(*args)),
        "library_ms": None,
        "bytes": bytes_, "ops": ops,
        **bound(bytes_, ops),
    }


def bound(bytes_: float, ops: float):
    t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gru_inputs(rng, b, n, dev):
    from pvraft_tpu_torch.ops.cuda.gru_iter import pack_gru_weights, pad_flow

    h = WIDTH

    def a(*s, scale=0.15):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    me = (a(h, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(3 * h, h), a(h), a(3 * h, h), a(h), a(3 * h, h), a(h))
    weights = pack_gru_weights(me, gru, h, h)
    net = torch.tanh(a(b, n, h, scale=1.0))
    inp = torch.relu(a(b, n, h, scale=1.0))
    cor = a(b, n, h, scale=1.0)
    flow = a(b, n, 3, scale=0.3)
    return me, gru, (net, inp, cor, pad_flow(flow).contiguous(), weights), flow


def check_gru(rng, b, n, dev):
    from pvraft_tpu_torch.models.update import ConvGRU, MotionEncoder
    from pvraft_tpu_torch.ops.cuda.gru_iter import fused_gru_update, gru_math

    me, gru, args, flow = gru_inputs(rng, b, n, dev)
    got = fused_gru_update(*args)
    again = fused_gru_update(*args)
    want = gru_math(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"gru {b}x{n}: max |err| {err} > 1e-5")
    check(torch.equal(got, again), f"gru {b}x{n}: launches not bitwise equal")
    # The library yardstick: the unfused MotionEncoder + ConvGRU modules on
    # the same weights (the port never calls them on the kernel path).
    menc, cgru = MotionEncoder(WIDTH).to(dev), ConvGRU(WIDTH, 2 * WIDTH).to(dev)
    with torch.no_grad():
        for layer, (w, bias) in zip(
                (menc.conv_corr, menc.conv_flow, menc.conv,
                 cgru.convz, cgru.convr, cgru.convq),
                zip((*me, *gru)[0::2], (*me, *gru)[1::2])):
            layer.weight.copy_(w.t())
            layer.bias.copy_(bias)
    net, inp, cor = args[:3]

    def unfused():
        return cgru(net, torch.cat([inp, menc(flow, cor)], dim=-1))

    with torch.inference_mode():
        lib_err = float((unfused() - want).abs().max())
    check(lib_err <= 1e-5, f"gru {b}x{n}: unfused modules differ by {lib_err}")
    weight_bytes = sum(4 * w.numel() for w in args[4])
    bytes_ = 4 * b * n * (3 * WIDTH + 8 + WIDTH) + weight_bytes
    flops = 2 * 51200 * b * n
    with torch.inference_mode():
        lib_ms = cuda_ms(unfused)
    return {
        "shape": [b, n, WIDTH], "max_abs_err": err, "bitwise_repeat": True,
        "ms": cuda_ms(lambda: fused_gru_update(*args)),
        "plain_ms": cuda_ms(lambda: gru_math(*args)),
        "library_ms": lib_ms,
        "bytes": bytes_, "ops": flops,
        **bound(bytes_, flops),
    }


# --------------------------------------------------------------- phase 2 --


def scene(rng, n1, n2):
    """A request: pc1 in a 4 m box, pc2 = a rigid motion of pc1 plus
    noise, resampled to n2 points."""
    pc1 = rng.uniform(-2, 2, (n1, 3)).astype(np.float32)
    angle = 0.05
    rot = np.array([[np.cos(angle), -np.sin(angle), 0],
                    [np.sin(angle), np.cos(angle), 0], [0, 0, 1]], np.float32)
    moved = pc1 @ rot.T + np.array([0.1, -0.05, 0.02], np.float32)
    idx = rng.choice(n1, n2, replace=n2 > n1)
    pc2 = moved[idx] + rng.normal(0, 0.01, (n2, 3)).astype(np.float32)
    return pc1, pc2.astype(np.float32)


def serve_requests(rng):
    batch = [scene(rng, int(rng.integers(3000, 4097)),
                   int(rng.integers(3000, 4097))) for _ in range(4)]
    return [("predict", [scene(rng, 8192, 8192)], 8192),
            ("predict_batch", batch, 4096),
            ("predict", [scene(rng, 2048, 2048)], 2048)]


def drive(engine, requests):
    """Serve every request group; returns the flows and per-group times
    (host clock around the synchronous call, and CUDA events)."""
    flows, times = [], []
    for kind, group, bucket in requests:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        if kind == "predict":
            out = [engine.predict(*group[0])]
        else:
            out = engine.predict_batch(group, engine.validate_request(*group[0]))
        end.record()
        end.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        for (pc1, _), f in zip(group, out):
            check(f.shape == (pc1.shape[0], 3), f"flow shape {f.shape}")
            check(bool(np.isfinite(f).all()), "non-finite flow")
        flows.append(out)
        times.append({"call": kind, "bucket": bucket, "requests": len(group),
                      "host_ms": host_ms, "device_ms": start.elapsed_time(end)})
    return flows, times


def point_diffs(a, b) -> np.ndarray:
    """Per real point, max |flow a - flow b| over xyz, all requests."""
    return np.concatenate([np.abs(x - y).max(axis=-1)
                           for ga, gb in zip(a, b) for x, y in zip(ga, gb)])


def serve_phase(seed, dev):
    """Serve the requests with the kernels (fused_gru off, then on) and
    with the plain versions. After one iteration every discrete choice
    (voxel cell, kNN selection) sees bitwise-equal inputs on all passes,
    so the flows differ by sum order only: max |dflow| <= FLOW_BOUND_1.
    Over 8 iterations that noise moves a few candidates across a voxel
    cell boundary or the kNN cut, and with random weights the change
    spreads to other points through the GroupNorm statistics and the
    graph: the median is held to FLOW_BOUND, the tail is reported."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.ops.cuda.corr_lookup import fused_corr_lookup
    from pvraft_tpu_torch.ops.cuda.gru_iter import fused_gru_update
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    requests = serve_requests(np.random.default_rng(seed + 1))
    iters = ServeConfig().num_iters
    results, flows, flows1, launches = {}, {}, {}, {}
    for name, kw in (("unfused_gru", {"fused_gru": False}),
                     ("fused_gru", {"fused_gru": True}),
                     ("plain", {"use_pallas": False})):
        one = InferenceEngine(state, ServeConfig(ModelConfig(**kw),
                                                 num_iters=1), device=dev)
        flows1[name], _ = drive(one, requests)
        del one
        engine = InferenceEngine(state, ServeConfig(ModelConfig(**kw)),
                                 device=dev)
        drive(engine, requests)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_corr_lookup.launches = 0
        fused_gru_update.launches = 0
        flows[name], times = drive(engine, requests)
        launches[name] = {"fused_corr_lookup": fused_corr_lookup.launches,
                          "fused_gru_update": fused_gru_update.launches}
        results[name] = {"requests": times, "launches": launches[name],
                         "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        del engine
    n_batches = len(requests)
    check(launches["unfused_gru"] == {"fused_corr_lookup": iters * n_batches,
                                      "fused_gru_update": 0},
          f"unfused pass launches {launches['unfused_gru']}")
    check(launches["fused_gru"] == {"fused_corr_lookup": iters * n_batches,
                                    "fused_gru_update": iters * n_batches},
          f"fused pass launches {launches['fused_gru']}")
    check(launches["plain"] == {"fused_corr_lookup": 0, "fused_gru_update": 0},
          f"plain pass launches {launches['plain']}")
    cmp = {}
    for a, b in (("unfused_gru", "plain"), ("fused_gru", "plain"),
                 ("fused_gru", "unfused_gru")):
        d1 = point_diffs(flows1[a], flows1[b])
        d8 = point_diffs(flows[a], flows[b])
        cmp[f"{a}_vs_{b}"] = {
            "iters1_max": float(d1.max()), "iters8_max": float(d8.max()),
            "iters8_median": float(np.median(d8)),
            "iters8_p99": float(np.percentile(d8, 99)),
            "iters8_points_over_bound": int((d8 > FLOW_BOUND).sum()),
            "points": int(d8.size)}
        check(d1.max() <= FLOW_BOUND_1,
              f"serve {a} vs {b}, 1 iteration: max |dflow| {d1.max()}")
        check(np.median(d8) <= FLOW_BOUND,
              f"serve {a} vs {b}, 8 iterations: median |dflow| "
              f"{np.median(d8)}")
    results["flow_diff"] = cmp
    results["flow_bounds"] = {"iters1_max": FLOW_BOUND_1,
                              "iters8_median": FLOW_BOUND}
    results["max_abs_flow"] = max(float(np.abs(f).max())
                                  for g in flows["fused_gru"] for f in g)
    return results, launches["fused_gru"]


# ------------------------------------------------------------------ main --


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pvraft_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = kernels.build_all()
    for name in libs:
        kernels.library(name)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in libs.items():
        with open(f"{path}.log", encoding="utf-8", errors="replace") as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "setup", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kernel_build_s": build_s, "ptxas": ptxas,
          "tf32_matmul": False, "tf32_cudnn": False})

    rng = np.random.default_rng(args.seed)
    lookup = {f"{b}x{n}": check_lookup(rng, b, n, dev) for b, n in LOOKUP_SHAPES}
    gru = {f"{b}x{n}": check_gru(rng, b, n, dev) for b, n in LOOKUP_SHAPES}
    emit({"phase": "kernels", "fused_corr_lookup": lookup,
          "fused_gru_update": gru})

    serve, launches = serve_phase(args.seed, dev)
    emit({"phase": "serve", **serve})

    main_key = f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}"
    rows = []
    for name, source, replaces, res in (
            ("fused_corr_lookup", "pvraft_tpu_torch/csrc/corr_lookup.cu",
             "pvraft_tpu/ops/pallas/corr_lookup.py:109", lookup),
            ("fused_gru_update", "pvraft_tpu_torch/csrc/gru_iter.cu",
             "pvraft_tpu/ops/pallas/gru_iter.py:129", gru)):
        r = res[main_key]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in res.values()),
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
