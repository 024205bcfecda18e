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
           card at the serve and train paths' shapes (B=1, 2 and 4 at
           N=8192, B=4 at N=4096, B=1 at N=2048; K=512, knn=32, width
           64): identical kNN indices, atol 1e-5, two launches bitwise
           equal; the same for the lookup and the voxel kernel at
           1 x 8192 on the cases of ``EDGE_CASES`` (exact distance ties,
           offsets at exactly +-0.5 r and +-1.5 r, K=40 with knn 8,
           base_scale 0.3) and for the lookup on the model's own inputs
           (``model_lookup_inputs``), and the GRU kernel on the cases of
           ``GRU_CASES`` (point counts off its 64-point tile, activations
           x10 that saturate sigmoid and tanh, atol 1e-4 there); times
           kernel, plain version and, where there is one, the library
           call by device time (25 calls replayed as one CUDA graph,
           ``device_ms``), and the kernel also around one call with the
           wrapper's host work (``call_ms``); times the lookup without
           its kNN branch, without its voxel branch and with neither
           (``lookup_split``);
           holds each autograd Function's gradient (kernel
           forward, hand-written backward) against autograd through the
           plain version, atol 1e-5, at B=2 x 8192 and B=4 x 4096; then
           runs the kernel bench (``python -m
           pvraft_tpu_torch.kernel_bench``), the path through which the
           port runs the voxel kernel's forward, counting its launches;
  phase 2  serves the flagship ModelConfig (8 GRU iterations, buckets
           2048/4096/8192) with seeded random weights: one 8,192-point
           request, a batch of 4 requests of 3,000-4,096 points, one
           2,048-point request; once with fused_gru=False and once with
           fused_gru=True; the same requests through the plain versions
           (use_pallas=False) bound the flow difference (see
           ``serve_phase``); each engine replays the programs it captured
           at construction (no wrapper may launch eagerly);
  phase 3  trains the flagship model at full width (B=2 x 8,192 points,
           8 iterations, Adam) on seeded FT3D-like synthetic scenes with
           the kernels (fused_gru off and on) and the plain versions:
           gradients of 1 and 8 iterations against the plain versions,
           every leaf's gradient finite and non-zero, 20 Adam steps that
           must lower the loss, train and eval step times and peak memory
           (see ``train_phase``); the Trainer runs its graphed steps,
           captured at construction;
  phase 4  the captured paths (``graphs``): the flagship serve table
           captured at engine construction (``compile_report``: capture
           seconds and pool bytes per program), phase 2's requests
           replayed against the eager forward on the same padded inputs
           (bitwise, else the first differing submodule,
           ``serve/aot.py::first_difference``, and phase 2's bar),
           replayed and eager latency per group; 20 graphed train steps
           against 20 eager ones on the same capturable Adam under
           ``deterministic()`` from the same weights and batches
           (per-step losses and final parameters bitwise, else
           ``GRAD_BOUNDS``; the loss must fall); the 32-iteration eval
           step graphed against eager; train and eval step times against
           the eager trainer's (plain Adam), peak memory and the
           programs' pools (see ``graph_serve``, ``graph_train``);
  phase 5  the launches of the main paths (``launches_phase``): each
           serve group of phases 2 and 4, one train step and one eval step
           of every way of phase 3, each pass alone under
           ``torch.profiler`` with the counts zeroed just before it.

Launch counts: a wrapper counts its eager launches where it launches
its kernel; a replayed graph runs no wrapper, so every count on a
captured path is measured: phase 5 counts the card's kernels by their
device symbols (``ops/cuda.measured_launches``), and the launches each
program's capture recorded are the cross-check. Phase 5 runs last: a
profiler session leaves the process's eager launches slower, so it would
tilt the eager-against-graphed times of phases 2-4.

Each phase prints one JSON line. Then the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line; so does a machine without CUDA, or a directory without the port.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from pvraft_tpu_torch.kernel_bench import device_ms

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# CUDA-core FLOP/s and dense TF32 tensor-core FLOP/s. The bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the compute rate of the units it runs on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

LOOKUP_SHAPES = ((1, 8192), (2, 8192), (4, 8192), (4, 4096), (1, 2048))
TRAIN_SHAPE = (2, 8192)      # B x N of the train step and the kernel bench
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


def zero_counts():
    from pvraft_tpu_torch.ops import cuda as kernels

    kernels.zero_launch_counts()


def read_counts():
    """Each wrapper's eager launches since ``zero_counts``."""
    from pvraft_tpu_torch.ops import cuda as kernels

    return kernels.launch_counts()


def measured(fn):
    """Zero the counts and run ``fn()`` under the profiler; returns its
    result, the kernels of each wrapper that the card ran (replays of
    captured graphs included) and each wrapper's eager launches."""
    from pvraft_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    zero_counts()
    out, counts = kernels.measured_launches(fn)
    return out, counts, read_counts()


def memory_state():
    """The allocator's state: bytes allocated and reserved, and how often
    it had to free its cache and retry a cudaMalloc (a host stall)."""
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "alloc_retries": torch.cuda.memory_stats().get(
                "num_alloc_retries", 0)}


NO_LAUNCHES = {"fused_corr_lookup": 0, "fused_gru_update": 0,
               "voxel_bin_means_pallas": 0}


def captured_share(report, want):
    """Whether every program's capture recorded ``want`` per replay (the
    cross-check of a measured count)."""
    share = {k: v for k, v in want.items() if v}
    return all(r["launches"] == share for r in report)


# --------------------------------------------------------------- phase 1 --


def lookup_inputs(rng, b, n, dev):
    """Candidates around the query coords with continuous offsets (no
    exact distance ties), spread over all three voxel levels."""
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = coords[:, :, None, :] + rng.normal(0, 0.6, (b, n, K, 3)).astype(np.float32)
    corr = rng.normal(size=(b, n, K)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (corr, xyz, coords))


def lookup_case(name, args):
    """Holds the lookup kernel against its plain version on ``args``
    (corr, xyz, coords, levels, base_scale, resolution, knn): identical
    kNN indices, max |err| <= 1e-5, two launches bitwise equal; times
    both."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup_plain, fused_corr_lookup)

    got = fused_corr_lookup(*args)
    again = fused_corr_lookup(*args)
    want = corr_lookup_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[3], want[3]),
          f"lookup {name}: kNN indices differ from the plain version")
    err = max([float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])
               if g.numel()], default=0.0)
    check(err <= 1e-5, f"lookup {name}: max |err| {err} > 1e-5")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"lookup {name}: two launches are not bitwise equal")
    filled = float((got[0] != 0).float().mean()) if got[0].numel() else 0.0
    corr, _, _, levels, _, _, knn = args
    b, n, k = corr.shape
    vox_n = levels * RESOLUTION**3
    bytes_ = 4 * b * n * (k + 3 * k + 3) + 4 * b * n * (vox_n + 5 * knn)
    # Per candidate: 3 offsets, 5 for the distance, per level 3 divisions,
    # 3 roundings and 3 range tests; knn comparisons.
    ops = b * n * k * (3 + 5 + 9 * levels + knn)
    return {
        "shape": [b, n, k], "knn": knn, "levels": levels,
        "base_scale": args[4], "max_abs_err": err, "bitwise_repeat": True,
        "filled_cells": filled,
        "ms": device_ms(lambda: fused_corr_lookup(*args)),
        "call_ms": cuda_ms(lambda: fused_corr_lookup(*args)),
        "plain_ms": device_ms(lambda: corr_lookup_plain(*args)),
        "library_ms": None,
        "bytes": bytes_, "ops": ops,
        **bound(bytes_, ops),
    }


def check_lookup(rng, b, n, dev):
    args = (*lookup_inputs(rng, b, n, dev), LEVELS, BASE_SCALE, RESOLUTION, KNN)
    out = lookup_case(f"{b}x{n}", args)
    check(out["filled_cells"] > 0.05, f"lookup {b}x{n}: the voxel cells are empty")
    return out


def edge_inputs(rng, kind, b, n, k, dev):
    """Inputs the selection and the binning must survive, each exactly
    representable so that rel = xyz - coords is what was meant:
    ``ties``, every offset four times (twice as itself, once negated,
    once with its axes permuted: bitwise-equal distances, so the kNN cut
    falls inside groups of equal distances); ``boundaries``, offsets of
    m * r/2 on every axis, m in -3..3, r the edge of a random level, so
    that candidates sit at exactly +-0.5 r and +-1.5 r (half to even:
    cell 0 and out of range) and at the cell centres; ``random``, the
    phase's continuous offsets."""
    coords = (rng.integers(-64, 65, (b, n, 3)) / 64).astype(np.float32)
    if kind == "ties":
        base = np.round(rng.normal(0, 0.6, (b, n, -(-k // 4), 3)) * 256) / 256
        off = np.concatenate([base, base, -base, base[..., ::-1]], axis=2)
        off = off[:, :, rng.permutation(off.shape[2])[:k]]
    elif kind == "boundaries":
        lvl = rng.integers(0, LEVELS, (b, n, k, 1))
        off = rng.integers(-3, 4, (b, n, k, 3)) * (BASE_SCALE / 2) * 2.0**lvl
    else:
        off = rng.normal(0, 0.6, (b, n, k, 3))
    xyz = (coords[:, :, None, :] + off).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (corr, xyz, coords))


# name: (inputs, K, knn, base_scale), at 1 x 8192
EDGE_CASES = {"ties": ("ties", K, KNN, BASE_SCALE),
              "boundaries": ("boundaries", K, KNN, BASE_SCALE),
              "k40_knn8": ("random", 40, 8, BASE_SCALE),
              "scale0.3": ("random", K, KNN, 0.3),
              "boundaries_scale0.3": ("boundaries", K, KNN, 0.3)}


def model_lookup_inputs(seed, dev):
    """The lookup's inputs inside the model: the seeded flagship PVRaft's
    ``corr_init`` state on phase 2's 8,192-point scene, coords = pc1 (the
    first iteration)."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.ops.corr import corr_init
    from pvraft_tpu_torch.weights import seeded_state_dict

    cfg = ModelConfig()
    model = PVRaft(cfg).to(dev)
    model.load_state_dict(seeded_state_dict(cfg, seed))
    pc1, pc2 = serve_requests(np.random.default_rng(seed + 1))[0][1][0]
    x1, x2 = (torch.from_numpy(p)[None].to(dev) for p in (pc1, pc2))
    with torch.no_grad():
        f1, _ = model.feature_extractor(x1)
        f2, _ = model.feature_extractor(x2)
        state = corr_init(f1, f2, x2, cfg.truncate_k)
    del model
    return state.corr.contiguous(), state.xyz.contiguous(), x1.contiguous()


def lookup_split(inputs):
    """The lookup kernel's time as it is, without the kNN branch, without
    the voxel branch, and with neither (the loads alone)."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import fused_corr_lookup

    out = {}
    for name, levels, knn in (("full", LEVELS, KNN), ("no_knn", LEVELS, 0),
                              ("no_voxel", 0, KNN), ("loads_only", 0, 0)):
        args = (*inputs, levels, BASE_SCALE, RESOLUTION, knn)
        out[name] = device_ms(lambda: fused_corr_lookup(*args))
    return out


def bound(bytes_: float, ops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time for ``bytes_`` moved and ``ops`` done at
    ``flops_per_s``, and which of the two sets it."""
    t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / flops_per_s
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gru_inputs(rng, b, n, dev, scale=1.0):
    """Seeded GRU operands: weights 0.15 N(0,1); net = tanh, inp = relu and
    cor of ``scale`` N(0,1); flow 0.3 ``scale`` N(0,1)."""
    from pvraft_tpu_torch.ops.cuda.gru_iter import pack_gru_weights, pad_flow

    h = WIDTH

    def a(*s, scale=0.15):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    me = (a(h, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(3 * h, h), a(h), a(3 * h, h), a(h), a(3 * h, h), a(h))
    weights = pack_gru_weights(me, gru, h, h)
    net = torch.tanh(a(b, n, h, scale=scale))
    inp = torch.relu(a(b, n, h, scale=scale))
    cor = a(b, n, h, scale=scale)
    flow = a(b, n, 3, scale=0.3 * scale)
    return me, gru, (net, inp, cor, pad_flow(flow).contiguous(), weights), flow


# name: (B, N, activation scale, atol). Point counts off the kernel's
# 64-point tile, and activations x10 that saturate sigmoid and tanh: there
# fp32 gru_math itself is ~1e-5 from fp64 (tests/test_torch_gru_split.py),
# so that case holds 1e-4.
GRU_CASES = {"ragged_2x2056": (2, 2056, 1.0, 1e-5),
             "ragged_1x8191": (1, 8191, 1.0, 1e-5),
             "saturating_1x8192": (1, 8192, 10.0, 1e-4)}


def check_gru(rng, b, n, dev, scale=1.0, tol=1e-5):
    """Holds the GRU kernel against ``gru_math``: max |err| <= ``tol``, two
    launches bitwise equal; the unfused modules (the library yardstick)
    against it too; times all three. The bound is the 3xTF32 one (three
    tensor-core products per fp32 product), beside the fp32 CUDA-core
    bound of the same work (``fp32_bound_ms``)."""
    from pvraft_tpu_torch.models.update import ConvGRU, MotionEncoder
    from pvraft_tpu_torch.ops.cuda.gru_iter import fused_gru_update, gru_math

    me, gru, args, flow = gru_inputs(rng, b, n, dev, scale)
    got = fused_gru_update(*args)
    again = fused_gru_update(*args)
    want = gru_math(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= tol, f"gru {b}x{n} scale {scale}: max |err| {err} > {tol}")
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
        with torch.no_grad():
            return cgru(net, torch.cat([inp, menc(flow, cor)], dim=-1))

    lib_err = float((unfused() - want).abs().max())
    check(lib_err <= tol, f"gru {b}x{n}: unfused modules differ by {lib_err}")
    weight_bytes = sum(4 * w.numel() for w in args[4])
    bytes_ = 4 * b * n * (3 * WIDTH + 8 + WIDTH) + weight_bytes
    flops = 2 * 51200 * b * n
    return {
        "shape": [b, n, WIDTH], "activation_scale": scale,
        "max_abs_err": err, "atol": tol, "bitwise_repeat": True,
        "ms": device_ms(lambda: fused_gru_update(*args)),
        "call_ms": cuda_ms(lambda: fused_gru_update(*args)),
        "plain_ms": device_ms(lambda: gru_math(*args)),
        "library_ms": device_ms(unfused),
        "bytes": bytes_, "ops": flops,
        **bound(bytes_, 3 * flops, TF32_FLOPS_PER_S),
        "fp32_bound_ms": bound(bytes_, flops)["bound_ms"],
    }


def voxel_case(name, corr, xyz, coords, scale):
    """Holds the voxel kernel against ``voxel_bin_means`` on rel = xyz -
    coords: max |err| <= 1e-5, two launches bitwise equal; times both."""
    from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas
    from pvraft_tpu_torch.ops.voxel import voxel_bin_means

    rel = (xyz - coords[:, :, None, :]).contiguous()
    args = (corr, rel, LEVELS, scale, RESOLUTION)
    got = voxel_bin_means_pallas(*args)
    again = voxel_bin_means_pallas(*args)
    want = voxel_bin_means(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"voxel {name}: max |err| {err} > 1e-5")
    check(torch.equal(got, again), f"voxel {name}: launches not bitwise equal")
    filled = float((got != 0).float().mean())
    b, n, k = corr.shape
    vox_n = LEVELS * RESOLUTION**3
    bytes_ = 4 * b * n * (k + 3 * k) + 4 * b * n * vox_n
    # Per candidate and level: 3 divisions, 3 roundings, 3 range tests.
    ops = b * n * k * 9 * LEVELS
    return {
        "shape": [b, n, k], "base_scale": scale, "max_abs_err": err,
        "bitwise_repeat": True, "filled_cells": filled,
        "ms": device_ms(lambda: voxel_bin_means_pallas(*args)),
        "call_ms": cuda_ms(lambda: voxel_bin_means_pallas(*args)),
        "plain_ms": device_ms(lambda: voxel_bin_means(*args)),
        "library_ms": None,
        "bytes": bytes_, "ops": ops,
        **bound(bytes_, ops),
    }


def check_voxel(rng, b, n, dev):
    out = voxel_case(f"{b}x{n}", *lookup_inputs(rng, b, n, dev), BASE_SCALE)
    check(out["filled_cells"] > 0.05, f"voxel {b}x{n}: the voxel cells are empty")
    return out


def grad_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def check_backward(rng, b, n, dev):
    """Each Function's gradient (kernel forward, hand-written backward)
    against autograd through its plain version on the same inputs and
    the same random output cotangents, atol 1e-5."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup_plain, fused_corr_lookup)
    from pvraft_tpu_torch.ops.cuda.gru_iter import (
        fused_gru_update, gru_math, pack_gru_weights)
    from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas
    from pvraft_tpu_torch.ops.voxel import voxel_bin_means

    def grads(fn, leaves, make_args, cots):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        outs = fn(*make_args(xs))
        outs = outs if isinstance(outs, tuple) else (outs,)
        total = sum((o * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(total, xs)

    def cot(t):
        return torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
            np.float32)).to(dev)

    corr, xyz, coords = lookup_inputs(rng, b, n, dev)
    geo = (LEVELS, BASE_SCALE, RESOLUTION)
    out = {}
    lk = corr_lookup_plain(corr, xyz, coords, *geo, KNN)
    cots = [cot(t) for t in lk[:3]]
    got, want = (grads(f, [corr], lambda xs: (xs[0], xyz, coords, *geo, KNN),
                       cots) for f in (fused_corr_lookup, corr_lookup_plain))
    out["fused_corr_lookup"] = grad_err(got, want)
    rel = (xyz - coords[:, :, None, :]).contiguous()
    cots = [cot(voxel_bin_means(corr, rel, *geo))]
    got, want = (grads(f, [corr], lambda xs: (xs[0], rel, *geo), cots)
                 for f in (voxel_bin_means_pallas, voxel_bin_means))
    out["voxel_bin_means_pallas"] = grad_err(got, want)
    me, gru, args, _ = gru_inputs(rng, b, n, dev)
    raw = [*args[:4], *me, *gru]

    def gru_args(xs):
        return (*xs[:4], pack_gru_weights(xs[4:10], xs[10:16], WIDTH, WIDTH))

    cots = [cot(args[0])]
    got, want = (grads(f, raw, gru_args, cots)
                 for f in (fused_gru_update, gru_math))
    out["fused_gru_update"] = grad_err(got, want)
    torch.cuda.synchronize()
    for name, err in out.items():
        check(err <= 1e-5, f"{name} backward {b}x{n}: max |err| {err} > 1e-5")
    return out


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


SERVE_WAYS = (("unfused_gru", {"fused_gru": False}),
              ("fused_gru", {"fused_gru": True}),
              ("plain", {"use_pallas": False}))


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
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    requests = serve_requests(np.random.default_rng(seed + 1))
    iters = ServeConfig().num_iters
    results, flows, flows1 = {}, {}, {}
    for name, kw in SERVE_WAYS:
        one = InferenceEngine(state, ServeConfig(ModelConfig(**kw),
                                                 num_iters=1), device=dev)
        flows1[name], _ = drive(one, requests)
        del one
        engine = InferenceEngine(state, ServeConfig(ModelConfig(**kw)),
                                 device=dev)
        drive(engine, requests)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        flows[name], times = drive(engine, requests)
        eager = read_counts()
        results[name] = {"requests": times, "eager_wrapper_launches": eager,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        # A replay runs no wrapper: its launches are measured in phase 5.
        check(eager == NO_LAUNCHES and captured_share(
                  engine.compile_report(), want_serve(name, iters, 1)),
              f"serve {name}: a wrapper launched eagerly ({eager}) or a "
              f"capture recorded other launches: {engine.compile_report()}")
        del engine
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
    return results


def want_serve(name, iters, calls=1):
    """The kernel launches of ``calls`` serve calls (or steps) of ``iters``
    GRU iterations each, one way (``SERVE_WAYS``, ``TRAIN_WAYS``)."""
    n = iters * calls
    lookup, gru = {"unfused_gru": (n, 0), "fused_gru": (n, n),
                   "plain": (0, 0)}[name]
    return {**NO_LAUNCHES, "fused_corr_lookup": lookup,
            "fused_gru_update": gru}


# --------------------------------------------------------------- phase 3 --

TRAIN_WAYS = (("unfused_gru", {"fused_gru": False}),
              ("fused_gru", {"fused_gru": True}),
              ("plain", {"use_pallas": False}))
TRAIN_STEPS = 20             # Adam steps of the training run (4 scenes, bs 2)
TIMED_STEPS = 6              # timed train steps per way, after 2 warm-up
# Gradient bars, kernels vs plain versions on the same weights and batch.
# The leaves are sums over 16,384 points x 32 edges that cancel, so ~1e-7
# of summation-order noise in the forward reaches ~1e-3 relative on the
# worst leaf. Measured on the H100 (PERF.md section 6): the plain path
# against itself, PyTorch's default backward, worst leaf rel 6.9e-4 to
# 2.0e-3 at 1 iteration and cosine 0.9982-0.9993 at 8; kernels vs plain
# 2.1e-3 and 0.9983. Bars of 1e-3 (1 iteration) and 0.999 (8) sit inside
# that noise, so these sit about 5x beyond the kernels' measured worst
# leaf; a real fault (a missing or misrouted gradient) misses them by
# orders of magnitude.
GRAD_BOUNDS = {"iters1": {"loss_rel": 1e-5, "min_cos": 0.9999,
                          "max_rel": 1e-2},
               "iters8": {"loss_rel": 1e-3, "min_cos": 0.99}}


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (sorted scatter-add and gather
    backward instead of float atomics) for a gradient comparison: then
    only the kernels' own summation order differs between two paths."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def loss_and_grads(model, batch, iters):
    from pvraft_tpu_torch.engine.steps import sequence_loss_of

    model.zero_grad(set_to_none=True)
    loss, _ = sequence_loss_of(model, batch, 0.8, iters)
    loss.backward()
    return loss.item(), {n: None if p.grad is None else p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def grad_agreement(got, want):
    """Loss relative difference, and per leaf the cosine and the relative
    error ||g_k - g_p|| / ||g_p|| (both 0-norm: agree); the worst leaves."""
    (lk, gk), (lp, gp) = got, want
    cos, rel = {}, {}
    for n, p in gp.items():
        k = gk[n]
        if k is None or p is None:
            cos[n], rel[n] = -1.0, float("inf")
            continue
        k, p = k.double(), p.double()
        kn, pn = float(k.norm()), float(p.norm())
        if kn == 0.0 and pn == 0.0:
            cos[n], rel[n] = 1.0, 0.0
        else:
            cos[n] = float((k * p).sum()) / (kn * pn) if kn * pn else 0.0
            rel[n] = float((k - p).norm()) / pn if pn else float("inf")
    worst_cos = min(cos, key=cos.get)
    worst_rel = max(rel, key=rel.get)
    return {"loss_kernels": lk, "loss_plain": lp,
            "loss_rel": abs(lk - lp) / abs(lp),
            "min_cos": cos[worst_cos], "min_cos_leaf": worst_cos,
            "max_rel": rel[worst_rel], "max_rel_leaf": worst_rel}


def train_phase(seed, dev):
    """Trains the flagship model at full width three ways on the same
    seeded weights and batch: kernels with fused_gru off and on, and the
    plain versions. Holds gradients of 1 and 8 iterations against the
    plain versions, every leaf's gradient finite and non-zero, the
    launches per train step, and that 20 Adam steps lower the loss;
    times train and eval steps."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import batches, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    grads, results = {}, {}
    for name, kw in TRAIN_WAYS:
        memory = memory_state()
        trainer = Trainer(flagship_train_config(seed, **kw), device=dev, weights=state)
        batch = to_device(next(batches(trainer.train_ds, 2)), dev)
        with deterministic():
            grads[name] = {it: loss_and_grads(trainer.model, batch, it)
                           for it in (1, 8)}
        if name == "plain":
            # The plain path against itself with PyTorch's default
            # (atomic, unordered) backward: the run-to-run floor.
            floor = {f"iters{it}": grad_agreement(
                loss_and_grads(trainer.model, batch, it),
                loss_and_grads(trainer.model, batch, it)) for it in (1, 8)}
        torch.cuda.synchronize()
        zero_counts()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        eager = read_counts()
        check(eager == NO_LAUNCHES and captured_share(
                  trainer.compile_report()[:1],
                  want_serve(name, trainer.cfg.train.iters)),
              f"train {name}: a wrapper launched eagerly in a graphed step "
              f"({eager}) or the capture recorded other launches: "
              f"{trainer.compile_report()}")
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: trainer.train_step(batch),
                          reps=TIMED_STEPS, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        scene = to_device(next(batches(trainer.val_ds, 1)), dev)
        eval_ms = cuda_ms(lambda: trainer.eval_step(scene), reps=3, warmup=1)
        results[name] = {"train_step_ms": step_ms, "eval_step_ms": eval_ms,
                         "eval_iters": trainer.cfg.train.eval_iters,
                         "peak_mem_bytes": peak, "memory_before": memory}
        del trainer, batch, scene
        torch.cuda.empty_cache()
    parity = {}
    for name in ("unfused_gru", "fused_gru"):
        _, g8 = grads[name][8]
        bad = [n for n, g in g8.items()
               if g is None or not bool(torch.isfinite(g).all())
               or float(g.abs().max()) == 0.0]
        check(not bad, f"train {name}: leaves without a finite non-zero "
                       f"gradient: {bad[:5]} ({len(bad)} of {len(g8)})")
        one = grad_agreement(grads[name][1], grads["plain"][1])
        eight = grad_agreement(grads[name][8], grads["plain"][8])
        parity[name] = {"iters1": one, "iters8": eight,
                        "leaves": len(g8)}
        for key, got in (("iters1", one), ("iters8", eight)):
            bar = GRAD_BOUNDS[key]
            check(got["loss_rel"] <= bar["loss_rel"]
                  and got["min_cos"] >= bar["min_cos"]
                  and got["max_rel"] <= bar.get("max_rel", float("inf")),
                  f"train {name} vs plain, {key}: {got} (bars {bar})")

    # Training works: the kernels path (fused_gru off, the JAX default)
    # through the Trainer's own epoch loop, 4 scenes, bs 2.
    trainer = Trainer(flagship_train_config(seed, epochs=TRAIN_STEPS // 2),
                      device=dev, weights=state)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(trainer.cfg.train.num_epochs):
        losses += trainer.training(epoch)["losses"]
    train_s = time.perf_counter() - t0
    val = trainer.val_test(trainer.cfg.train.num_epochs - 1, "val")
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} train steps")
    check(all(np.isfinite(losses)), "non-finite training loss")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"training: mean loss of the last 5 steps {last} "
                        f"is not below the first 5 {first}")
    check(all(np.isfinite(v) for v in val.values()), f"val metrics {val}")
    del trainer
    torch.cuda.empty_cache()
    return {"ways": results, "grad_parity": parity,
            "grad_parity_mode": "torch.use_deterministic_algorithms(True)",
            "plain_vs_plain_default_mode": floor,
            "bounds": GRAD_BOUNDS,
            "training": {"steps": TRAIN_STEPS, "losses": losses,
                         "first5_mean": first, "last5_mean": last,
                         "wall_s": train_s, "val": val}}


# --------------------------------------------------------------- phase 4 --

GRAPH_REPS = 5               # timed calls per serve group and path


def graph_serve(seed, dev):
    """The flagship serve table captured at construction; phase 2's
    requests replayed and held against the eager forward (``engine.model``)
    on the same padded inputs: bitwise, else the first submodule that
    differs and phase 2's 8-iteration median bar. Replayed and eager
    latency per group (host clock around the call, median of
    GRAPH_REPS)."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.profile_serve import eager_predict_batch
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.serve.aot import first_difference
    from pvraft_tpu_torch.weights import seeded_state_dict

    cfg = ServeConfig()
    state = seeded_state_dict(cfg.model, seed)
    requests = serve_requests(np.random.default_rng(seed + 1))
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine = InferenceEngine(state, cfg, device=dev)
    table_s = time.perf_counter() - t0
    report = engine.compile_report()
    check(len(report) == len(cfg.buckets) * len(cfg.batch_sizes)
          and all(r["graph"] for r in report),
          f"serve table: not every program was captured: {report}")
    want = want_serve("unfused_gru", cfg.num_iters, 1)
    check(captured_share(report, want),
          f"serve table: captures recorded other launches: {report}")
    groups, memory = [], {"before": memory_state()}
    for kind, group, bucket in requests:
        padded = engine.padded_batch(group, bucket)
        program = engine.program(bucket, padded[0].shape[0])
        zero_counts()
        got = engine.predict_batch(group, bucket)
        check(read_counts() == NO_LAUNCHES,
              f"graphs serve {kind} {bucket}: a wrapper launched eagerly "
              f"in a replay: {read_counts()}")
        replay_flow = program.outputs[0].clone()
        inputs = [torch.from_numpy(a).to(dev) for a in padded]
        with torch.no_grad():
            flows, _ = engine.model(inputs[0], inputs[1], cfg.num_iters,
                                    *inputs[2:])
        bitwise = torch.equal(replay_flow, flows[-1])
        entry = {"call": kind, "bucket": bucket, "requests": len(group),
                 "program": program.name, "bitwise": bitwise}
        if not bitwise:
            eager = eager_predict_batch(engine, group, bucket)
            d = point_diffs([got], [eager])
            entry["differs_first_at"] = first_difference(
                engine.model, lambda x1, x2, v1, v2: engine.model(
                    x1, x2, cfg.num_iters, v1, v2), inputs, dev)
            entry["iters8_max"] = float(d.max())
            entry["iters8_median"] = float(np.median(d))
            check(np.median(d) <= FLOW_BOUND,
                  f"graphs serve {kind} {bucket}: replay vs eager median "
                  f"|dflow| {np.median(d)} ({entry['differs_first_at']})")
        for path, run in (("replay_ms", engine.predict_batch),
                          ("eager_ms", lambda g, b: eager_predict_batch(
                              engine, g, b))):
            times = []
            for _ in range(GRAPH_REPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run(group, bucket)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t1))
            entry[path] = statistics.median(times)
        groups.append(entry)
    out = {"table_s": table_s, "programs": report,
           "pool_reserved_bytes": torch.cuda.memory_reserved() - reserved,
           "groups": groups, "memory": {**memory, "after": memory_state()}}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def param_agreement(got, want, start):
    """Parameters after training, as their change from ``start``: the
    worst leaf's cosine and relative error (grad_agreement's measures)."""
    cos, rel = {}, {}
    for n in want:
        a, b = (got[n] - start[n]).double(), (want[n] - start[n]).double()
        na, nb = float(a.norm()), float(b.norm())
        cos[n] = (float((a * b).sum()) / (na * nb) if na * nb
                  else float(na == nb))
        rel[n] = float((a - b).norm()) / nb if nb else float(na != 0.0)
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    return {"min_cos": cos[worst_cos], "min_cos_leaf": worst_cos,
            "max_rel": rel[worst_rel], "max_rel_leaf": worst_rel}


def graph_train(seed, dev):
    """The flagship train step captured as one graph (forward, loss,
    backward, capturable Adam with a device lr) against the eager step on
    the same Adam: under ``deterministic()``, TRAIN_STEPS steps each from
    the same weights and batches, per-step losses and the final
    parameters bitwise, else held to GRAD_BOUNDS; the loss must fall.
    Then, in the default mode, the graphed trainer against the eager one
    (``Trainer(graphs=False)``: plain Adam, a float lr): the 32-iteration
    eval step on one scene (bitwise, else phase 2's bar), train and eval
    step times, peak memory and the programs' pools."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import batches, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    start = {n: t.to(dev) for n, t in state.items()}
    cfg = flagship_train_config(seed, epochs=TRAIN_STEPS // 2)
    runs = {}
    with deterministic():
        for path in ("graphed", "eager"):
            trainer = Trainer(cfg, device=dev, weights=state,
                              graphs=path == "graphed", capturable=True)
            zero_counts()
            losses, step_ms = [], []
            for epoch in range(cfg.train.num_epochs):
                out = trainer.training(epoch)
                losses += out["losses"]
                step_ms.append(out["step_ms"])
            counts = read_counts()
            runs[path] = {"losses": losses, "launches": counts,
                          "epoch_step_ms": step_ms,
                          "params": {n: p.detach().clone() for n, p in
                                     trainer.model.named_parameters()}}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    g, e = runs["graphed"], runs["eager"]
    check(len(g["losses"]) == TRAIN_STEPS and all(np.isfinite(g["losses"])),
          f"graphs train: losses {g['losses']}")
    want = {"fused_corr_lookup": cfg.train.iters * TRAIN_STEPS,
            "fused_gru_update": 0, "voxel_bin_means_pallas": 0}
    # Wrapper counts: the eager steps launch every kernel through the
    # wrapper, the graphed steps none (their launches: phase 5).
    check(g["launches"] == NO_LAUNCHES and e["launches"] == want,
          f"graphs train: eager wrapper launches {g['launches']} (graphed) "
          f"/ {e['launches']} (eager), expected none / {want}")
    bitwise = g["losses"] == e["losses"] and all(
        torch.equal(g["params"][n], e["params"][n]) for n in g["params"])
    result = {"steps": TRAIN_STEPS, "bitwise": bitwise,
              "graphed_losses": g["losses"], "eager_losses": e["losses"],
              "deterministic_epoch_step_ms": {
                  "graphed": g["epoch_step_ms"], "eager": e["epoch_step_ms"]}}
    if not bitwise:
        first = next((i for i, (a, b) in enumerate(zip(g["losses"],
                                                       e["losses"]))
                      if a != b), None)
        agree = param_agreement(g["params"], e["params"], start)
        worst_loss = max(abs(a - b) / abs(b)
                         for a, b in zip(g["losses"], e["losses"]))
        result.update({"first_differing_step": first,
                       "worst_loss_rel": worst_loss, "params": agree})
        bar = GRAD_BOUNDS["iters8"]
        check(worst_loss <= bar["loss_rel"]
              and agree["min_cos"] >= bar["min_cos"],
              f"graphs train: graphed vs eager {result} (bars {bar})")
    first5, last5 = np.mean(g["losses"][:5]), np.mean(g["losses"][-5:])
    check(last5 < first5,
          f"graphs train: loss {first5} -> {last5} did not fall")
    result["first5_mean"], result["last5_mean"] = float(first5), float(last5)

    timed = {}
    for path in ("graphed", "eager"):
        torch.cuda.synchronize()
        memory = {"before": memory_state()}
        reserved = memory["before"]["reserved"]
        t0 = time.perf_counter()
        trainer = Trainer(flagship_train_config(seed), device=dev,
                          weights=state, graphs=path == "graphed")
        setup_s = time.perf_counter() - t0
        scene = to_device(next(batches(trainer.val_ds, 1)), dev)
        zero_counts()
        metrics, flow = trainer.eval_step(scene)
        eval_launches = read_counts()
        metrics = {k: v.clone() for k, v in metrics.items()}
        flow = flow.clone()
        eval_ms = cuda_ms(lambda: trainer.eval_step(scene), reps=3, warmup=1)
        batch = to_device(next(batches(trainer.train_ds, 2)), dev)
        for _ in range(2):
            trainer.train_step(batch)
        zero_counts()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_launches = read_counts()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: trainer.train_step(batch),
                          reps=TIMED_STEPS, warmup=0)
        timed[path] = {"setup_s": setup_s, "train_step_ms": step_ms,
                       "eval_step_ms": eval_ms,
                       "eager_wrapper_launches": {
                           "train_step": step_launches,
                           "eval_step": eval_launches},
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "reserved_growth_bytes":
                           torch.cuda.memory_reserved() - reserved,
                       "programs": trainer.compile_report(),
                       "memory": {**memory, "after": memory_state()},
                       "metrics": {k: v.tolist() for k, v in metrics.items()},
                       "flow": flow}
        del trainer, batch, scene
        gc.collect()
        torch.cuda.empty_cache()
    eval_want = {**NO_LAUNCHES, "fused_corr_lookup": cfg.train.eval_iters}
    want_step = {**NO_LAUNCHES, "fused_corr_lookup": cfg.train.iters}
    check(timed["eager"]["eager_wrapper_launches"] == {
              "train_step": want_step, "eval_step": eval_want}
          and timed["graphed"]["eager_wrapper_launches"] == {
              "train_step": NO_LAUNCHES, "eval_step": NO_LAUNCHES}
          and captured_share(timed["graphed"]["programs"][:1], want_step)
          and captured_share(timed["graphed"]["programs"][1:], eval_want),
          f"graphs train: wrapper launches "
          f"{ {p: t['eager_wrapper_launches'] for p, t in timed.items()} }, "
          f"captures {timed['graphed']['programs']}")
    gf, ef = timed["graphed"].pop("flow"), timed["eager"].pop("flow")
    eval_bitwise = torch.equal(gf, ef) and \
        timed["graphed"]["metrics"] == timed["eager"]["metrics"]
    result["eval"] = {"iters": cfg.train.eval_iters, "bitwise": eval_bitwise,
                      "max_abs_flow_diff": float((gf - ef).abs().max())}
    if not eval_bitwise:
        d = (gf - ef).abs().amax(dim=-1).flatten().cpu().numpy()
        check(np.median(d) <= FLOW_BOUND,
              f"graphs eval: median |dflow| {np.median(d)} > {FLOW_BOUND}")
    check(len(timed["graphed"]["programs"]) == 2
          and all(p["graph"] for p in timed["graphed"]["programs"]),
          f"graphs train: programs {timed['graphed']['programs']}")
    result["timed"] = timed
    return result


# --------------------------------------------------------------- phase 5 --


def launches_phase(seed, dev):
    """The main paths driven once more, each pass alone under the
    profiler with the counts zeroed just before it and read just after:
    each serve group of phase 2's requests through ``predict`` or
    ``predict_batch`` of a freshly captured engine, and one train step and
    one eval step of a freshly captured ``Trainer``, every way of phases 2
    and 3. The kernels the card ran are counted by their device symbols
    (``measured``): what the replays launched, which no wrapper sees.
    Each pass must launch what its capture recorded and no wrapper may
    launch eagerly. This phase runs last: after a profiler session the
    process's eager launches run slower (CUPTI stays attached), which
    would tilt every eager-against-graphed time; the eager train step is
    timed once more here to show it."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import batches, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    requests = serve_requests(np.random.default_rng(seed + 1))
    serve = {}
    for name, kw in SERVE_WAYS:
        cfg = ServeConfig(ModelConfig(**kw))
        engine = InferenceEngine(state, cfg, device=dev)
        total = dict(NO_LAUNCHES)
        for request in requests:
            _, counts, wrapper = measured(lambda: drive(engine, [request]))
            want = want_serve(name, cfg.num_iters)
            check(counts == want and wrapper == NO_LAUNCHES,
                  f"launches: serve {name} {request[0]} {request[2]}: the "
                  f"card ran {counts} (wrappers {wrapper}), expected {want}")
            total = {k: total[k] + counts[k] for k in total}
        serve[name] = total
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    train = {}
    for name, kw in TRAIN_WAYS:
        trainer = Trainer(flagship_train_config(seed, **kw), device=dev,
                          weights=state)
        batch = to_device(next(batches(trainer.train_ds, 2)), dev)
        scene = to_device(next(batches(trainer.val_ds, 1)), dev)
        t = trainer.cfg.train
        got = {}
        for step, run, iters in (
                ("train_step", lambda: trainer.train_step(batch), t.iters),
                ("eval_step", lambda: trainer.eval_step(scene),
                 t.eval_iters)):
            _, counts, wrapper = measured(run)
            want = want_serve(name, iters)
            check(counts == want and wrapper == NO_LAUNCHES,
                  f"launches: {step} {name}: the card ran {counts} "
                  f"(wrappers {wrapper}), expected {want}")
            got[step] = counts
        train[name] = got
        del trainer, batch, scene
        gc.collect()
        torch.cuda.empty_cache()
    trainer = Trainer(flagship_train_config(seed), device=dev, weights=state,
                      graphs=False)
    batch = to_device(next(batches(trainer.train_ds, 2)), dev)
    for _ in range(2):
        trainer.train_step(batch)
    after_ms = cuda_ms(lambda: trainer.train_step(batch),
                       reps=TIMED_STEPS, warmup=0)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve": serve, "train": train,
            "eager_train_step_ms_after_profiler": after_ms}


def bench_phase(dev):
    """The kernel bench (``python -m pvraft_tpu_torch.kernel_bench``), the
    path through which the port runs kernel 3's forward, at its defaults
    (2 x 8192 points, K=512), with the launches of that run."""
    from pvraft_tpu_torch.kernel_bench import bench

    zero_counts()
    rows = bench(points=8192, k=512, batch=2, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["voxel_bin_means_pallas"] > 0,
          "kernel bench: the voxel kernel was not launched")
    return {"rows": rows, "launches": counts}


# ------------------------------------------------------------------ main --


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace; phase 3 compares
    # gradients under torch.use_deterministic_algorithms.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from pvraft_tpu_torch.ops import cuda as kernels
    from pvraft_tpu_torch.profile_serve import nvidia_smi

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
    gru_rng = np.random.default_rng(args.seed + 11)
    gru_edges = {name: check_gru(gru_rng, b, n, dev, scale, tol)
                 for name, (b, n, scale, tol) in GRU_CASES.items()}
    voxel = {f"{b}x{n}": check_voxel(rng, b, n, dev) for b, n in LOOKUP_SHAPES}
    edge_rng = np.random.default_rng(args.seed + 7)
    lookup_edges, voxel_edges = {}, {}
    for name, (kind, k, knn, scale) in EDGE_CASES.items():
        corr, xyz, coords = edge_inputs(edge_rng, kind, *MAIN_SHAPE, k, dev)
        lookup_edges[name] = lookup_case(
            name, (corr, xyz, coords, LEVELS, scale, RESOLUTION, knn))
        voxel_edges[name] = voxel_case(name, corr, xyz, coords, scale)
    model_in = model_lookup_inputs(args.seed, dev)
    lookup_model = lookup_case(
        "model_inputs", (*model_in, LEVELS, BASE_SCALE, RESOLUTION, KNN))
    split = {"synthetic": lookup_split(lookup_inputs(
                 np.random.default_rng(args.seed), *MAIN_SHAPE, dev)),
             "model_inputs": lookup_split(model_in)}
    del model_in
    backward = {f"{b}x{n}": check_backward(rng, b, n, dev)
                for b, n in (TRAIN_SHAPE, (4, 4096))}
    emit({"phase": "kernels", "fused_corr_lookup": lookup,
          "fused_corr_lookup_cases": {**lookup_edges,
                                      "model_inputs": lookup_model},
          "fused_corr_lookup_split_ms": split,
          "fused_gru_update": gru, "fused_gru_update_cases": gru_edges,
          "voxel_bin_means_pallas": voxel,
          "voxel_bin_means_pallas_cases": voxel_edges,
          "backward_max_abs_err": backward})
    kbench = bench_phase(dev)
    emit({"phase": "kernel_bench", **kbench})

    serve = serve_phase(args.seed, dev)
    emit({"phase": "serve", **serve})

    train = train_phase(args.seed, dev)
    emit({"phase": "train", **train})

    graphs = {"serve": graph_serve(args.seed, dev),
              "train": graph_train(args.seed, dev)}
    emit({"phase": "graphs", **graphs})

    launches = launches_phase(args.seed, dev)
    emit({"phase": "launches", **launches})
    steps = launches["train"]["fused_gru"]

    main_key = f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}"
    rows = []
    extra = {"fused_corr_lookup": {"model_inputs_ms": lookup_model["ms"],
                                   "split_ms": split["synthetic"]},
             "fused_gru_update": {
                 "fp32_bound_ms": gru[main_key]["fp32_bound_ms"]}}
    for name, source, replaces, res, runs in (
            ("fused_corr_lookup", "pvraft_tpu_torch/csrc/corr_lookup.cu",
             "pvraft_tpu/ops/pallas/corr_lookup.py:109",
             {**lookup, **lookup_edges, "model_inputs": lookup_model},
             launches["serve"]["fused_gru"]),
            ("fused_gru_update", "pvraft_tpu_torch/csrc/gru_iter.cu",
             "pvraft_tpu/ops/pallas/gru_iter.py:129", {**gru, **gru_edges},
             launches["serve"]["fused_gru"]),
            ("voxel_bin_means_pallas", "pvraft_tpu_torch/csrc/voxel_corr.cu",
             "pvraft_tpu/ops/pallas/voxel_corr.py:114",
             {**voxel, **voxel_edges}, kbench["launches"])):
        r = res[main_key]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs[name],
            "train_launches_per_step": steps["train_step"][name],
            "eval_launches_per_step": steps["eval_step"][name],
            **extra.get(name, {}),
            "max_abs_err": max(v["max_abs_err"] for v in res.values()),
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
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
