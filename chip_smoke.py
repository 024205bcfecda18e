#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pvraft_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed S] [--phase refine|seq_parallel|static_checks ...]

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
           (``lookup_split``), and the general lookup the same way at
           phase 6's shape (``general_lookup_split``);
           holds each autograd Function's gradient (kernel
           forward, hand-written backward) against autograd through the
           plain version, atol 1e-5, at B=2 x 8192 and B=4 x 4096; holds
           the general kernels (``corr_lookup_general``,
           ``gru_iter_general``) against the plain versions at 1 x 8192
           at shapes the tuned kernels do not take (``GENERAL_LOOKUPS``:
           K 1024 / knn 64 / r 3, K 510 / knn 48 / r 2, K 512 / knn 32 /
           r 5 with 4 levels; GRU widths (hidden / context /
           correlation) 32, 96, 128, hidden 32 / context 96 as phase 6
           runs it, 96 / 32, 48 / 80 and 33 / 50 / 37:
           ``GENERAL_GRU_WIDTHS``) at the same bars,
           timing them the same way (the general lookup's rows also give
           its launch plan and the warps per SM the occupancy calculator
           gives it; the general GRU's rows its plan's mode and, on the
           tensor cores, the 3xTF32 bound beside the fp32 CUDA-core one),
           and the Functions' gradients there
           at atol 1e-4 (``check_general_backward``); then
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
  phase 5  the slice's checkpoints at full width (``checkpoints``,
           ``checkpoint_phase``): ``fit`` for 2 epochs of the flagship
           model, graphed, under ``deterministic()``; a second Trainer
           resumed from the epoch-0 checkpoint runs epoch 1 bitwise like
           the uninterrupted run (losses, validation, parameters, Adam
           state); the Evaluator (32 iterations, one scene per step) on
           ``best_checkpoint`` gives ``fit``'s test means bitwise;
           ``InferenceEngine.from_checkpoint`` answers a request bitwise
           like the eager forward; ``python -m pvraft_tpu_torch.export``
           writes ``best_checkpoint`` under the reference's key names and
           ``load_torch_checkpoint`` reads it back bitwise
           (``export_phase``); the checkpoint's bytes,
           save and load seconds, the evaluator's ms per scene;
  phase 8  real data from disk (``real_data``, ``real_data_phase``; run
           after phase 5, before the profiler phases): an FT3D tree (16
           train scenes, two below 8,192 rows, 4 val), a KITTI tree of
           all 200 scenes with ground and far rows, and a full-frame FT3D
           tree (13 raw 540 x 960 frames through the port's preprocessor,
           ~380-490k rows a scene), written from the seed
           (``write_trees``); each loader path (native, 8 threads,
           serial) alone on the host, ms per batch and scenes per second,
           on both FT3D trees; the flagship model trained one epoch of
           graphed steps fed by each path on both trees and by synthetic
           scenes (ms per step beside phase 3's
           synthetic graphed step, losses finite); the threaded and serial
           epochs bitwise equal under ``deterministic()``; the Evaluator
           (32 iterations) on FT3D's test split and the 142 KITTI scenes
           from the trained checkpoint, and ``python -m
           pvraft_tpu_torch.test --dataset KITTI`` in a subprocess giving
           the Evaluator's means; one fed epoch and the FT3D evaluation
           under the profiler, the card running what the captures
           recorded;
  phase 9  stage 2 (``refine``, ``refine_phase``; run after phase 8,
           before the profiler phases): the canonical refine run's
           configuration (B=2 x 8,192, 32 iterations, Adam over the head)
           on seeded synthetic scenes; a stage-1 msgpack checkpoint
           imported into the backbone (``load_stage1_weights``), ten
           graphed refine steps that must lower the loss and leave the
           backbone bitwise unchanged, step and eval times and peak
           memory; head gradients and refined flows, kernels against
           plain versions (1 iteration: ``GRAD_BOUNDS``, FLOW_BOUND_1; 32:
           the median against the deterministic plain flow within
           FLOOR_FACTOR x the median of FLOOR_RUNS float-atomic plain
           runs against it, pooled); one step graphed against eager, a
           2-epoch
           ``fit`` resumed from epoch 0 and the refine Evaluator against
           ``fit``'s test means, all bitwise; ``ServeConfig(refine=True)``
           from the checkpoint, replays against eager bitwise, request
           times;
  phase 10 bfloat16 (``bf16``, ``bf16_phase``; run after phase 9, before
           the profiler phases): the bf16 GRU kernel
           (``csrc/gru_iter_bf16.cu``) against ``gru_math`` at bf16 at 1 x
           8192 at the flagship's and phase 1's general widths and at
           hidden 33 / context 50 / correlation 37, and at
           width 64 at every shape of phase 1 (1 x 8192, 2 x 8192,
           4 x 8192, 4 x 4096, 1 x 2048: those of the bf16 serve groups
           and train steps) (BF16_OP_TOL, see there), with kernel, plain
           and library (the unfused bf16 modules) device times and the
           bound by bytes or bf16 tensor-core operations; the flagship
           serve table at the
           ``ServeConfig`` default dtype (bfloat16), graphed, fused_gru
           off and on, phase 2's requests replayed against the eager
           forward bitwise, and bf16 against float32 engines on the same
           weights at 1 and 8 iterations (mean and relative EPE; the
           relative bound 0.15 held at 1); a bf16 refine request and the
           bf16 eval step graphed against eager bitwise; 10 graphed bf16
           train steps (B=2 x 8,192, fused_gru, ``grad_dtype`` bfloat16)
           that must lower the loss, one step graphed against eager
           bitwise under ``deterministic()``, step and eval times, peak
           memory;
  phase 11 the serving tier (``serving_tier``, ``serving_tier_phase``;
           after phase 10, before the profiler phases): the flagship
           ``ServeConfig()`` (bfloat16, one replica per card) from a
           msgpack checkpoint behind ``build_service``: phase 2's requests
           over HTTP in JSON and msgpack, bitwise against the engine's
           direct calls, HTTP latency per group against the direct call,
           the queue wait and batch fill of four concurrent clients; a
           ``POST /admin/reload`` while a client sends requests (every
           answer the old or the new weights' flow bitwise, the program
           table unchanged, the next answer the new checkpoint's eager
           forward bitwise, 409 for another structure); a FaultPlan that
           quarantines replica 0 (503 with Retry-After) and the probe's
           revival once it clears; ``/metrics`` JSON against Prometheus;
           ``python -m pvraft_tpu_torch.serve serve`` in a subprocess,
           drained by SIGINT;
  phase 12 the K-step train graph and the model levers
           (``train_levers``, ``train_levers_phase``; after phase 11,
           before the profiler phases): the flagship model at B=2 x 8,192
           packed (``ParallelConfig(packed_state=True)``), one epoch of 18
           synthetic scenes (9 steps: two calls of the 4-step graph and
           one tail step) against 9 replays of the packed single step,
           per-step losses and EPEs and the flat state bitwise under
           ``deterministic()``; the programs' capture seconds and pools
           (K = 1 and K = 4), the launches the K-step capture recorded;
           ``host_roundtrip`` bitwise against the packed step over 4
           steps, both timed in turns; one eager train step per remat
           policy (none, full, dots, dots_no_batch, save_corr): gradients
           against "none" (bitwise, else ``GRAD_BOUNDS``), peak memory,
           ms, the lookup's launches (16 where the backward recomputes
           it); "full" graphed against eager, bitwise; one eager train
           step at 2 x 16,384 dense and with corr_chunk / graph_chunk
           4096 and remat "full" (peak memory, ms, losses within 1e-4
           relative; a dense step that does not fit is recorded); a
           1-iteration forward at 1 x 8,192 with chunks of 2048 against
           the dense one (max |dflow| <= 1e-4); last, one 4-step
           call under the profiler with fused_gru off and on: kernel 1
           (and 2) 32 times;
  phase 13 serve observability (``serve_observability``,
           ``serve_observability_phase``; after phase 12, before the
           profiler phases): the flagship ``ServeConfig()`` (bf16) behind
           ``build_service`` with a ``ServeTelemetry`` stream, every
           request traced, the memory monitor at 0.5 s and
           ``strict_retrace``: phase 2's requests over HTTP bitwise
           against direct calls, each a complete seven-stage span tree
           (median ms per stage and group); the stream validated
           (``obs/events.py``), the four Prometheus families (stage
           counts, the HBM gauge against the last sample,
           ``pvraft_serve_recompiles_total`` 0 through serving and a
           ``POST /admin/reload``); the tracing cost (1-in-1 against off,
           alternated; a client thread and a client process) and a bare
           ``record_function``'s; ``compile_trip``
           under strict (500, the replica healthy) and not (200); a second
           engine and service under ``PVRAFT_CHECKS=1`` (every serving
           lock an ``OrderedLock``, four clients bitwise); the CLI with
           ``--events --trace_sample 1 --strict_retrace`` drained by
           SIGINT; last, a ``/debug/trace`` window while a client sends
           8,192-point requests (kernel 1's launches and the
           ``device_execute`` ranges in the Chrome trace, 409 for a second
           window);
  phase 14 train observability (``train_observability``,
           ``train_observability_phase``; after phase 13, before the
           profiler phases): the flagship ``TrainConfig`` (B = 2 x 8,192,
           8 iterations, fp32, graphed, ``strict_retrace``) on synthetic
           scenes. A ``telemetry`` Trainer with ``profile_dir`` trains an
           epoch and validates: the ``train.events.jsonl`` stream
           validated, every leaf in every ``step`` event, 8
           ``delta_flow_norm`` entries, ``nonfinite`` 0, no
           ``recompile``, one ``device_memory`` sample, the TensorBoard
           tags, kernel 1 eight times a step in the Chrome trace, and the
           first step's grad_norm, param_norm and update_ratio against
           the plain eager step's (bar: 10 x the plain step's own spread,
           at least 1e-4); its next epoch with the flows scaled up trips
           ``zscore``; a NaN point at 8,192 points under
           ``halt_on_divergence`` trips ``nonfinite`` at its step, writes
           a snapshot, flushes the step events and raises, and ``python -m
           pvraft_tpu_torch.doctor`` on the card names ``batch``; a
           default Trainer afterwards trains, and its step's kernels are
           held against phase 7's (in ``main``) and the telemetry step's;
           the step profiler
           (``profiling/step_profiler.py``) at the flagship, its
           ``gru_fused`` rung launching kernel 2;
  phase 15 the cost plane and the program inventory (``cost_plane``,
           ``cost_plane_phase``; after phase 14, before the profiler
           phases): every program of the catalog (``python -m
           pvraft_tpu_torch.programs list``) counted on the card at the
           flagship size into the ``pvraft_costs/v1`` inventory
           (``programs/costs.py``; every record ok, validator and
           coverage clean, each kernel spec's bytes its analytic bytes and
           PERF.md's Bound column), a serve spec and the train step
           counted on the CPU and the card alike (Adam's capturable ops
           named); ``ServeConfig()`` behind ``build_service`` with the
           inventory as its cost surface: phase 2's requests over HTTP,
           one valid ``cost_calibration`` per dispatch, the ``/healthz``
           ``cost`` rows counting the dispatches, the seven cost families,
           the measured/predicted ratio per (bucket, batch, dtype); two
           flagship Trainer steps with the surface (the ``epoch_summary``
           ``cost`` block, comparable false); the bitwise replay harness
           (``analysis/determinism/replay.py``) at the flagship size;
  phase 16 data parallelism (``parallel``, ``parallel_phase``; after
           phase 15, before the profiler phases), each leg a process of
           this script (``--leg``) so that no process group outlives it:
           (a) the flagship graphed Trainer in an NCCL group of one rank
           against no group: captured under ``deterministic()``, 3 steps
           bitwise, then one NCCL reduction kernel and 8 kernel-1
           launches in a replayed step (profiler), and a fused_gru step
           (8 kernel-2 launches beside the reduction); (b) two gloo ranks on the card, eager,
           per-device batch 2, against one process at batch 4 (step-1
           loss and gradients) and against their twin in one process
           (under deterministic(): 3 steps' losses, step-1 gradients and
           parameters bitwise), the ranks bitwise equal, ms a step, peak
           GB per rank;
           (c) the graphed Evaluator at ``eval_batch`` 4 against 1
           (per-scene EPE within 1e-5 at 1 iteration; recorded at 32);
  phase 17 sequence parallelism (``seq_parallel``, ``seq_parallel_phase``;
           after phase 16): two gloo ranks on the card as one seq group
           (a 1 x 2 mesh, ``seq_shard``), each a process of this script
           (``--leg seq``) holding 4,096 rows of each cloud of the
           flagship per-device batch 2 x 8,192, against this process's
           one-rank model on the same weights and batch: (a) the ring
           kNN graphs against the dense ones (flips named, near-ties and
           rare), then, the reference on the ranks' graphs, the forward
           at 1 and 8 iterations, the truncations' flips named, near-ties
           and rare, every point no flip reaches within 5e-4 / 1e-3 at
           1 iteration, the 8-iteration flows within 10x the model's own
           one-ulp floor; (b) a step at 1 iteration (loss within 1e-6,
           gradients under ``GRAD_BOUNDS["iters1"]``), then 3 eager
           train steps on one batch under ``deterministic()``: step 1
           under ``GRAD_BOUNDS["iters8"]``, the loss falling, 8 kernel-1
           launches a step per rank in a profiler window
           (``device_kernels``), ms a step, peak GB and the collectives
           a step per rank; (c) the eager
           Evaluator at 1 iteration, per-scene EPE within 1e-5 of one
           process; (d) stage 2 on the same group: each rank's eager
           refine Trainer (``PVRaftRefine(cfg, mesh)``, fused_gru, the
           same backbone weights, a head of its own seed) on the same
           batch against this process's one-rank refine model on the
           ranks' graphs: the refined flow at 1 iteration (the ranks'
           truncation too) with every point within 5e-4 / 1e-3, at 8
           within 10x the refine model's one-ulp floor; a refine step at
           1 iteration (loss within 1e-6, head gradients under
           ``GRAD_BOUNDS["iters1"]``, every backbone gradient None);
           kernels 1 and 2 launched 8 times a step per rank, ms a
           step, peak GB and the collectives a step; the refine
           Evaluator at 1 iteration within 1e-5 a scene;
  phase 18 the load tools and the fleet tier (``load_fleet``,
           ``load_fleet_phase``; after phase 17) at ``load_fleet_cfg()``
           (the flagship ModelConfig with fused_gru, fp32, buckets
           2048/8192, batch 1): (a) ``run_load`` against one host (48
           requests, 4 clients, 8192/3000/2048 points, every request
           traced, the cost surface of phase 15 armed, the ledger
           identity polled): the load, event, trace, SLO, capacity and
           calibration documents valid, the advisor's report; (b) two
           hosts behind the port's ``FleetRouter``: routed flows bitwise
           the host engine's, one routed request launching kernels 1 and
           2 eight times each (profiler), the same load routed; (c) the
           fleet chaos legs (host 1 lost mid-load and revived on its port
           with no capture, ``/admin/reload`` fanned out with no capture
           or recompile, a canary that promotes and one that is
           rejected) in a valid ``pvraft_fleet_chaos/v1`` document;
           direct and routed p50/p95/p99 and requests/s;
  phase 19 the port's static checks (``static_checks``,
           ``static_checks_phase``; after phase 18): ``python -m
           pvraft_tpu_torch.analysis concurrency`` (threadcheck),
           ``... determinism`` (detcheck), ``... sharding`` (shardcheck,
           GS004 over ``engine/``, ``obs/``, ``parallel/``) and ``...
           lint`` (graftlint, GL006 and GL007 over the package, this
           script and ``tests/test_torch_*.py``) over the port's own
           source, each in a subprocess, each at 0
           findings; files checked, findings and seconds; then the pod
           plan (``analysis/sharding/planner.py``) from phase 15's card
           inventory: its scene verdicts and 1 x 1 rows, and its
           prediction for phase 12's chunked step (2 x 16,384, chunks
           4096, remat "full") within [0.8, 1.25] of that step's
           measured peak. No kernel is launched;
  phase 6  off the flagship (``off_flagship``): one 8,192-point request
           at truncate_k 1024 / corr_knn 64, and one at hidden 32 /
           context 96 with fused_gru, ``use_pallas=None``: the profiler
           must see the general kernels launched, never the plain path;
  phase 7  the launches of the main paths (``launches_phase``): each
           serve group of phases 2 and 4, one train step and one eval step
           of every way of phase 3, stage 2's train and eval steps and
           requests (phase 9), the bf16 serve groups (fused_gru off and
           on) and a bf16 train and eval step (phase 10), and one HTTP
           request per serve group through ``build_service`` at the
           default dtype (phase 11), and one call of phase 12's 4-step
           train graph, each pass alone
           under ``torch.profiler`` with the counts zeroed just before it.
           Phases 2, 4-7 and 9 serve at ``dtype="float32"``, asked for
           explicitly (the default is bfloat16).

Launch counts: a wrapper counts its eager launches where it launches
its kernel; a replayed graph runs no wrapper, so every count on a
captured path is measured: phases 6 and 7 count the card's kernels by
their device symbols (``ops/cuda.measured_launches``), and the launches
each program's capture recorded are the cross-check. Phases 6 and 7 run
last: a profiler session leaves the process's eager launches slower, so
it would tilt the eager-against-graphed times of phases 2-4. The
``kernels`` line lists the three tuned kernels (launches from phase 7 and
the kernel bench), the two general ones (launches from phase 6) and the
bf16 GRU kernel (launches from phase 7's bf16 requests and steps).

Phases run in the order 0-5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
6, 7. Each phase
prints one JSON line. Then the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line; so does a machine without CUDA, or a directory without the port.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import pickle
import re
import statistics
import sys
import time

import numpy as np
import torch

from pvraft_tpu_torch.device import (
    deterministic_algorithms,
    fix_cublas_workspace,
    set_tf32,
)
from pvraft_tpu_torch.kernel_bench import device_ms
from pvraft_tpu_torch.ops import kernel_bounds
from pvraft_tpu_torch.ops.cuda import KERNEL_SYMBOLS, gru_variant, lookup_variant

# The H100 SXM's published peaks and each kernel's bytes and operations
# live in the package (ops/kernel_bounds.py), which the program inventory
# counts kernels by too. The bound of a kernel is the larger of its bytes
# over the memory rate and its operations over the compute rate of the
# units it runs on.
bound = kernel_bounds.bound

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


NO_LAUNCHES = dict.fromkeys(KERNEL_SYMBOLS, 0)
# The kernel (by its wrapper's count) each Function runs, per variant.
LOOKUP_KERNELS = {"tuned": "fused_corr_lookup",
                  "general": "corr_lookup_general"}
VOXEL_KERNELS = {"tuned": "voxel_bin_means_pallas",
                 "general": "corr_lookup_general"}
GRU_KERNELS = {"tuned": "fused_gru_update", "general": "gru_iter_general",
               "bf16": "gru_iter_bf16"}


def captured_share(report, want):
    """Whether every program's capture recorded ``want`` per replay (the
    cross-check of a measured count)."""
    share = {k: v for k, v in want.items() if v}
    return all(r["launches"] == share for r in report)


# --------------------------------------------------------------- phase 1 --


def lookup_inputs(rng, b, n, dev, k=K):
    """Candidates around the query coords with continuous offsets (no
    exact distance ties), spread over all three voxel levels."""
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = coords[:, :, None, :] + rng.normal(0, 0.6, (b, n, k, 3)).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (corr, xyz, coords))


def lookup_case(name, args):
    """Holds the lookup kernel against its plain version on ``args``
    (corr, xyz, coords, levels, base_scale, resolution, knn): identical
    kNN indices, max |err| <= 1e-5, two launches bitwise equal; times
    both."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup_plain, fused_corr_lookup)

    corr, _, _, levels, _, res, knn = args
    b, n, k = corr.shape
    kernel = LOOKUP_KERNELS[lookup_variant(k, knn, res)]
    before = read_counts()[kernel]
    got = fused_corr_lookup(*args)
    again = fused_corr_lookup(*args)
    want = corr_lookup_plain(*args)
    torch.cuda.synchronize()
    check(read_counts()[kernel] == before + 2,
          f"lookup {name}: {kernel} did not run it")
    check(torch.equal(got[3], want[3]),
          f"lookup {name}: kNN indices differ from the plain version")
    err = max([float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])
               if g.numel()], default=0.0)
    check(err <= 1e-5, f"lookup {name}: max |err| {err} > 1e-5")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"lookup {name}: two launches are not bitwise equal")
    filled = float((got[0] != 0).float().mean()) if got[0].numel() else 0.0
    plan = general_plan(kernel, k, knn, res, levels)
    cost = kernel_bounds.lookup_cost(b, n, k, levels, res, knn)
    bytes_, ops = cost.bytes, cost.ops
    return {
        "kernel": kernel, "resolution": res,
        "shape": [b, n, k], "knn": knn, "levels": levels,
        "base_scale": args[4], "max_abs_err": err, "bitwise_repeat": True,
        "filled_cells": filled,
        "ms": device_ms(lambda: fused_corr_lookup(*args)),
        "call_ms": cuda_ms(lambda: fused_corr_lookup(*args)),
        "plain_ms": device_ms(lambda: corr_lookup_plain(*args)),
        "library_ms": None,
        "bytes": bytes_, "ops": ops,
        **bound(bytes_, ops), **plan,
    }


def general_plan(kernel, k, knn, res, levels):
    """For the general kernel, its launch plan and the warps per SM the
    occupancy calculator gives it on this card; else nothing."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        general_lookup_plan, general_resident_warps)

    if kernel != "corr_lookup_general":
        return {}
    return {"plan": general_lookup_plan(k, knn, res, levels)._asdict(),
            "resident_warps": general_resident_warps(k, knn, res, levels)}


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


def general_lookup_split(rng, dev):
    """The general lookup kernel's time at phase 6's shape (MAIN_GENERAL's
    lookup) as it is, without its kNN branch, without its voxel branch
    and with neither (the loads alone), through ``corr_lookup_general``
    with knn = 0 and levels = 0."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import corr_lookup_general

    k, knn, res, levels = GENERAL_LOOKUPS[MAIN_GENERAL[0]]
    inputs = lookup_inputs(rng, *MAIN_SHAPE, dev, k)
    out = {}
    for name, lv, kn in (("full", levels, knn), ("no_knn", levels, 0),
                         ("no_voxel", 0, knn), ("loads_only", 0, 0)):
        args = (*inputs, lv, BASE_SCALE, res, kn)
        out[name] = device_ms(lambda: corr_lookup_general(*args))
    return out


def gru_inputs(rng, b, n, dev, scale=1.0, h=WIDTH, c=None, f=WIDTH):
    """Seeded GRU operands at hidden width ``h``, context width ``c``
    (default ``h``) and correlation features of ``f`` (default WIDTH, the
    lookup head's): weights 0.15 N(0,1); net = tanh, inp = relu and cor
    of ``scale`` N(0,1); flow 0.3 ``scale`` N(0,1)."""
    from pvraft_tpu_torch.ops.cuda.gru_iter import pack_gru_weights, pad_flow

    c = h if c is None else c

    def a(*s, scale=0.15):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    me = (a(f, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(2 * h + c, h), a(h)) * 3
    weights = pack_gru_weights(me, gru, h, c)
    net = torch.tanh(a(b, n, h, scale=scale))
    inp = torch.relu(a(b, n, c, scale=scale))
    cor = a(b, n, f, scale=scale)
    flow = a(b, n, 3, scale=0.3 * scale)
    return me, gru, (net, inp, cor, pad_flow(flow).contiguous(), weights), flow


# name: (B, N, activation scale, atol). Point counts off the kernel's
# 64-point tile, and activations x10 that saturate sigmoid and tanh: there
# fp32 gru_math itself is ~1e-5 from fp64 (tests/test_torch_gru_split.py),
# so that case holds 1e-4.
GRU_CASES = {"ragged_2x2056": (2, 2056, 1.0, 1e-5),
             "ragged_1x8191": (1, 8191, 1.0, 1e-5),
             "saturating_1x8192": (1, 8192, 10.0, 1e-4)}


def check_gru(rng, b, n, dev, scale=1.0, tol=1e-5, h=WIDTH, c=None,
              f=WIDTH):
    """Holds the GRU kernel that the wrapper picks for hidden width ``h``,
    context width ``c`` (default ``h``) and correlation width ``f`` (the
    tuned kernel where all three are WIDTH, else the general one) against
    ``gru_math``: max |err| <= ``tol``, two launches bitwise equal; the
    unfused modules (the library yardstick) against it too; times all
    three. A kernel on the tensor cores (the tuned one; the general one in
    its "resident" and "ring" modes) is bound by the 3xTF32 operations
    (three tensor-core products per fp32 product) or its bytes, with the
    fp32 CUDA-core bound of the same work beside it (``fp32_bound_ms``);
    the general kernel's "fma" mode by the fp32 CUDA-core one."""
    from pvraft_tpu_torch.models.update import ConvGRU, MotionEncoder
    from pvraft_tpu_torch.ops.cuda.gru_iter import (
        fused_gru_update, general_gru_plan, gru_math)

    c = h if c is None else c
    variant = gru_variant(h, c, f)
    kernel = GRU_KERNELS[variant]
    me, gru, args, flow = gru_inputs(rng, b, n, dev, scale, h, c, f)
    before = read_counts()[kernel]
    got = fused_gru_update(*args)
    again = fused_gru_update(*args)
    want = gru_math(*args)
    torch.cuda.synchronize()
    check(read_counts()[kernel] == before + 2,
          f"gru {h}/{c}/{f}: {kernel} did not run it")
    err = float((got - want).abs().max())
    check(err <= tol, f"gru {b}x{n} {h}/{c}/{f} scale {scale}: max |err| "
                      f"{err} > {tol}")
    check(torch.equal(got, again),
          f"gru {b}x{n} {h}/{c}/{f}: launches not bitwise equal")
    # The library yardstick: the unfused MotionEncoder + ConvGRU modules on
    # the same weights (the port never calls them on the kernel path).
    menc = MotionEncoder(h, f).to(dev)
    cgru = ConvGRU(h, c + h).to(dev)
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
    mode = ("tuned" if variant == "tuned"
            else general_gru_plan(h, c, f).mode)
    cost = kernel_bounds.gru_cost(b, n, h, c, f,
                                  "fma" if mode == "fma" else "tf32")
    bytes_, flops = cost.bytes, cost.flops
    return {
        "kernel": kernel, "shape": [b, n, h, c, f], "mode": mode,
        "activation_scale": scale,
        "max_abs_err": err, "atol": tol, "bitwise_repeat": True,
        "ms": device_ms(lambda: fused_gru_update(*args)),
        "call_ms": cuda_ms(lambda: fused_gru_update(*args)),
        "plain_ms": device_ms(lambda: gru_math(*args)),
        "library_ms": device_ms(unfused),
        "bytes": bytes_, "ops": flops, **kernel_bounds.cost_bound(cost),
        "fp32_bound_ms": bound(bytes_, flops)["bound_ms"],
    }


# The bf16 kernel against gru_math at bf16: the JAX package's op-level bf16
# bar (tests/test_fused_gru.py::test_op_forward_parity_bf16). Two
# implementations that sum a product's float32 terms in different orders
# round a few values to neighbouring bf16s; where such a value is a large
# partial sum of a small result (px_q against the r-gate product, ~2 each,
# one bf16 ulp 0.0156), the new state moves by up to ~0.016. So at 1 x 8192
# a handful of outputs in a million pass 1e-2 in any two of them: measured
# on the host, gru_math on bf16 products against gru_math on float32
# products of the same bf16 values, 1 of 786,432 at width 96 (0.0116) and
# 1 of 1,048,576 at width 128 (0.0130). The kernel is held to the bar at
# all but BF16_STRAY of its outputs, and every output to BF16_OP_TOL with
# atol widened to FLOOR_FACTOR x the plain version's own spread across
# sum orders in this run (gru_math on the card against gru_math on the
# host), where that is larger. The unfused bf16 modules (the library
# yardstick) round at other places (one product per concatenated Dense),
# so they are held to the model-level bar at one iteration
# (test_model_forward_parity_bf16_one_iter).
BF16_OP_TOL = {"rtol": 1e-2, "atol": 1e-2}
BF16_STRAY = 1e-5            # share of outputs that may pass BF16_OP_TOL
BF16_MODEL_TOL = {"rtol": 0.05, "atol": 0.03}


def beyond(got, want, rtol, atol) -> int:
    """How many elements of ``got`` lie beyond rtol/atol of ``want``."""
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def within(got, want, rtol, atol) -> bool:
    return beyond(got, want, rtol, atol) == 0


def check_gru_bf16(rng, b, n, dev, h=WIDTH, c=None, f=WIDTH):
    """Holds the bf16 kernel (``csrc/gru_iter_bf16.cu``, through
    ``fused_gru_update(..., torch.bfloat16)``) against ``gru_math`` at
    bf16 on the operands the bf16 model hands it (cor bf16, the rest
    float32): BF16_OP_TOL, two launches bitwise equal; the unfused bf16
    MotionEncoder + ConvGRU modules (the library yardstick) against it at
    BF16_MODEL_TOL; times all three. Hidden width ``h``, context ``c``
    (default ``h``), correlation features ``f``. Bound: bytes, or the same
    operations on the bf16 tensor cores."""
    from pvraft_tpu_torch.models.update import ConvGRU, MotionEncoder
    from pvraft_tpu_torch.ops.cuda.gru_iter import fused_gru_update, gru_math

    c = h if c is None else c
    bf16 = torch.bfloat16
    me, gru, args, flow = gru_inputs(rng, b, n, dev, 1.0, h, c, f)
    net, inp, cor, flow8, weights = args
    args = (net, inp, cor.to(bf16), flow8, weights, bf16)
    before = read_counts()["gru_iter_bf16"]
    got = fused_gru_update(*args)
    again = fused_gru_update(*args)
    want = gru_math(*args)
    torch.cuda.synchronize()
    check(read_counts()["gru_iter_bf16"] == before + 2,
          f"gru bf16 {h}/{c}: gru_iter_bf16 did not run it")
    check(got.dtype == torch.float32, f"gru bf16: output {got.dtype}")
    err = float((got - want).abs().max())
    host = gru_math(*(a.cpu() for a in args[:4]),
                    tuple(w.cpu() for w in weights), bf16)
    floor = float((want.cpu() - host).abs().max())
    stray = beyond(got, want, **BF16_OP_TOL)
    atol = max(BF16_OP_TOL["atol"], FLOOR_FACTOR * floor)
    check(stray <= BF16_STRAY * got.numel()
          and within(got, want, BF16_OP_TOL["rtol"], atol),
          f"gru bf16 {b}x{n} {h}/{c}: max |err| {err}, {stray} outputs "
          f"beyond {BF16_OP_TOL}; the plain version across sum orders "
          f"{floor}")
    check(torch.equal(got, again),
          f"gru bf16 {b}x{n} {h}/{c}: launches not bitwise equal")
    menc = MotionEncoder(h, f, bf16).to(dev)
    cgru = ConvGRU(h, c + h, bf16).to(dev)
    with torch.no_grad():
        for layer, (w, bias) in zip(
                (menc.conv_corr, menc.conv_flow, menc.conv,
                 cgru.convz, cgru.convr, cgru.convq),
                zip((*me, *gru)[0::2], (*me, *gru)[1::2])):
            layer.weight.copy_(w.t())
            layer.bias.copy_(bias)
    cor = args[2]

    def unfused():
        with torch.no_grad():
            motion = menc(flow, cor)
            return cgru(net, torch.cat([inp.to(motion.dtype), motion], -1))

    lib = unfused()
    lib_err = float((lib - want).abs().max())
    check(within(lib, want, **BF16_MODEL_TOL),
          f"gru bf16 {b}x{n}: unfused bf16 modules differ by {lib_err}")
    cost = kernel_bounds.gru_cost(b, n, h, c, f, "bf16")
    bytes_, flops = cost.bytes, cost.flops
    return {
        "kernel": "gru_iter_bf16", "shape": [b, n, h, c, f],
        "max_abs_err": err, **BF16_OP_TOL, "beyond_op_tol": stray,
        "plain_host_vs_card_max": floor, "atol_used": atol,
        "bitwise_repeat": True,
        "library_max_abs_err": lib_err,
        "ms": device_ms(lambda: fused_gru_update(*args)),
        "call_ms": cuda_ms(lambda: fused_gru_update(*args)),
        "plain_ms": device_ms(lambda: gru_math(*args)),
        "library_ms": device_ms(unfused),
        "bytes": bytes_, "ops": flops, **kernel_bounds.cost_bound(cost),
        "fp32_bound_ms": bound(bytes_, flops)["bound_ms"],
    }


def voxel_case(name, corr, xyz, coords, scale, levels=LEVELS,
               res=RESOLUTION):
    """Holds the voxel Function's kernel (the tuned one where it takes the
    shapes, else the general lookup kernel with knn = 0) against
    ``voxel_bin_means`` on rel = xyz - coords: max |err| <= 1e-5, two
    launches bitwise equal; times both."""
    from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas
    from pvraft_tpu_torch.ops.voxel import voxel_bin_means

    rel = (xyz - coords[:, :, None, :]).contiguous()
    args = (corr, rel, levels, scale, res)
    kernel = VOXEL_KERNELS[lookup_variant(corr.shape[-1], 0, res)]
    before = read_counts()[kernel]
    got = voxel_bin_means_pallas(*args)
    again = voxel_bin_means_pallas(*args)
    want = voxel_bin_means(*args)
    torch.cuda.synchronize()
    check(read_counts()[kernel] == before + 2,
          f"voxel {name}: {kernel} did not run it")
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"voxel {name}: max |err| {err} > 1e-5")
    check(torch.equal(got, again), f"voxel {name}: launches not bitwise equal")
    filled = float((got != 0).float().mean())
    b, n, k = corr.shape
    plan = general_plan(kernel, k, 0, res, levels)
    cost = kernel_bounds.voxel_cost(b, n, k, levels, res)
    bytes_, ops = cost.bytes, cost.ops
    return {
        "kernel": kernel, "resolution": res, "levels": levels,
        "shape": [b, n, k], "base_scale": scale, "max_abs_err": err,
        "bitwise_repeat": True, "filled_cells": filled,
        "ms": device_ms(lambda: voxel_bin_means_pallas(*args)),
        "call_ms": cuda_ms(lambda: voxel_bin_means_pallas(*args)),
        "plain_ms": device_ms(lambda: voxel_bin_means(*args)),
        "library_ms": None,
        "bytes": bytes_, "ops": ops,
        **bound(bytes_, ops), **plan,
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


# name: (K, knn, resolution, levels), at 1 x 8192: shapes the tuned kernels
# do not take, which the general kernels run. GRU (hidden, context,
# correlation) widths likewise: widths 32, 96 and 128, phase 6's hidden 32
# / context 96 and two more that keep the context encoder's hidden +
# context = 128 (correlation features at WIDTH, the lookup head's), and
# widths that are not multiples of 8 (the tensor-core layout pads them).
GENERAL_LOOKUPS = {"k1024_knn64_r3": (1024, 64, 3, 3),
                   "k510_knn48_r2": (510, 48, 2, 3),
                   "k512_knn32_r5_l4": (512, 32, 5, 4)}
GENERAL_GRU_WIDTHS = {"width32": (32, 32, WIDTH), "width96": (96, 96, WIDTH),
                      "width128": (128, 128, WIDTH),
                      "hidden32_context96": (32, 96, WIDTH),
                      "hidden96_context32": (96, 32, WIDTH),
                      "hidden48_context80": (48, 80, WIDTH),
                      "h33_c50_f37": (33, 50, 37)}
# The kernels line's shapes: those of phase 6's requests, whose launches
# the line reports.
MAIN_GENERAL = ("k1024_knn64_r3", "hidden32_context96")
# (hidden, context, correlation) widths of the bf16 kernel's checks at
# 1 x 8192: the flagship's, widths 32, 96, 128 and hidden 32 / context 96,
# and widths that are not multiples of 16 (the kernel pads K to 16 and
# channels to 32).
BF16_GRU_WIDTHS = {"width64": (WIDTH, WIDTH, WIDTH),
                   **{k: GENERAL_GRU_WIDTHS[k]
                      for k in ("width32", "width96", "width128",
                                "hidden32_context96", "h33_c50_f37")}}


def check_general(rng, dev):
    """The general kernels against their plain versions at phase 1's bars,
    through the wrappers the model calls: the lookup and the voxel means
    at each of GENERAL_LOOKUPS, the GRU update at each width of
    GENERAL_GRU_WIDTHS, all at 1 x 8192 (``lookup_case``, ``voxel_case``,
    ``check_gru``: each checks that the general kernel ran)."""
    lookup, voxel = {}, {}
    for name, (k, knn, res, levels) in GENERAL_LOOKUPS.items():
        corr, xyz, coords = lookup_inputs(rng, *MAIN_SHAPE, dev, k)
        lookup[name] = lookup_case(
            name, (corr, xyz, coords, levels, BASE_SCALE, res, knn))
        voxel[name] = voxel_case(name, corr, xyz, coords, BASE_SCALE,
                                 levels, res)
        del corr, xyz, coords
    gru = {name: check_gru(rng, *MAIN_SHAPE, dev, h=h, c=c, f=f)
           for name, (h, c, f) in GENERAL_GRU_WIDTHS.items()}
    for group in (lookup, voxel, gru):
        check(all(v["kernel"] in ("corr_lookup_general", "gru_iter_general")
                  for v in group.values()),
              f"general shapes ran a tuned kernel: {group}")
    return {"lookup": lookup, "voxel": voxel, "gru": gru}


def check_general_backward(rng, dev):
    """Each Function's plain-PyTorch backward at the general kernels'
    shapes (lookup K=1024, knn 64, resolution 2; GRU widths 32, 128 and
    hidden 32 / context 96; 1 x 8192) against autograd through the plain versions: max |err| <=
    1e-4."""
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup_plain, fused_corr_lookup)
    from pvraft_tpu_torch.ops.cuda.gru_iter import (
        fused_gru_update, gru_math, pack_gru_weights)

    def grads(fn, leaves, make_args, cots):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        outs = fn(*make_args(xs))
        outs = outs if isinstance(outs, tuple) else (outs,)
        total = sum((o * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(total, xs)

    def cot(t):
        return torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
            np.float32)).to(dev)

    out = {}
    corr, xyz, coords = lookup_inputs(rng, *MAIN_SHAPE, dev, 1024)
    geo = (LEVELS, BASE_SCALE, 2, 64)
    cots = [cot(t) for t in corr_lookup_plain(corr, xyz, coords, *geo)[:3]]
    got, want = (grads(f, [corr], lambda xs: (xs[0], xyz, coords, *geo),
                       cots) for f in (fused_corr_lookup, corr_lookup_plain))
    out["lookup_k1024_knn64_r2"] = grad_err(got, want)
    del corr, xyz, coords
    for h, c in ((32, 32), (128, 128), (32, 96)):
        me, gru, args, _ = gru_inputs(rng, *MAIN_SHAPE, dev, h=h, c=c)
        raw = [*args[:4], *me, *gru]

        def gru_args(xs, h=h, c=c):
            return (*xs[:4], pack_gru_weights(xs[4:10], xs[10:16], h, c))

        cots = [cot(args[0])]
        got, want = (grads(f, raw, gru_args, cots)
                     for f in (fused_gru_update, gru_math))
        out[f"gru_hidden{h}_context{c}"] = grad_err(got, want)
    torch.cuda.synchronize()
    for name, err in out.items():
        check(err <= 1e-4, f"{name} backward: max |err| {err} > 1e-4")
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
                                                 num_iters=1, dtype="float32"),
                              device=dev)
        flows1[name], _ = drive(one, requests)
        del one
        engine = InferenceEngine(state, ServeConfig(ModelConfig(**kw),
                                                    dtype="float32"),
                                 device=dev)
        drive(engine, requests)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        flows[name], times = drive(engine, requests)
        eager = read_counts()
        results[name] = {"requests": times, "eager_wrapper_launches": eager,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        # A replay runs no wrapper: its launches are measured in phase 7.
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
    with deterministic_algorithms(True):
        yield


@contextlib.contextmanager
def scratch_dir():
    """A fresh directory under the checkout's gitignored ``experiments/``,
    removed on exit: where the phases' trainers write checkpoints."""
    import shutil
    import tempfile

    parent = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "experiments")
    os.makedirs(parent, exist_ok=True)
    path = tempfile.mkdtemp(prefix="chip_smoke_", dir=parent)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


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
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    grads, results = {}, {}
    for name, kw in TRAIN_WAYS:
        memory = memory_state()
        trainer = Trainer(flagship_train_config(seed, **kw), device=dev, weights=state)
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
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
        scene = to_device(first_batch(PrefetchLoader(
            trainer.val_ds, 1, num_workers=0)), dev)
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
    # The validation saves best_checkpoint: into a scratch exp_path.
    with scratch_dir() as exp:
        trainer = Trainer(flagship_train_config(
            seed, epochs=TRAIN_STEPS // 2).replace(exp_path=exp),
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

    cfg = ServeConfig(dtype="float32")
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
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
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
    want = {**NO_LAUNCHES,
            "fused_corr_lookup": cfg.train.iters * TRAIN_STEPS}
    # Wrapper counts: the eager steps launch every kernel through the
    # wrapper, the graphed steps none (their launches: phase 7).
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
        scene = to_device(first_batch(PrefetchLoader(
            trainer.val_ds, 1, num_workers=0)), dev)
        zero_counts()
        metrics, flow = trainer.eval_step(scene)
        eval_launches = read_counts()
        metrics = {k: v.clone() for k, v in metrics.items()}
        flow = flow.clone()
        eval_ms = cuda_ms(lambda: trainer.eval_step(scene), reps=3, warmup=1)
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
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


def _state_trees_equal(a, b) -> bool:
    """Two optax state dicts (``opt_state_to_jax``) equal leaf for leaf."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_state_trees_equal(a[k], b[k])
                                        for k in a)
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(np.asarray(a), np.asarray(b))


def export_phase(src, dst):
    """``python -m pvraft_tpu_torch.export`` of ``src`` (the best
    checkpoint) to a reference ``.params`` file, read back by
    ``load_torch_checkpoint``: the same parameters bitwise, the same
    epoch. Returns its seconds, bytes and tensor count."""
    import io

    from pvraft_tpu_torch import export
    from pvraft_tpu_torch.engine.checkpoint import (
        load_params, load_torch_checkpoint)
    from pvraft_tpu_torch.weights import params_from_jax

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        code = export.main([src, dst])
    export_s = time.perf_counter() - t0
    back, back_epoch = load_torch_checkpoint(dst)
    variables, epoch = load_params(src)
    want = params_from_jax(variables)
    check(code == 0 and back_epoch == epoch and list(back) == list(want)
          and all(torch.equal(back[k], want[k]) for k in want),
          f"export: {dst} does not read back as {src} (epoch {back_epoch} "
          f"/ {epoch})")
    return {"export_s": export_s, "bytes": os.path.getsize(dst),
            "tensors": len(back), "epoch": epoch, "bitwise": True}


def checkpoint_phase(seed, dev):
    """The slice at full width: the flagship model trained graphed (B=2 x
    8,192, 4 synthetic scenes) by ``fit`` for 2 epochs into a scratch
    ``exp_path`` under ``deterministic()``, with ``000`` kept by
    ``checkpoint_interval=1``. A second Trainer resumes from that epoch-0
    checkpoint as its ``last_checkpoint`` and runs epoch 1: its losses,
    validation, parameters and Adam state must equal the uninterrupted
    run's bitwise. The Evaluator (32 iterations, one scene per step) on
    ``best_checkpoint`` must give ``fit``'s test means bitwise, and ``InferenceEngine.from_checkpoint`` must answer an
    8,192-point request bitwise like the eager forward on the same
    weights. Reports the checkpoint's bytes, its save and load seconds
    and the evaluator's ms per scene."""
    import shutil

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.engine.checkpoint import (
        find_checkpoint, latest_checkpoint)
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import opt_state_to_jax, seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    base = flagship_train_config(seed, epochs=2)
    out = {}
    with scratch_dir() as root:
        cfg = base.replace(train=dataclasses.replace(base.train,
                                                     checkpoint_interval=1),
                           exp_path=os.path.join(root, "whole"))
        runs = {}
        with deterministic():
            for name in ("whole", "resumed"):
                trainer = Trainer(cfg.replace(
                    exp_path=os.path.join(root, name)), device=dev,
                    weights=state if name == "whole" else None)
                if name == "resumed":
                    os.makedirs(trainer.ckpt_dir, exist_ok=True)
                    shutil.copy(os.path.join(root, "whole", "checkpoints",
                                             "000.msgpack"),
                                os.path.join(trainer.ckpt_dir,
                                             "last_checkpoint.msgpack"))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    epoch = trainer.load_weights(
                        latest_checkpoint(trainer.ckpt_dir), resume=True)
                    torch.cuda.synchronize()
                    out["resume_load_s"] = time.perf_counter() - t0
                    check(epoch == 0 and trainer.begin_epoch == 1,
                          f"resume: epoch {epoch}, begin {trainer.begin_epoch}")
                kept = {}

                def report(epoch, train, val, trainer=trainer, kept=kept):
                    kept[epoch] = {
                        "losses": train["losses"], "val": val,
                        "params": {n: p.detach().clone() for n, p in
                                   trainer.model.named_parameters()},
                        "adam": opt_state_to_jax(
                            trainer.optimizer, trainer.model,
                            trainer.train_step.count[0])}

                test = trainer.fit(report)
                runs[name] = {"kept": kept, "test": test,
                              "save_s": list(trainer.save_s)}
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            whole, resumed = runs["whole"], runs["resumed"]
            check(sorted(whole["kept"]) == [0, 1]
                  and sorted(resumed["kept"]) == [1],
                  f"epochs run: {sorted(whole['kept'])}, "
                  f"{sorted(resumed['kept'])}")
            a, b = whole["kept"][1], resumed["kept"][1]
            resume_bitwise = (
                a["losses"] == b["losses"] and a["val"] == b["val"]
                and all(torch.equal(a["params"][n], b["params"][n])
                        for n in a["params"])
                and _state_trees_equal(a["adam"], b["adam"]))
            check(resume_bitwise,
                  f"resume: epoch 1 differs from the uninterrupted run "
                  f"(losses {a['losses']} / {b['losses']}, val {a['val']} / "
                  f"{b['val']})")
            check(all(np.isfinite(whole["kept"][e]["losses"]).all()
                      for e in (0, 1)), "checkpoints: non-finite losses")
            ckpt_dir = os.path.join(root, "whole", "checkpoints")
            best = find_checkpoint(ckpt_dir, "best_checkpoint")
            ev = Evaluator(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.load(best)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            means = ev.run()
            torch.cuda.synchronize()
            evaluator = {"means": means, "load_s": load_s,
                         "ms_per_scene": 1e3 * (time.perf_counter() - t0)
                         / len(ev.dataset),
                         "scenes": len(ev.dataset),
                         "programs": ev.compile_report()}
            del ev
            gc.collect()
            torch.cuda.empty_cache()
        check(means == whole["test"],
              f"evaluator on best_checkpoint {means} against fit's test "
              f"means {whole['test']}")
        exported = export_phase(best, os.path.join(root, "best.params"))
        serve_cfg = ServeConfig(buckets=(8192,), batch_sizes=(1,),
                                dtype="float32")
        engine = InferenceEngine.from_checkpoint(best, serve_cfg, device=dev)
        check(engine.checkpoint_path == best
              and engine.checkpoint_epoch in (0, 1),
              f"from_checkpoint kept {engine.checkpoint_path}, epoch "
              f"{engine.checkpoint_epoch}")
        _, group, bucket = serve_requests(np.random.default_rng(seed + 1))[0]
        got = engine.predict_batch(group, bucket)[0]
        padded = [torch.from_numpy(x).to(dev)
                  for x in engine.padded_batch(group, bucket)]
        with torch.no_grad():
            flows, _ = engine.model(padded[0], padded[1],
                                    serve_cfg.num_iters, *padded[2:])
        eager = flows[-1][0, :group[0][0].shape[0]].cpu().numpy()
        check(np.array_equal(got, eager),
              f"from_checkpoint: replay vs eager max |dflow| "
              f"{float(np.abs(got - eager).max())}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        out.update({
            "epochs": 2, "resume_bitwise": resume_bitwise,
            "losses": {e: whole["kept"][e]["losses"] for e in (0, 1)},
            "resumed_losses": resumed["kept"][1]["losses"],
            "test_means": whole["test"],
            "evaluator_bitwise": True, "evaluator": evaluator,
            "serve_from_checkpoint_bitwise": True, "export": exported,
            "checkpoint_bytes": os.path.getsize(latest_checkpoint(ckpt_dir)),
            "save_s": whole["save_s"],
            "evaluator_ms_per_scene": evaluator["ms_per_scene"]})
    return out


# --------------------------------------------------------------- phase 8 --

# The phase's sizes: the flagship model at 8,192 points per cloud.
REAL_POINTS = 8192
REAL_MODEL = {}             # ModelConfig keywords (none: the flagship)
REAL_CLI_FLAGS = ()         # the test CLI's flags for REAL_MODEL
FT3D_SCENES = {"train": 16, "val": 4}
FT3D_ROWS = (8192, 14000)
FT3D_SHORT = (4, 11)        # train scenes below 8,192 rows: reject-and-advance
KITTI_ROWS = (14000, 20000)
# The full-frame FT3D tree: raw 540 x 960 frames through the port's own
# preprocessor (``process_scene`` with ``save_near``, as PV-RAFT's data
# are made), 13 train/ scenes (12 train, 1 val: 6 steps of B=2); each
# frame's disparity and flow occlusion masks cover a share drawn from
# FT3D_OCCLUDED.
FT3D_FRAME = (540, 960)
FT3D_FULL_SCENES = 13
FT3D_OCCLUDED = (0.03, 0.15)
KITTI_GROUND, KITTI_FAR = 0.15, 0.10   # shares of ground and far rows
LOADER_WAYS = (("native", {"num_workers": 8, "native": True}),
               ("threads", {"num_workers": 8, "native": False}),
               ("serial", {"num_workers": 0, "native": False}))
LOADER_EPOCHS = 3
METRICS = ("epe3d", "acc3d_strict", "acc3d_relax", "outlier")


def _rotation(rng, max_angle, axes="xyz"):
    r = np.eye(3)
    for axis in axes:
        a = rng.uniform(-max_angle, max_angle)
        c, s = np.cos(a), np.sin(a)
        i, j = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}[axis]
        m = np.eye(3)
        m[i, i] = m[j, j] = c
        m[i, j], m[j, i] = -s, s
        r = r @ m
    return r


def _write_pfm(path, img):
    """A float32 PFM (one channel), rows bottom-up, little-endian."""
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n-1.0\n".encode())
        f.write(np.ascontiguousarray(img[::-1], "<f4").tobytes())


def _write_flo(path, flow):
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.array([202021.25], "<f4").tofile(f)
        np.array([w, h], "<i4").tofile(f)
        np.ascontiguousarray(flow, "<f4").tofile(f)


def _write_png16(path, img):
    """A 16-bit gray PNG, filter type 0 on every row."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w = img.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def _smooth_field(rng, shape, waves=6):
    """A sum of ``waves`` random low-frequency plane waves."""
    v, u = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    out = np.zeros(shape, np.float32)
    for _ in range(waves):
        fu, fv = rng.uniform(-3, 3, 2) * 2 * np.pi / np.array(shape[::-1])
        out += np.cos(fu * u + fv * v + rng.uniform(0, 2 * np.pi))
    return out


def write_full_frames(raw, out, seed):
    """FT3D_FULL_SCENES raw FlyingThings3D frames of FT3D_FRAME pixels in
    the raw layout (PFM disparity and disparity change, ``.flo`` flow,
    16-bit PNG occlusions), each turned into ``out/train/<name>/pc{1,2}.npy``
    by the port's ``process_scene`` with ``save_near``, then deleted. The
    disparity is a smooth positive field (about 4 to 250 px); the
    occlusion masks are random rectangles. A scene keeps its pixels that
    neither mask occludes. Returns the scenes' row counts."""
    import shutil

    from pvraft_tpu_torch.data.preprocess.flyingthings3d import process_scene

    rng = np.random.default_rng(seed + 1)
    h, w = FT3D_FRAME
    dirs = {"disp": ("disparity/left", ".pfm"),
            "disp_occ": ("disparity_occlusions/left", ".png"),
            "change": ("disparity_change/left/into_future", ".pfm"),
            "flow": ("flow/left/into_future", ".flo"),
            "flow_occ": ("flow_occlusions/left/into_future", ".png")}
    for d, _ in dirs.values():
        os.makedirs(os.path.join(raw, "train", d))

    def occlusion():
        occ = np.zeros((h, w), np.uint16)
        share = rng.uniform(*FT3D_OCCLUDED)
        while (occ > 0).mean() < share:
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            occ[y:y + rng.integers(8, 60), x:x + rng.integers(8, 90)] = 65535
        return occ

    rows = []
    for i in range(FT3D_FULL_SCENES):
        name = f"{i:07d}"
        f = {k: os.path.join(raw, "train", d, name + ext)
             for k, (d, ext) in dirs.items()}
        z = _smooth_field(rng, (h, w))
        _write_pfm(f["disp"], (30.0 * np.exp(z / z.std())).astype(np.float32))
        _write_pfm(f["change"], rng.normal(0, 0.3, (h, w)).astype(np.float32))
        _write_flo(f["flow"], (rng.uniform(-8, 8, 2)
                               + rng.normal(0, 1, (h, w, 2))).astype(np.float32))
        _write_png16(f["disp_occ"], occlusion())
        _write_png16(f["flow_occ"], occlusion())
        rows.append(process_scene(raw, out, "train", name, save_near=True)[0])
        for path in f.values():
            os.remove(path)
    shutil.rmtree(raw)
    return rows


def write_trees(root, seed):
    """An FT3D tree (``train/``, ``val/``) and a KITTI tree of all 200
    scenes in the preprocessed layout, from ``seed``: pc2 is pc1 moved by
    a small rigid motion plus noise. Two FT3D train scenes hold fewer than
    8,192 rows; KITTI scenes hold ground rows (y < -1.4 in both frames: the
    motion is a yaw and a translation in the ground plane) and far rows
    (z >= 35), which the filter removes, and keep >= 8,192 rows."""
    rng = np.random.default_rng(seed)
    rows = {"ft3d": [], "kitti": []}
    for split, count in FT3D_SCENES.items():
        for i in range(count):
            n = int(rng.integers(*FT3D_ROWS, endpoint=True))
            if split == "train" and i in FT3D_SHORT:
                n = int(rng.integers(3 * FT3D_ROWS[0] // 4, FT3D_ROWS[0]))
            pc1 = rng.uniform((-15, -8, 5), (15, 8, 35), (n, 3))
            pc2 = (pc1 @ _rotation(rng, 0.05).T + rng.uniform(-0.5, 0.5, 3)
                   + rng.normal(0, 0.01, (n, 3)))
            scene = os.path.join(root, "ft3d", split, f"{i:07d}")
            os.makedirs(scene)
            np.save(os.path.join(scene, "pc1.npy"), pc1.astype(np.float32))
            np.save(os.path.join(scene, "pc2.npy"), pc2.astype(np.float32))
            rows["ft3d"].append(n)
    for i in range(200):
        n = int(rng.integers(*KITTI_ROWS, endpoint=True))
        n_ground, n_far = int(KITTI_GROUND * n), int(KITTI_FAR * n)
        pc1 = rng.uniform((-20, -1.2, 2), (20, 3, 33), (n, 3))
        pc1[:n_ground, 1] = rng.uniform(-2.0, -1.5, n_ground)
        pc1[n_ground:n_ground + n_far, 2] = rng.uniform(36, 60, n_far)
        shift = (rng.uniform(-0.2, 0.2), 0.0, rng.uniform(-1.5, -0.5))
        pc2 = (pc1 @ _rotation(rng, 0.03, "y").T + shift
               + rng.normal(0, 0.01, (n, 3)) * (1, 0, 1))
        scene = os.path.join(root, "kitti", f"{i:06d}")
        os.makedirs(scene)
        np.save(os.path.join(scene, "pc1.npy"), pc1.astype(np.float32))
        np.save(os.path.join(scene, "pc2.npy"), pc2.astype(np.float32))
        rows["kitti"].append(n)
    rows["ft3d_full"] = write_full_frames(os.path.join(root, "ft3d_raw"),
                                          os.path.join(root, "ft3d_full"),
                                          seed)
    return {k: {"scenes": len(v), "min_rows": min(v), "max_rows": max(v),
                "mean_rows": float(np.mean(v))}
            for k, v in rows.items()}


def loader_rates(dataset, seed):
    """Each loader path alone on the host: LOADER_EPOCHS epochs of B=2 x
    REAL_POINTS batches, ms per batch and scenes per second (host
    clock)."""
    from pvraft_tpu_torch.data import PrefetchLoader

    out = {}
    for name, kw in LOADER_WAYS:
        loader = PrefetchLoader(dataset, 2, shuffle=True, drop_last=True,
                                seed=seed, **kw)
        check(loader.native == kw["native"], f"loader {name}: native "
                                             f"{loader.native}")
        n = 0
        t0 = time.perf_counter()
        for epoch in range(LOADER_EPOCHS):
            for b in loader.epoch(epoch):
                check(b["pc1"].shape == (2, REAL_POINTS, 3)
                      and b["flow"].shape == (2, REAL_POINTS, 3),
                      f"loader {name}: batch {b['pc1'].shape}")
                n += 1
        sec = time.perf_counter() - t0
        out[name] = {"batches": n, "ms_per_batch": 1e3 * sec / n,
                     "scenes_per_s": 2 * n / sec}
    return out


def fed_epoch(trainer, loader, init):
    """One epoch of ``trainer``'s graphed steps fed by ``loader``, from
    the state saved in ``init``."""
    trainer.load_weights(init, resume=True)
    trainer.train_loader = loader
    torch.cuda.synchronize()
    out = trainer.training(0)
    check(out["steps"] == len(loader) and all(np.isfinite(out["losses"])),
          f"real data: {out['steps']} steps, losses {out['losses']}")
    return {"steps": out["steps"], "step_ms": out["step_ms"],
            "losses": out["losses"]}


def real_data_phase(seed, dev, synthetic_step_ms):
    """The port's data path on the card at full width, from trees on disk
    (``write_trees``): each loader path alone on the host, on the FT3D
    tree and on the full-frame one; the flagship model trained one epoch
    of graphed steps (B=2 x 8,192, 8 iterations, ``strict_sizes=False``)
    fed by each path on both trees and by synthetic scenes, on one
    Trainer restored between epochs (``load_weights``); the threaded
    and serial epochs bitwise equal on a Trainer captured under
    ``deterministic()``; the Evaluator (32 iterations, one scene per step)
    on FT3D's test split (``val/``) and the 142 KITTI scenes
    (``strict_sizes=True``) from the trained checkpoint, and ``python -m
    pvraft_tpu_torch.test --dataset KITTI`` on the same checkpoint; last,
    one fed epoch and the FT3D evaluation under the profiler: the card
    must run the kernels the captures recorded."""
    import subprocess

    from pvraft_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from pvraft_tpu_torch.data import FT3D, PrefetchLoader, SyntheticDataset
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.weights import seeded_state_dict

    t_phase = time.perf_counter()
    out, split_s = {}, {}

    def lap(name):
        split_s[name] = time.perf_counter() - t_phase - sum(split_s.values())

    with scratch_dir() as root:
        out["trees"] = write_trees(root, seed)
        lap("trees")
        ft3d, kitti = os.path.join(root, "ft3d"), os.path.join(root, "kitti")
        model = ModelConfig(**REAL_MODEL)
        cfg = Config(model=model,
                     data=DataConfig(dataset="FT3D", root=ft3d,
                                     max_points=REAL_POINTS,
                                     strict_sizes=False),
                     train=TrainConfig(num_epochs=1, seed=seed),
                     exp_path=os.path.join(root, "exp"))
        state = seeded_state_dict(model, seed)
        trainer = Trainer(cfg, device=dev, weights=state)
        check(trainer.train_loader.native and len(trainer.train_ds) == 15,
              f"real data: native {trainer.train_loader.native}, "
              f"{len(trainer.train_ds)} train scenes")
        lap("trainer")
        full = FT3D(os.path.join(root, "ft3d_full"), REAL_POINTS, "train",
                    strict_sizes=False, seed=seed)
        check(len(full) == FT3D_FULL_SCENES - 1,
              f"real data: {len(full)} full-frame train scenes")
        out["loaders"] = loader_rates(trainer.train_ds, seed)
        out["loaders_full_frames"] = loader_rates(full, seed)
        lap("loaders")
        init = trainer.save(0, 1)[1]                    # 000.msgpack
        own = trainer.train_loader
        synthetic = SyntheticDataset(size=len(trainer.train_ds),
                                     nb_points=REAL_POINTS, noise=0.01,
                                     seed=seed,
                                     n_objects=4)
        feeds = {
            "native": own,
            "threads": PrefetchLoader(trainer.train_ds, 2, shuffle=True,
                                      num_workers=8, seed=seed),
            "serial": PrefetchLoader(trainer.train_ds, 2, shuffle=True,
                                     num_workers=0, seed=seed),
            "synthetic": PrefetchLoader(synthetic, 2, shuffle=True,
                                        num_workers=8, seed=seed)}
        for name, kw in LOADER_WAYS:
            feeds[f"{name}_full_frames"] = PrefetchLoader(
                full, 2, shuffle=True, seed=seed, **kw)
        train = {}
        for name, loader in feeds.items():
            train[name] = fed_epoch(trainer, loader, init)
            if name == "native":
                trained = trainer.save(1, 1)[1]         # 001.msgpack
        trainer.train_loader = own
        train["phase3_synthetic_graphed_step_ms"] = synthetic_step_ms
        out["train"] = train
        lap("fed_epochs")

        with deterministic():
            det = Trainer(cfg.replace(exp_path=os.path.join(root, "det")),
                          device=dev, weights=state)
            runs = {}
            for name in ("threads", "serial"):
                runs[name] = fed_epoch(det, feeds[name], init)
                runs[name]["params"] = [p.detach().clone()
                                        for p in det.model.parameters()]
        bitwise = runs["threads"]["losses"] == runs["serial"]["losses"] and \
            all(torch.equal(a, b) for a, b in zip(runs["threads"]["params"],
                                                  runs["serial"]["params"]))
        check(bitwise, f"real data: threaded and serial epochs differ: "
                       f"{runs['threads']['losses']} / "
                       f"{runs['serial']['losses']}")
        out["threads_serial_bitwise"] = {
            "bitwise": bitwise, "losses": runs["serial"]["losses"],
            "deterministic_step_ms": {k: v["step_ms"]
                                      for k, v in runs.items()}}
        del det, runs
        gc.collect()
        torch.cuda.empty_cache()
        lap("deterministic")

        evals, evaluators = {}, {}
        for name, data in (("ft3d", cfg.data),
                           ("kitti", DataConfig(dataset="KITTI", root=kitti,
                                                max_points=REAL_POINTS))):
            ev = Evaluator(cfg.replace(data=data), device=dev)
            ev.load(trained)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            means = ev.run()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            check(all(np.isfinite(means[k]) for k in METRICS),
                  f"real data: {name} means {means}")
            evals[name] = {"scenes": len(ev.dataset), "means": means,
                           "ms_per_scene": 1e3 * sec / len(ev.dataset)}
            evaluators[name] = ev
        check(evals["kitti"]["scenes"] == 142 and evals["ft3d"]["scenes"] == 4,
              f"real data: scenes {evals}")
        out["eval"] = evals
        del evaluators["kitti"]
        gc.collect()
        torch.cuda.empty_cache()
        lap("evaluators")

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pvraft_tpu_torch.test", "--dataset",
             "KITTI", "--root", kitti, "--weights", trained,
             "--max_points", str(REAL_POINTS), *REAL_CLI_FLAGS],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"test CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        cli = json.loads(proc.stdout.strip().splitlines()[-1])
        want = evals["kitti"]["means"]
        diff = max(abs(cli[k] - want[k]) for k in want)
        check(set(cli) == set(want) and diff <= 1e-5,
              f"test CLI means {cli} against the Evaluator's {want}")
        out["cli"] = {"means": cli, "wall_s": cli_s,
                      "bitwise": cli == want, "max_abs_diff": diff}
        lap("cli")

        _, counts, wrapper = measured(lambda: trainer.training(0))
        want_train = want_serve("unfused_gru", cfg.train.iters,
                                trainer.steps_per_epoch)
        check(counts == want_train and wrapper == NO_LAUNCHES,
              f"real data: a fed epoch ran {counts} (wrappers {wrapper}), "
              f"expected {want_train}")
        _, eval_counts, eval_wrapper = measured(evaluators["ft3d"].run)
        want_eval = want_serve("unfused_gru", cfg.train.eval_iters, 4)
        check(eval_counts == want_eval and eval_wrapper == NO_LAUNCHES,
              f"real data: the FT3D evaluation ran {eval_counts} (wrappers "
              f"{eval_wrapper}), expected {want_eval}")
        out["launches"] = {"train_epoch": counts, "ft3d_eval": eval_counts}
        del trainer, evaluators, feeds, own, full
        gc.collect()
        torch.cuda.empty_cache()
        lap("profiled")
    out["phase_s"] = time.perf_counter() - t_phase
    out["split_s"] = split_s
    return out


# --------------------------------------------------------------- phase 9 --

REFINE_STEPS = 10            # graphed refine steps (4 scenes, bs 2)
# Over 32 iterations with random weights the flow runs away (mean |flow|
# ~15 at the last iteration on these scenes, the ground truth ~0.3), and
# every kNN and voxel-cell flip spreads: the plain path against itself,
# float atomics against deterministic sums, parts by a median of ~6e-2
# (PERF.md section 6, PR 9), far above FLOW_BOUND. So at 32 iterations the
# kernels are held to the plain path's own run-to-run spread, measured in
# the same run, times FLOOR_FACTOR (or FLOW_BOUND where that is larger).
# Both sides are measured against one fixed reference, the deterministic
# plain flow, and the spread is pooled over FLOOR_RUNS float-atomic plain
# runs: one run's median moved from 0.0385 to 0.0905 between two runs of
# the same tree.
FLOOR_FACTOR = 2.0
FLOOR_RUNS = 3
REFINE_SERVE = {"buckets": (4096, 8192), "batch_sizes": (1, 4)}


def refine_grads(model, batch, iters):
    """The refine loss and its gradients: the head's, and None for every
    backbone leaf (the backbone runs without autograd)."""
    from pvraft_tpu_torch.engine.steps import refine_loss_of

    model.zero_grad(set_to_none=True)
    loss, _ = refine_loss_of(model, batch, iters)
    loss.backward()
    return loss.item(), {n: None if p.grad is None else p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def _head(result):
    loss, grads = result
    return loss, {n: g for n, g in grads.items()
                  if not n.startswith("backbone.")}


def refine_phase(seed, dev):
    """Stage 2 at the canonical refine configuration (the flagship model,
    B=2 x 8,192, 32 iterations, Adam over the head, masked L1) on seeded
    FT3D-like synthetic scenes. A stage-1 checkpoint (seeded weights of
    another seed, the JAX package's msgpack file) is imported into a
    graphed refine Trainer's backbone (``load_stage1_weights``); ten
    graphed refine steps must lower the loss (mean of the last 3 below the
    first) and leave the backbone bitwise unchanged; the refine step and
    eval step are timed, with the step's peak memory. Kernels against
    plain versions on the same weights and batch: head gradients at 1
    iteration under GRAD_BOUNDS, every head leaf's gradient at 32
    iterations finite and non-zero and every backbone leaf's None; the
    refined flow max |dflow| <= FLOW_BOUND_1 at 1 iteration, and at 32
    the kernels' median |dflow| against the deterministic plain flow
    within FLOOR_FACTOR x the plain path's own run-to-run median (the
    per-point differences of FLOOR_RUNS float-atomic plain runs against
    that same deterministic flow, pooled; each run's median printed
    beside it), or FLOW_BOUND where that is larger; the maxima are
    reported (selection flips). Under
    ``deterministic()``: one refine step graphed against eager on the
    same capturable Adam (loss and parameters bitwise), and a 2-epoch
    refine ``fit`` resumed from its epoch-0 checkpoint (epoch 1 bitwise).
    The refine Evaluator on ``best_checkpoint`` must give ``fit``'s test
    means bitwise, and ``InferenceEngine.from_checkpoint`` with
    ``ServeConfig(refine=True)`` must answer one 8,192-point request and a
    batch of 4 bitwise like the eager forward. No wrapper launches eagerly
    on a graphed path; the launches of its replays are phase 7's."""
    import shutil

    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.checkpoint import (
        find_checkpoint, latest_checkpoint, save_checkpoint)
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.models import PVRaft, PVRaftRefine
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import (
        opt_state_to_jax, params_to_jax, seeded_state_dict)

    cfg = flagship_train_config(seed, epochs=REFINE_STEPS // 2, refine=True)
    iters = cfg.train.iters
    state = seeded_state_dict(cfg.model, seed, refine=True)
    out = {"iters": iters, "batch": cfg.train.batch_size,
           "points": cfg.data.max_points}
    with scratch_dir() as root:
        stage1 = seeded_state_dict(cfg.model, seed + 1)
        s1_model = PVRaft(cfg.model)
        s1_model.load_state_dict(stage1)
        s1_path = save_checkpoint(
            os.path.join(root, "stage1"), params_to_jax(stage1),
            opt_state_to_jax(torch.optim.Adam(s1_model.parameters()),
                             s1_model), 19, 0)[0]
        del s1_model

        # Import, ten graphed steps, times.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = Trainer(cfg.replace(exp_path=os.path.join(root, "train")),
                          device=dev, weights=state)
        setup_s = time.perf_counter() - t0
        check(trainer.load_stage1_weights(s1_path) == 19
              and all(torch.equal(p.cpu(), stage1[n]) for n, p in
                      trainer.model.backbone.named_parameters()),
              "refine: the stage-1 checkpoint did not reach the backbone")
        backbone = {n: p.detach().clone()
                    for n, p in trainer.model.backbone.named_parameters()}
        zero_counts()
        losses = []
        for epoch in range(cfg.train.num_epochs):
            losses += trainer.training(epoch)["losses"]
        torch.cuda.synchronize()
        wrapper = read_counts()
        check(len(losses) == REFINE_STEPS and all(np.isfinite(losses)),
              f"refine: losses {losses}")
        last3 = float(np.mean(losses[-3:]))
        check(last3 < losses[0], f"refine: mean loss of the last 3 steps "
                                 f"{last3} is not below the first "
                                 f"{losses[0]}")
        check(all(torch.equal(p, backbone[n]) for n, p in
                  trainer.model.backbone.named_parameters()),
              "refine: a graphed refine step changed the backbone")
        programs = trainer.compile_report()
        check(wrapper == NO_LAUNCHES and len(programs) == 2
              and all(p["graph"] for p in programs)
              and captured_share(programs, want_serve("unfused_gru", iters)),
              f"refine: wrapper launches {wrapper} in graphed steps, or "
              f"captures {programs}")
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
        scene1 = to_device(first_batch(PrefetchLoader(
            trainer.val_ds, 1, num_workers=0)), dev)
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: trainer.train_step(batch),
                          reps=TIMED_STEPS, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        eval_ms = cuda_ms(lambda: trainer.eval_step(scene1), reps=3,
                          warmup=1)
        out["training"] = {
            "steps": REFINE_STEPS, "losses": losses, "first": losses[0],
            "last3_mean": last3, "backbone_unchanged": True,
            "stage1_import": s1_path.rsplit(os.sep, 1)[-1],
            "setup_s": setup_s, "train_step_ms": step_ms,
            "peak_mem_bytes": peak, "eval_step_ms": eval_ms,
            "eval_iters": trainer.eval_iters, "programs": programs}
        del trainer, scene1
        gc.collect()
        torch.cuda.empty_cache()

        # Kernels against plain versions, eager, on the same weights.
        models = {}
        for name, kw in (("kernels", {}), ("plain", {"use_pallas": False})):
            models[name] = PVRaftRefine(dataclasses.replace(
                cfg.model, **kw)).to(dev)
            models[name].load_state_dict(state)
        with deterministic():
            one = grad_agreement(*(_head(refine_grads(models[k], batch, 1))
                                   for k in ("kernels", "plain")))
        bar = GRAD_BOUNDS["iters1"]
        check(one["loss_rel"] <= bar["loss_rel"]
              and one["min_cos"] >= bar["min_cos"]
              and one["max_rel"] <= bar["max_rel"],
              f"refine: head gradients, kernels vs plain, 1 iteration: "
              f"{one} (bars {bar})")
        zero_counts()
        _, g32 = refine_grads(models["kernels"], batch, iters)
        eager_launches = read_counts()
        bad = [n for n, g in g32.items() if not n.startswith("backbone.")
               and (g is None or not bool(torch.isfinite(g).all())
                    or float(g.abs().max()) == 0.0)]
        check(not bad and all(g is None for n, g in g32.items()
                              if n.startswith("backbone.")),
              f"refine: head leaves without a finite non-zero gradient "
              f"{bad[:5]}, or a backbone leaf with one")
        check(eager_launches == want_serve("unfused_gru", iters),
              f"refine: an eager step launched {eager_launches}")
        with torch.no_grad():
            flows = {k: {it: m(batch["pc1"], batch["pc2"], it)
                         for it in (1, iters)} for k, m in models.items()}
            atomic = [flows["plain"][iters]] + [
                models["plain"](batch["pc1"], batch["pc2"], iters)
                for _ in range(FLOOR_RUNS - 1)]
            with deterministic():
                plain_det = models["plain"](batch["pc1"], batch["pc2"], iters)

        def diffs(a, b):
            return (a - b).abs().amax(-1).flatten().cpu().numpy()

        d1 = diffs(flows["kernels"][1], flows["plain"][1])
        dn = diffs(flows["kernels"][iters], plain_det)
        runs = [diffs(f, plain_det) for f in atomic]
        floor = np.concatenate(runs)
        run_medians = [float(np.median(r)) for r in runs]
        bound_n = max(FLOW_BOUND, FLOOR_FACTOR * float(np.median(floor)))
        check(float(d1.max()) <= FLOW_BOUND_1,
              f"refine: refined flow, 1 iteration, max |dflow| "
              f"{float(d1.max())}")
        check(np.median(dn) <= bound_n,
              f"refine: refined flow, {iters} iterations, median |dflow| "
              f"against the deterministic plain flow {np.median(dn)} (the "
              f"float-atomic plain runs against it: pooled "
              f"{np.median(floor)}, each {run_medians})")
        out["kernels_vs_plain"] = {
            "grads_iters1": one, "head_leaves": len(g32) - len(backbone),
            "flow_iters1_max": float(d1.max()),
            f"kernels_vs_deterministic_iters{iters}_median":
                float(np.median(dn)),
            f"kernels_vs_deterministic_iters{iters}_max": float(dn.max()),
            f"atomic_vs_deterministic_iters{iters}_pooled_median":
                float(np.median(floor)),
            f"atomic_vs_deterministic_iters{iters}_run_medians": run_medians,
            f"atomic_vs_deterministic_iters{iters}_max": float(floor.max()),
            f"mean_abs_flow_iters{iters}": float(
                plain_det.norm(dim=-1).mean()),
            "bounds": {"grads": bar, "iters1_max": FLOW_BOUND_1,
                       f"iters{iters}_median": bound_n}}
        del models, flows, atomic, plain_det, g32
        gc.collect()
        torch.cuda.empty_cache()

        # One step graphed against eager, on the same capturable Adam.
        one_step = {}
        with deterministic():
            for path in ("graphed", "eager"):
                trainer = Trainer(cfg, device=dev, weights=state,
                                  graphs=path == "graphed", capturable=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                m = trainer.train_step(batch)
                torch.cuda.synchronize()
                one_step[path] = {
                    "loss": m["loss"].item(),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "params": {n: p.detach().clone() for n, p in
                               trainer.model.named_parameters()}}
                del trainer, m
                gc.collect()
                torch.cuda.empty_cache()
        g, e = one_step["graphed"], one_step["eager"]
        step_bitwise = g["loss"] == e["loss"] and all(
            torch.equal(g["params"][n], e["params"][n]) for n in g["params"])
        check(step_bitwise, f"refine: one step graphed vs eager: loss "
                            f"{g['loss']} / {e['loss']}")
        out["graphed_vs_eager_step"] = {
            "bitwise": True, "loss": g["loss"],
            "eager_step_peak_mem_bytes": e["peak_mem_bytes"]}
        del one_step, g, e, batch
        gc.collect()
        torch.cuda.empty_cache()

        # fit, resume, Evaluator, serving from the checkpoint.
        fit_cfg = flagship_train_config(seed, epochs=2, refine=True)
        fit_cfg = fit_cfg.replace(train=dataclasses.replace(
            fit_cfg.train, checkpoint_interval=1))
        runs = {}
        with deterministic():
            for name in ("whole", "resumed"):
                trainer = Trainer(fit_cfg.replace(
                    exp_path=os.path.join(root, name)), device=dev,
                    weights=state if name == "whole" else None)
                if name == "resumed":
                    os.makedirs(trainer.ckpt_dir, exist_ok=True)
                    shutil.copy(os.path.join(root, "whole", "checkpoints",
                                             "000.msgpack"),
                                os.path.join(trainer.ckpt_dir,
                                             "last_checkpoint.msgpack"))
                    epoch = trainer.load_weights(
                        latest_checkpoint(trainer.ckpt_dir), resume=True)
                    check(epoch == 0 and trainer.begin_epoch == 1,
                          f"refine resume: epoch {epoch}, begin "
                          f"{trainer.begin_epoch}")
                kept = {}

                def report(epoch, train, val, trainer=trainer, kept=kept):
                    kept[epoch] = {
                        "losses": train["losses"], "val": val,
                        "params": {n: p.detach().clone() for n, p in
                                   trainer.model.named_parameters()},
                        "adam": opt_state_to_jax(
                            trainer.optimizer, trainer.model,
                            trainer.train_step.count[0])}

                runs[name] = {"kept": kept, "test": trainer.fit(report)}
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            a, b = runs["whole"]["kept"][1], runs["resumed"]["kept"][1]
            resume_bitwise = (
                sorted(runs["resumed"]["kept"]) == [1]
                and a["losses"] == b["losses"] and a["val"] == b["val"]
                and all(torch.equal(a["params"][n], b["params"][n])
                        for n in a["params"])
                and _state_trees_equal(a["adam"], b["adam"]))
            check(resume_bitwise,
                  f"refine resume: epoch 1 differs from the uninterrupted "
                  f"run (losses {a['losses']} / {b['losses']})")
            best = find_checkpoint(os.path.join(root, "whole", "checkpoints"),
                                   "best_checkpoint")
            ev = Evaluator(fit_cfg, device=dev)
            ev.load(best)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            means = ev.run()
            torch.cuda.synchronize()
            ev_ms = 1e3 * (time.perf_counter() - t0) / len(ev.dataset)
            del ev
            gc.collect()
            torch.cuda.empty_cache()
        check(means == runs["whole"]["test"],
              f"refine Evaluator {means} against fit's test means "
              f"{runs['whole']['test']}")
        out["fit"] = {"epochs": 2, "resume_bitwise": True,
                      "losses": {e: runs["whole"]["kept"][e]["losses"]
                                 for e in (0, 1)},
                      "test_means": runs["whole"]["test"],
                      "evaluator_bitwise": True,
                      "evaluator_ms_per_scene": ev_ms,
                      "checkpoint_bytes": os.path.getsize(best)}
        del runs, a, b

        serve_cfg = ServeConfig(cfg.model, refine=True, dtype="float32",
                                **REFINE_SERVE)
        engine = InferenceEngine.from_checkpoint(best, serve_cfg, device=dev)
        groups = []
        for kind, group, bucket in serve_requests(
                np.random.default_rng(seed + 1))[:2]:
            padded = engine.padded_batch(group, bucket)
            program = engine.program(bucket, padded[0].shape[0])
            zero_counts()
            got = engine.predict_batch(group, bucket)
            check(read_counts() == NO_LAUNCHES,
                  f"refine serve {bucket}: a wrapper launched eagerly in a "
                  f"replay: {read_counts()}")
            replay = program.outputs[0].clone()
            inputs = [torch.from_numpy(x).to(dev) for x in padded]
            with torch.no_grad():
                eager = engine.model(inputs[0], inputs[1],
                                     serve_cfg.num_iters, *inputs[2:])
            check(torch.equal(replay, eager)
                  and all(np.array_equal(f, eager[i, :f.shape[0]].cpu()
                                         .numpy()) for i, f in
                          enumerate(got)),
                  f"refine serve {kind} {bucket}: replay vs eager max "
                  f"|dflow| {float((replay - eager).abs().max())}")
            times = []
            for _ in range(GRAPH_REPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                engine.predict_batch(group, bucket)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t1))
            groups.append({"call": kind, "bucket": bucket,
                           "requests": len(group), "bitwise": True,
                           "request_ms": statistics.median(times)})
        out["serve"] = {"num_iters": serve_cfg.num_iters, "groups": groups,
                        "checkpoint_epoch": engine.checkpoint_epoch,
                        "programs": engine.compile_report()}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 10 --

BF16_SERVE_WAYS = SERVE_WAYS[:2]   # fused_gru off and on, the kernels
BF16_TRAIN_STEPS = 10        # graphed bf16 train steps (4 scenes, bs 2)


def want_bf16(name, iters, calls=1):
    """The kernel launches of ``calls`` bf16 serve calls (or steps) of
    ``iters`` GRU iterations each: the lookup stays the float32 tuned
    kernel, the fused update is the bf16 kernel."""
    n = iters * calls
    return {**NO_LAUNCHES, "fused_corr_lookup": n,
            "gru_iter_bf16": n if name == "fused_gru" else 0}


def epe_against(a, b):
    """Mean endpoint error of flows ``a`` against ``b`` over every real
    point of every request, and that relative to ``b``'s mean norm."""
    err = np.concatenate([np.linalg.norm(x - y, axis=-1)
                          for ga, gb in zip(a, b) for x, y in zip(ga, gb)])
    mag = np.concatenate([np.linalg.norm(y, axis=-1) for g in b for y in g])
    return {"mean_epe": float(err.mean()),
            "rel_epe": float(err.mean() / mag.mean())}


def replay_vs_eager(engine, group, bucket, dev):
    """A group's replay against ``engine.model`` run eagerly on the same
    padded inputs: (bitwise, max |dflow|)."""
    padded = engine.padded_batch(group, bucket)
    program = engine.program(bucket, padded[0].shape[0])
    zero_counts()
    engine.predict_batch(group, bucket)
    check(read_counts() == NO_LAUNCHES,
          f"bf16 serve {bucket}: a wrapper launched eagerly in a replay: "
          f"{read_counts()}")
    replay = program.outputs[0].clone()
    inputs = [torch.from_numpy(x).to(dev) for x in padded]
    with torch.no_grad():
        eager = engine.model(inputs[0], inputs[1], engine.cfg.num_iters,
                             *inputs[2:])
    eager = eager if engine.cfg.refine else eager[0][-1]
    return torch.equal(replay, eager), float((replay - eager).abs().max())


def bf16_phase(seed, dev):
    """The bf16 slice (``bf16``; after phase 9, before the profiler
    phases). (1) The bf16 GRU kernel against ``gru_math`` at bf16 at 1 x
    8192 at every width of BF16_GRU_WIDTHS and at width 64 at every
    (B, N) of LOOKUP_SHAPES, the shapes the bf16 serve groups and train
    steps launch it at (``check_gru_bf16``), timed.
    (2) The flagship serve table at the ``ServeConfig`` default dtype
    (bfloat16), graphed, fused_gru off and on: phase 2's requests, each
    group's replay against the eager forward bitwise, request times;
    bf16 against float32 engines on the same seeded weights at 1 and 8
    iterations (mean EPE and relative EPE; the relative bound
    SERVE_BF16_REL_EPE_BOUND held at 1 iteration, the 8-iteration reading
    printed). (3) A bf16 refine request and the bf16 eval step, each
    graphed against eager bitwise. (4) BF16_TRAIN_STEPS graphed bf16
    train steps (B=2 x 8,192, fused_gru, ``grad_dtype="bfloat16"``) that
    must lower the loss, and one step graphed against eager under
    ``deterministic()`` bitwise (loss and parameters); step and eval
    times, the step's peak memory. No wrapper launches eagerly on a
    graphed path; phase 7 counts what the replays launched."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.steps import make_eval_step
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.serve.engine import SERVE_BF16_REL_EPE_BOUND
    from pvraft_tpu_torch.weights import seeded_state_dict

    rng = np.random.default_rng(seed + 17)
    kernel = {name: check_gru_bf16(rng, *MAIN_SHAPE, dev, h=h, c=c, f=f)
              for name, (h, c, f) in BF16_GRU_WIDTHS.items()}
    shapes = {f"{b}x{n}": check_gru_bf16(rng, b, n, dev)
              for b, n in LOOKUP_SHAPES}
    out = {"kernel": kernel, "shapes": shapes}

    state = seeded_state_dict(ModelConfig(), seed)
    requests = serve_requests(np.random.default_rng(seed + 1))
    serve = {}
    for name, kw in BF16_SERVE_WAYS:
        cfg = ServeConfig(ModelConfig(**kw))
        check(cfg.dtype == "bfloat16", f"ServeConfig().dtype {cfg.dtype}")
        engine = InferenceEngine(state, cfg, device=dev)
        report = engine.compile_report()
        check(all(r["graph"] and r["name"].startswith("predict_bf16_")
                  for r in report)
              and captured_share(report, want_bf16(name, cfg.num_iters)),
              f"bf16 serve {name}: programs {report}")
        drive(engine, requests)                       # warm-up
        zero_counts()
        flows8, times = drive(engine, requests)
        check(read_counts() == NO_LAUNCHES,
              f"bf16 serve {name}: a wrapper launched eagerly")
        groups = []
        for (kind, group, bucket), t in zip(requests, times):
            bitwise, diff = replay_vs_eager(engine, group, bucket, dev)
            check(bitwise, f"bf16 serve {name} {kind} {bucket}: replay vs "
                           f"eager max |dflow| {diff}")
            groups.append({**t, "bitwise": bitwise})
        del engine
        ref8 = InferenceEngine(state, dataclasses.replace(
            cfg, dtype="float32"), device=dev)
        f32_8, _ = drive(ref8, requests)
        del ref8
        one = {}
        for dtype in ("bfloat16", "float32"):
            engine = InferenceEngine(state, dataclasses.replace(
                cfg, dtype=dtype, num_iters=1), device=dev)
            one[dtype], _ = drive(engine, requests)
            del engine
        gc.collect()
        torch.cuda.empty_cache()
        vs1 = epe_against(one["bfloat16"], one["float32"])
        vs8 = epe_against(flows8, f32_8)
        check(vs1["rel_epe"] <= SERVE_BF16_REL_EPE_BOUND,
              f"bf16 serve {name}: relative EPE against float32 at 1 "
              f"iteration {vs1} > {SERVE_BF16_REL_EPE_BOUND}")
        serve[name] = {"groups": groups, "programs": report,
                       "vs_float32": {"iters1": vs1, "iters8": vs8}}
    out["serve"] = {**serve, "rel_epe_bound_iters1": SERVE_BF16_REL_EPE_BOUND}

    # A refine request at bf16, replay against eager.
    refine_state = seeded_state_dict(ModelConfig(), seed, refine=True)
    rcfg = ServeConfig(refine=True, buckets=(8192,), batch_sizes=(1,))
    engine = InferenceEngine(refine_state, rcfg, device=dev)
    kind, group, bucket = requests[0]
    drive(engine, [requests[0]])
    bitwise, diff = replay_vs_eager(engine, group, bucket, dev)
    check(bitwise, f"bf16 refine serve: replay vs eager max |dflow| {diff}")
    _, rtimes = drive(engine, [requests[0]])
    out["refine_serve"] = {"bitwise": bitwise, "request": rtimes[0],
                           "program": engine.compile_report()[0]["name"]}
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # Training and evaluation at bf16 with bf16 gradients, fused_gru.
    tcfg = flagship_train_config(seed, epochs=BF16_TRAIN_STEPS // 2,
                                 grad_dtype="bfloat16", fused_gru=True,
                                 compute_dtype="bfloat16")
    with deterministic():
        one_step = {}
        for path in ("graphed", "eager"):
            trainer = Trainer(tcfg, device=dev, weights=state,
                              graphs=path == "graphed", capturable=True)
            batch = to_device(first_batch(PrefetchLoader(
                trainer.train_ds, 2, num_workers=0)), dev)
            loss = float(trainer.train_step(batch)["loss"])
            one_step[path] = (loss, {n: p.detach().clone() for n, p in
                                     trainer.model.named_parameters()})
            del trainer, batch
            gc.collect()
            torch.cuda.empty_cache()
    (lg, pg), (le, pe) = one_step["graphed"], one_step["eager"]
    if not (lg == le and all(torch.equal(pg[n], pe[n]) for n in pg)):
        start = {n: t.to(dev) for n, t in state.items()}
        raise RuntimeError(f"bf16 train: one graphed step against eager: "
                           f"loss {lg} / {le}, parameters "
                           f"{param_agreement(pg, pe, start)}")
    del one_step, pg, pe
    torch.cuda.synchronize()
    memory = memory_state()
    trainer = Trainer(tcfg, device=dev, weights=state)
    zero_counts()
    losses = []
    for epoch in range(tcfg.train.num_epochs):
        losses += trainer.training(epoch)["losses"]
    torch.cuda.synchronize()
    wrapper = read_counts()
    programs = trainer.compile_report()
    check(wrapper == NO_LAUNCHES and all(p["graph"] for p in programs)
          and captured_share(programs[:1],
                             want_bf16("fused_gru", tcfg.train.iters))
          and captured_share(programs[1:],
                             want_bf16("fused_gru", tcfg.train.eval_iters)),
          f"bf16 train: wrapper launches {wrapper} or captures {programs}")
    check(len(losses) == BF16_TRAIN_STEPS and all(np.isfinite(losses)),
          f"bf16 train: losses {losses}")
    first3, last3 = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(last3 < first3, f"bf16 train: mean loss of the last 3 steps "
                          f"{last3} is not below the first 3 {first3}")
    batch = to_device(first_batch(PrefetchLoader(
        trainer.train_ds, 2, num_workers=0)), dev)
    scene = to_device(first_batch(PrefetchLoader(
        trainer.val_ds, 1, num_workers=0)), dev)
    metrics, flow = trainer.eval_step(scene)
    metrics = {k: v.clone() for k, v in metrics.items()}
    flow = flow.clone()
    eager_metrics, eager_flow = make_eval_step(
        trainer.model, tcfg.train.eval_iters, tcfg.train.gamma,
        per_scene=True)(scene)
    eval_bitwise = torch.equal(flow, eager_flow) and all(
        torch.equal(metrics[k], eager_metrics[k]) for k in metrics)
    check(eval_bitwise, f"bf16 eval step: graphed vs eager max |dflow| "
                        f"{float((flow - eager_flow).abs().max())}")
    eval_ms = cuda_ms(lambda: trainer.eval_step(scene), reps=3, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_step(batch), reps=TIMED_STEPS,
                      warmup=2)
    out["train"] = {
        "steps": BF16_TRAIN_STEPS, "losses": losses, "first3_mean": first3,
        "last3_mean": last3, "one_step_graphed_vs_eager_bitwise": True,
        "grad_dtype": tcfg.train.grad_dtype, "fused_gru": True,
        "train_step_ms": step_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "memory_before": memory, "programs": programs,
        "eval": {"iters": tcfg.train.eval_iters, "bitwise": eval_bitwise,
                 "eval_step_ms": eval_ms,
                 "metrics": {k: v.tolist() for k, v in metrics.items()}}}
    del trainer, batch, scene
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 11 --

HTTP_REPS = 5                # timed HTTP calls per group, format and path
REVIVAL_WAIT_S = 30.0        # bound on the wait for the probe's revival
CLI_START_S = 300.0          # bound on the CLI's start (its capture)
TIER_CLI_FLAGS = ()          # more flags of the CLI (none: the flagship)
JSON_CT, MSGPACK_CT = "application/json", "application/msgpack"


def http_call(port, method, path, body=None, ctype=JSON_CT, timeout=120):
    """(status, body bytes, headers) of one request to localhost."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if body is not None
                     else {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def http_predict(port, pc1, pc2, use_msgpack=False):
    """POST /predict in JSON or msgpack; (status, flow or None, headers)."""
    from pvraft_tpu_torch.engine import msgpack

    if use_msgpack:
        body = msgpack.packb({"pc1": pc1.tobytes(), "pc2": pc2.tobytes()})
        status, out, headers = http_call(port, "POST", "/predict", body,
                                         MSGPACK_CT)
        flow = (np.frombuffer(msgpack.unpackb(out)["flow"],
                              np.float32).reshape(-1, 3)
                if status == 200 else None)
    else:
        body = json.dumps({"pc1": pc1.tolist(), "pc2": pc2.tolist()})
        status, out, headers = http_call(port, "POST", "/predict", body)
        flow = (np.asarray(json.loads(out)["flow"], np.float32)
                if status == 200 else None)
    return status, flow, headers


def http_json(port, path):
    status, out, _ = http_call(port, "GET", path)
    check(status == 200, f"GET {path}: {status}")
    return json.loads(out)


def concurrently(fns):
    """Run each of ``fns`` on its own thread, started together; their
    results in order."""
    import threading

    if len(fns) == 1:
        return [fns[0]()]
    out = [None] * len(fns)
    start = threading.Barrier(len(fns))

    def run(i):
        start.wait()
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serving_tier_phase(seed, dev, smi):
    """The serving tier (``serving_tier``; after phase 10, before the
    profiler phases): the flagship ``ServeConfig()`` (bfloat16, buckets
    2048/4096/8192, batch sizes 1/4, ``replicas=0``: every card) from a
    msgpack checkpoint of seeded weights, behind ``build_service`` on an
    ephemeral port. (1) Phase 2's requests over HTTP, JSON and msgpack:
    a lone request equals ``engine.predict`` bitwise, the four concurrent
    clients' flows equal their bs-1 or bs-4 run bitwise (else phase 2's
    median bar), JSON and msgpack agree bitwise; HTTP latency per group
    against the direct call, and the queue wait and batch fill of the
    four concurrent requests. (2) ``POST /admin/reload`` of a second
    checkpoint while a client sends requests: every answer is the old
    weights' flow or the new weights' flow, bitwise; ``/healthz``
    reports the new digest and one swap; ``compile_report()`` is
    unchanged (no program captured again, the same pool bytes); the next
    answer equals the eager forward of a model loaded from the new
    checkpoint bitwise; a checkpoint of another structure gets 409.
    (3) A FaultPlan of ``replica_predict_error`` on replica 0 for
    ``quarantine_after`` requests: the replica is quarantined and
    ``/predict`` answers 503 with Retry-After; cleared, the probe revives
    it and ``/predict`` answers 200 within REVIVAL_WAIT_S. (4) ``/metrics``
    JSON and Prometheus reconcile. (5) ``python -m pvraft_tpu_torch.serve
    serve`` in a subprocess answers ``/healthz`` and one ``/predict`` and
    exits 0 after draining on SIGINT."""
    import re
    import signal
    import subprocess

    from pvraft_tpu_torch.engine.checkpoint import load_params, save_checkpoint
    from pvraft_tpu_torch.models.raft import PVRaft
    from pvraft_tpu_torch.serve import (FaultPlan, FaultRule, InferenceEngine,
                                        ServeConfig, build_service,
                                        params_digest)
    from pvraft_tpu_torch.serve import faults
    from pvraft_tpu_torch.weights import (params_from_jax, params_to_jax,
                                          seeded_state_dict)

    cfg = ServeConfig()
    check(cfg.dtype == "bfloat16" and cfg.replicas == 0,
          f"serving tier: ServeConfig() is not the flagship default: {cfg}")
    requests = serve_requests(np.random.default_rng(seed + 1))
    lone8192, group, lone2048 = (requests[0][1][0], requests[1][1],
                                 requests[2][1][0])
    out = {"gpu": smi}
    with scratch_dir() as root:
        paths = {}
        for name, state, epoch in (
                ("old", seeded_state_dict(cfg.model, seed), 0),
                ("new", seeded_state_dict(cfg.model, seed + 100), 1),
                ("refine", seeded_state_dict(cfg.model, seed, refine=True),
                 0)):
            paths[name], = save_checkpoint(
                os.path.join(root, name), params_to_jax(state), {}, epoch,
                checkpoint_interval=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = InferenceEngine.from_checkpoint(paths["old"], cfg,
                                                 device=dev)
        out["engine_s"] = time.perf_counter() - t0
        check(len(engine.replicas) == torch.cuda.device_count(),
              f"serving tier: {len(engine.replicas)} replicas on "
              f"{torch.cuda.device_count()} cards")
        table = engine.compile_report()
        out["capture_s"] = sum(r["warmup_s"] + r["capture_s"] for r in table)
        out["pool_bytes"] = sum(r["pool_bytes"] for r in table)
        server = build_service(engine)
        server.start()
        port = server.port
        try:
            # (1) Flows and latency.
            for name, (pc1, pc2) in (("lone8192", lone8192),
                                     ("lone2048", lone2048)):
                want = engine.predict(pc1, pc2)
                got = {fmt: http_predict(port, pc1, pc2, fmt == "msgpack")
                       for fmt in ("json", "msgpack")}
                check(all(s == 200 and np.array_equal(f, want)
                          for s, f, _ in got.values()),
                      f"serving tier {name}: HTTP flows differ from "
                      f"engine.predict (statuses "
                      f"{[s for s, _, _ in got.values()]})")
            alone = [engine.predict(*r) for r in group]
            grouped = engine.predict_batch(group,
                                           engine.validate_request(*group[0]))
            before = http_json(port, "/metrics")
            flows = concurrently([
                (lambda r=r: http_predict(port, *r)) for r in group])
            after = http_json(port, "/metrics")
            matched = []
            for i, (status, flow, _) in enumerate(flows):
                check(status == 200, f"serving tier concurrent {i}: {status}")
                if np.array_equal(flow, alone[i]):
                    matched.append("bs1")
                elif np.array_equal(flow, grouped[i]):
                    matched.append("bs4")
                else:
                    d = point_diffs([[flow]], [[alone[i]]])
                    check(np.median(d) <= FLOW_BOUND,
                          f"serving tier concurrent {i}: median |dflow| "
                          f"{np.median(d)} against its bs-1 flow")
                    matched.append(f"within_bound:{float(np.median(d))}")
            batches = after["batches_total"] - before["batches_total"]
            fill_sum = (after["batch_fill_mean"] * after["batches_total"]
                        - (before["batch_fill_mean"] or 0.0)
                        * before["batches_total"])
            # The same four requests straight into the service's batcher:
            # each handle's queue wait (enqueue to a collector's take) and
            # its time from submit to its flow.
            def submitted(r):
                t1 = time.perf_counter()
                h = server.batcher.submit(*r)
                h.wait(120)
                return h, 1e3 * (time.perf_counter() - t1)

            handles = concurrently([(lambda r=r: submitted(r))
                                    for r in group])
            out["concurrent"] = {
                "matched": matched, "http_batches": batches,
                "http_batch_fill_mean": fill_sum / batches,
                "queue_wait_ms": [1e3 * (h.t_dequeue - h.t_enqueue)
                                  for h, _ in handles],
                "submit_to_flow_ms": [ms for _, ms in handles]}
            latency = []
            for kind, reqs, bucket in requests:
                entry = {"call": kind, "bucket": bucket,
                         "requests": len(reqs)}
                direct = ((lambda: engine.predict(*reqs[0]))
                          if kind == "predict"
                          else (lambda: engine.predict_batch(reqs, bucket)))
                for path, run in (
                        ("direct_ms", direct),
                        ("json_ms", lambda: concurrently([
                            (lambda r=r: http_predict(port, *r))
                            for r in reqs])),
                        ("msgpack_ms", lambda: concurrently([
                            (lambda r=r: http_predict(port, *r, True))
                            for r in reqs]))):
                    times = []
                    for _ in range(HTTP_REPS):
                        t1 = time.perf_counter()
                        run()
                        times.append(1e3 * (time.perf_counter() - t1))
                    entry[path] = statistics.median(times)
                latency.append(entry)
            out["latency"] = latency

            # (2) Hot swap while a client sends requests.
            import threading

            pc1, pc2 = lone2048
            old_flow = engine.predict(pc1, pc2)
            answers, stop = [], threading.Event()

            def client():
                while not stop.is_set():
                    answers.append(http_predict(port, pc1, pc2)[:2])

            t = threading.Thread(target=client)
            t.start()
            check(wait_for(lambda: len(answers) >= 2, 60),
                  "serving tier: the swap's client got no answers")
            status, body, _ = http_call(
                port, "POST", "/admin/reload",
                json.dumps({"ckpt": paths["new"]}))
            swap = json.loads(body)
            n_at_swap = len(answers)
            check(status == 200, f"serving tier reload: {status} {swap}")
            check(wait_for(lambda: len(answers) >= n_at_swap + 2, 60),
                  "serving tier: no answers after the swap")
            stop.set()
            t.join(120)
            new_flow = engine.predict(pc1, pc2)
            kinds = []
            for status, flow in answers:
                check(status == 200, f"serving tier swap answer: {status}")
                kinds.append("old" if np.array_equal(flow, old_flow) else
                             "new" if np.array_equal(flow, new_flow) else
                             "neither")
            check("neither" not in kinds and kinds[0] == "old"
                  and kinds[-1] == "new",
                  f"serving tier swap: answers {kinds}")
            health = http_json(port, "/healthz")
            new_state = params_from_jax(load_params(paths["new"])[0])
            check(health["weights"]["digest"] == params_digest(new_state)
                  == swap["digest"] and health["weights"]["swaps"] == 1,
                  f"serving tier swap: /healthz weights {health['weights']}")
            check(engine.compile_report() == table,
                  "serving tier swap: the program table changed")
            model = PVRaft(dataclasses.replace(cfg.model,
                                               compute_dtype=cfg.dtype))
            model.load_state_dict(new_state, strict=True)
            model.to(dev).eval()
            status, got, _ = http_predict(port, pc1, pc2)
            padded = [torch.from_numpy(a).to(dev)
                      for a in engine.padded_batch([lone2048], 2048)]
            with torch.no_grad():
                eager = model(padded[0], padded[1], cfg.num_iters,
                              *padded[2:])[0][-1][0, :pc1.shape[0]]
            check(status == 200
                  and np.array_equal(got, eager.float().cpu().numpy()),
                  "serving tier swap: the next answer differs from the "
                  "eager forward of the new checkpoint")
            del model, padded, eager
            status, body, _ = http_call(
                port, "POST", "/admin/reload",
                json.dumps({"ckpt": paths["refine"]}))
            check(status == 409 and http_json(port, "/healthz")["weights"]
                  == health["weights"],
                  f"serving tier: a refine checkpoint got {status}")
            out["swap"] = {**swap, "answers": {k: kinds.count(k)
                                               for k in ("old", "new")}}

            # (3) Quarantine and revival.
            sup = server.supervisor
            n_fail = sup.cfg.quarantine_after
            faults.install_plan(FaultPlan([FaultRule(
                "replica_predict_error", nth=1, every=1, replica=0)]))
            try:
                statuses = [http_predict(port, pc1, pc2)[0]
                            for _ in range(n_fail)]
                check(statuses == [500] * n_fail
                      and sup.state_of(0) in ("quarantined", "probing"),
                      f"serving tier: {n_fail} injected failures gave "
                      f"{statuses}, replica 0 {sup.state_of(0)}")
                status, _, headers = http_predict(port, pc1, pc2)
                check(status == 503 and "Retry-After" in headers,
                      f"serving tier: quarantined pool answered {status}")
            finally:
                faults.clear_plan()
            t_clear = time.perf_counter()
            check(wait_for(lambda: sup.state_of(0) == "healthy",
                           REVIVAL_WAIT_S),
                  "serving tier: the probe did not revive replica 0")
            revived_s = time.perf_counter() - t_clear
            status, flow, _ = http_predict(port, pc1, pc2)
            check(status == 200 and np.array_equal(flow, new_flow),
                  f"serving tier: after revival /predict gave {status}")
            out["supervisor"] = {
                "quarantine_after": n_fail, "revival_s": revived_s,
                "first_200_s": time.perf_counter() - t_clear,
                "retry_after": headers["Retry-After"], **sup.counts}

            # (4) Metrics reconcile.
            snap = http_json(port, "/metrics")
            _, text, _ = http_call(port, "GET", "/metrics?format=prometheus")
            text = text.decode()

            def prom(name):
                return sum(float(v) for v in re.findall(
                    rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M))

            rejected = sum(snap["rejected"].values())
            check(snap["requests_total"] == snap["responses_total"] + rejected
                  and prom("pvraft_serve_requests_total")
                  == snap["requests_total"]
                  and prom("pvraft_serve_responses_total")
                  == snap["responses_total"]
                  and prom("pvraft_serve_rejected_total") == rejected
                  and prom("pvraft_serve_in_flight") == 0,
                  f"serving tier: /metrics does not reconcile: {snap}")
            out["metrics"] = {k: snap[k] for k in (
                "requests_total", "responses_total", "rejected",
                "batches_total", "batch_fill_mean")}
            out["metrics"]["latency"] = {
                k: snap["latency"][k] for k in ("count", "mean_ms", "p50_ms",
                                                "p99_ms")}
            # A swap with no request in flight (back to the old weights):
            # the swap's own cost, against the one under load above.
            idle = engine.reload_checkpoint(paths["old"])
            check(np.array_equal(engine.predict(pc1, pc2), old_flow),
                  "serving tier: the idle swap back did not restore the "
                  "old flows")
            out["swap"]["idle_swap_ms"] = idle["swap_ms"]
        finally:
            server.shutdown(drain=True)

        # (5) The CLI in a subprocess, on the new checkpoint.
        cli_port = free_port()
        log_path = os.path.join(root, "cli.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "pvraft_tpu_torch.serve", "serve",
                 "--ckpt", paths["new"], "--port", str(cli_port),
                 *TIER_CLI_FLAGS],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=log, stderr=subprocess.STDOUT)
        try:
            def healthy():
                check(proc.poll() is None, "serving tier: the CLI exited: "
                      + open(log_path).read()[-2000:])
                try:
                    return http_call(cli_port, "GET", "/healthz",
                                     timeout=5)[0] == 200
                except OSError:
                    return False

            check(wait_for(healthy, CLI_START_S),
                  "serving tier: the CLI did not answer /healthz")
            start_s = time.perf_counter() - t0
            health = http_json(cli_port, "/healthz")
            status, flow, _ = http_predict(cli_port, pc1, pc2)
            check(health["weights"]["digest"] == params_digest(new_state)
                  and status == 200 and flow.shape == (pc1.shape[0], 3)
                  and bool(np.isfinite(flow).all()),
                  f"serving tier CLI: /predict {status}, weights "
                  f"{health['weights']}")
            proc.send_signal(signal.SIGINT)
            code = proc.wait(120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        log = open(log_path).read()
        check(code == 0 and "draining" in log,
              f"serving tier CLI: exit {code}: {log[-2000:]}")
        out["cli"] = {"start_s": start_s, "exit": code,
                      "bitwise_vs_in_process": bool(np.array_equal(
                          flow, new_flow)),
                      "replicas": len(health["replicas"])}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def wait_for(predicate, timeout):
    """Poll ``predicate`` every 10 ms until it holds or ``timeout`` s."""
    deadline = time.perf_counter() + timeout
    while not predicate():
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.01)
    return True


# -------------------------------------------------------------- phase 13 --

TRACE_REPS = 5               # HTTP calls per group at each sampling rate
WINDOW_S = 2.0               # the /debug/trace window of the last step
DEVMEM_INTERVAL_S = 0.5      # the memory monitor's period in phase 13


def stage_trees(records, trace_ids):
    """trace id -> (complete, root span, {stage: span}) of the traces in a
    parsed stream."""
    from pvraft_tpu_torch.obs.trace import SERVE_STAGES, trace_shape

    spans = {}
    for r in records:
        if r["type"] == "span" and r["trace_id"] in trace_ids:
            spans.setdefault(r["trace_id"], []).append(r)
    out = {}
    for tid, ss in spans.items():
        roots, _, _, complete = trace_shape(ss, SERVE_STAGES)
        out[tid] = (complete, roots[0] if len(roots) == 1 else None,
                    {s["name"]: s for s in ss if "parent_id" in s})
    return out


def check_trees(trees, trace_ids, what):
    """Every trace a complete request tree of the seven stages, each
    child inside its root, device_execute longer than 0."""
    from pvraft_tpu_torch.obs.trace import SERVE_STAGES

    for tid in trace_ids:
        complete, root, stages = trees[tid]
        check(complete and root is not None
              and set(stages) == set(SERVE_STAGES),
              f"{what}: trace {tid} is not a complete request tree "
              f"({sorted(stages)})")
        check(all(root["start_ms"] <= s["start_ms"] <= s["end_ms"]
                  <= root["end_ms"] for s in stages.values()),
              f"{what}: trace {tid} has a stage outside its root")
        ex = stages["device_execute"]
        check(ex["end_ms"] > ex["start_ms"],
              f"{what}: trace {tid} device_execute is empty")


def serving_locks(server):
    """Every lock of a built service (engine, batcher, metrics,
    supervisor, watchdog, tracer, memory monitor, telemetry), by name."""
    batcher, engine = server.batcher, server.batcher.engine
    handler = server.httpd.RequestHandlerClass
    locks = {"InferenceEngine._swap_lock": engine._swap_lock,
             "MicroBatcher._intake_lock": batcher._intake_lock,
             "MicroBatcher._count_lock": batcher._count_lock,
             "ServeMetrics._lock": handler.metrics._lock,
             "RetraceWatchdog._lock": batcher.watchdog._lock,
             "Tracer._lock": server.tracer._lock,
             "DeviceMemoryMonitor._state_lock":
                 server.devmem_monitor._state_lock}
    if server.supervisor is not None:
        locks["ReplicaSupervisor._lock"] = server.supervisor._lock
        locks["ReplicaSupervisor._thread_lock"] = \
            server.supervisor._thread_lock
    if handler.telemetry is not None:
        locks["ServeTelemetry._lock"] = handler.telemetry._lock
    for r in engine.replicas:
        locks[f"Replica._lock[{r.index}]"] = r._lock
        locks[f"Replica._count_lock[{r.index}]"] = r._count_lock
    return locks


def keep_handler_errors(server, errors):
    """Collect into ``errors`` what the server's handler threads raise
    (socketserver prints such an exception and drops it)."""
    import traceback

    server.httpd.handle_error = \
        lambda request, address: errors.append(traceback.format_exc())


def prom_value(text, name, labels=""):
    """The value of one Prometheus sample (``labels`` as rendered)."""
    import re

    m = re.search(rf"^{name}{re.escape(labels)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else None


def tracing_cost(server, requests, names, send,
                 settings=(("traced_ms", 1, True), ("untraced_ms", 0, True))):
    """Per group, the median ms of ``send(requests of the group)`` under
    each of ``settings`` ((key, ``sample_every``, spans written to the
    stream or not)), their order turned round each of TRACE_REPS rounds,
    every reading kept."""
    emit = server.tracer.emit
    cost = {names[b]: {key: [] for key, _, _ in settings}
            for _, _, b in requests}
    for rep in range(TRACE_REPS):
        for key, every, spans in (settings if rep % 2 == 0
                                  else settings[::-1]):
            server.tracer.sample_every = every
            server.tracer.emit = emit if spans else None
            for kind, reqs, bucket in requests:
                t1 = time.perf_counter()
                statuses = send(reqs)
                cost[names[bucket]][key].append(
                    1e3 * (time.perf_counter() - t1))
                check(all(s[0] == 200 for s in statuses),
                      f"serve observability tracing cost: {statuses}")
    server.tracer.sample_every, server.tracer.emit = 1, emit
    return {g: {**{key: statistics.median(v) for key, v in c.items()},
                "reps": TRACE_REPS, "samples": c}
            for g, c in cost.items()}


# A client process for tracing_cost_external: it reads the pickled
# requests, and for each "go" on its standard input sends one group's
# requests (the group named on the line) and prints the statuses.
EXTERNAL_CLIENT = """
import json, pickle, sys
sys.path.insert(0, ".")
import chip_smoke
port, path = int(sys.argv[1]), sys.argv[2]
groups = {str(b): reqs for _, reqs, b in pickle.load(open(path, "rb"))}
for line in sys.stdin:
    reqs = groups[line.strip()]
    out = chip_smoke.concurrently([
        (lambda r=r: chip_smoke.http_predict(port, *r, True)[0])
        for r in reqs])
    print(json.dumps(out), flush=True)
"""


def tracing_cost_external(server, pickled, names):
    """:func:`tracing_cost` with the requests sent by another process,
    so that the client does not share this process's interpreter lock
    with the service's threads (what a user's client sees), and a third
    setting: every request traced with its spans kept from the stream
    (the stage histograms only, as a service without telemetry); one
    warm-up round first."""
    import subprocess

    proc = subprocess.Popen(
        [sys.executable, "-c", EXTERNAL_CLIENT, str(server.port), pickled],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    with open(pickled, "rb") as f:
        requests = pickle.load(f)
    bucket_of = {id(reqs): b for _, reqs, b in requests}

    def send(reqs):
        proc.stdin.write(f"{bucket_of[id(reqs)]}\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        check(bool(line), "serve observability: the client process died")
        return [(s,) for s in json.loads(line)]

    try:
        for _, reqs, _ in requests:
            send(reqs)
        return tracing_cost(server, requests, names, send, settings=(
            ("traced_ms", 1, True), ("traced_no_stream_ms", 1, False),
            ("untraced_ms", 0, True)))
    finally:
        proc.stdin.close()
        try:
            proc.wait(60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)


def serve_observability_phase(seed, dev, smi):
    """Serve observability (``serve_observability``; after phase 12,
    before the profiler phases): the flagship ``ServeConfig()`` (bf16)
    from a msgpack checkpoint behind ``build_service`` with a telemetry
    stream, ``trace_sample_every=1``, ``devmem_interval_s=0.5`` and
    ``strict_retrace=True``. (1) Phase 2's requests over HTTP: bitwise
    against the engine's direct calls, each with ``X-Pvraft-Trace`` and a
    complete request tree on the stream; the median of each stage per
    group. (2) The stream validates (header, one ``serve_compile`` per
    captured program, spans, batches, >= 2 memory samples within the
    card's limit); Prometheus has the four families, stage counts equal
    to the traced requests per bucket, the HBM gauge equal to the last
    sample, and ``pvraft_serve_recompiles_total`` 0 after the requests
    and after a ``POST /admin/reload`` (a ``weight_swap`` record); the
    process's compile count does not move. (3) The tracing cost: median
    HTTP latency per group at 1-in-1 against off, alternated,
    TRACE_REPS each, from a client thread of this process and from a
    client process. (4) ``compile_trip`` from a FaultPlan: 500 under
    strict, the counter at 1, a ``recompile`` record, the replica still
    healthy; on a non-strict service 200 and the counter at 1. (5) The
    sanitizer: a second engine and service built under
    ``PVRAFT_CHECKS=1``, every serving lock an ``OrderedLock``, four
    concurrent clients bitwise as without checks, no ``LockOrderError``.
    (6) ``python -m pvraft_tpu_torch.serve serve --events F --trace_sample
    1 --strict_retrace`` drained by SIGINT: exit 0, F validates and ends
    with ``serve_shutdown``. (7) Last, ``/debug/trace?seconds=2`` while a
    client sends 8,192-point requests: 200, a Chrome trace holding
    kernel 1's launches and a ``device_execute`` range, 409 for a second
    window meanwhile, ``trace_window`` start and stop on the stream. No
    handler thread of the phase's services may raise."""
    import signal
    import subprocess
    import threading

    from pvraft_tpu_torch.analysis.concurrency import sanitizer
    from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
    from pvraft_tpu_torch.obs.events import read_events, validate_events_file
    from pvraft_tpu_torch.obs.retrace import compile_count
    from pvraft_tpu_torch.obs.trace import SERVE_STAGES
    from pvraft_tpu_torch.ops.cuda import kernel_of
    from pvraft_tpu_torch.serve import (FaultPlan, FaultRule, InferenceEngine,
                                        ServeConfig, ServeTelemetry,
                                        build_service)
    from pvraft_tpu_torch.serve import faults
    from pvraft_tpu_torch.serve import server as server_mod
    from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

    cfg = ServeConfig()
    check(cfg.dtype == "bfloat16",
          f"serve observability: ServeConfig() is not bf16: {cfg}")
    requests = serve_requests(np.random.default_rng(seed + 1))
    lone8192, group, lone2048 = (requests[0][1][0], requests[1][1],
                                 requests[2][1][0])
    names = {bucket: f"{'lone' if kind == 'predict' else 'group'}{bucket}"
             for kind, _, bucket in requests}
    out = {"gpu": smi}
    t_phase = time.perf_counter()
    with scratch_dir() as root:
        paths = {}
        for name, state, epoch in (
                ("old", seeded_state_dict(cfg.model, seed), 0),
                ("new", seeded_state_dict(cfg.model, seed + 100), 1)):
            paths[name], = save_checkpoint(
                os.path.join(root, name), params_to_jax(state), {}, epoch,
                checkpoint_interval=0)
        events = os.path.join(root, "serve.events.jsonl")
        tel = ServeTelemetry(events, cfg=cfg)
        engine = InferenceEngine.from_checkpoint(paths["old"], cfg,
                                                 device=dev, telemetry=tel)
        n_programs = (len(engine.replicas) * len(cfg.buckets)
                      * len(cfg.batch_sizes))
        server = build_service(
            engine, telemetry=tel, trace_sample_every=1,
            trace_dir=os.path.join(root, "traces"), strict_retrace=True,
            devmem_interval_s=DEVMEM_INTERVAL_S)
        compiles_at_seal = compile_count()
        handler_errors = []
        keep_handler_errors(server, handler_errors)
        server.start()
        port = server.port
        try:
            # (1) Flows and traces.
            trace_ids = {}
            for kind, reqs, bucket in requests:
                for i, (pc1, pc2) in enumerate(reqs):
                    status, flow, headers = http_predict(port, pc1, pc2,
                                                         True)
                    check(status == 200 and np.array_equal(
                              flow, engine.predict(pc1, pc2)),
                          f"serve observability {names[bucket]}[{i}]: "
                          f"{status}, or the flow differs from "
                          f"engine.predict")
                    tid = headers.get("X-Pvraft-Trace")
                    check(bool(tid), f"serve observability "
                          f"{names[bucket]}[{i}]: no X-Pvraft-Trace")
                    trace_ids.setdefault(bucket, []).append(tid)
            group_bucket = engine.validate_request(*group[0])
            alone = [engine.predict(*r) for r in group]
            grouped = engine.predict_batch(group, group_bucket)
            concurrent = concurrently([
                (lambda r=r: http_predict(port, *r, True)) for r in group])
            matched = []
            for i, (status, flow, headers) in enumerate(concurrent):
                check(status == 200 and headers.get("X-Pvraft-Trace"),
                      f"serve observability concurrent {i}: {status}")
                trace_ids[group_bucket].append(headers["X-Pvraft-Trace"])
                matched.append(
                    "bs1" if np.array_equal(flow, alone[i]) else
                    "bs4" if np.array_equal(flow, grouped[i]) else None)
            check(None not in matched, f"serve observability: concurrent "
                  f"flows not bitwise a direct call's: {matched}")
            all_ids = {t for ids in trace_ids.values() for t in ids}

            def spans_written():
                trees = stage_trees(read_events(events), all_ids)
                return len(trees) == len(all_ids) and all(
                    len(t[2]) == len(SERVE_STAGES) for t in trees.values())

            check(wait_for(spans_written, 30),
                  "serve observability: spans missing from the stream")
            trees = stage_trees(read_events(events), all_ids)
            check_trees(trees, all_ids, "serve observability")
            out["stages_ms"] = {
                names[b]: {s: statistics.median(
                    trees[t][2][s]["end_ms"] - trees[t][2][s]["start_ms"]
                    for t in ids) for s in SERVE_STAGES}
                for b, ids in trace_ids.items()}
            out["root_ms"] = {names[b]: statistics.median(
                trees[t][1]["end_ms"] - trees[t][1]["start_ms"]
                for t in ids) for b, ids in trace_ids.items()}
            out["concurrent_matched"] = matched

            # (2) The stream, Prometheus, the gauge, the swap.
            check(wait_for(lambda: sum(
                r["type"] == "device_memory"
                for r in read_events(events)) >= 2, 30),
                  "serve observability: fewer than 2 memory samples")
            server.devmem_monitor.stop()
            problems = validate_events_file(events)
            check(not problems, f"serve observability stream: "
                  f"{problems[:5]}")
            records = read_events(events)
            types = [r["type"] for r in records]
            samples = [r["devices"][0] for r in records
                       if r["type"] == "device_memory"]
            check(types[0] == "run_header"
                  and types.count("serve_compile") == n_programs
                  and "span" in types and "serve_batch" in types,
                  f"serve observability stream: {types.count('serve_compile')}"
                  f" serve_compile of {n_programs}, types {set(types)}")
            check(all(0 < s["bytes_in_use"] <= s["bytes_limit"]
                      and s["peak_bytes_in_use"] >= s["bytes_in_use"]
                      for s in samples),
                  f"serve observability memory samples: {samples}")
            _, text, _ = http_call(port, "GET", "/metrics?format=prometheus")
            text = text.decode()
            for family in ("pvraft_serve_stage_latency_ms",
                           "pvraft_serve_recompiles_total",
                           "pvraft_device_hbm_bytes",
                           "pvraft_device_hbm_peak_bytes"):
                check(f"# TYPE {family} " in text,
                      f"serve observability: no {family} family")
            for b, ids in trace_ids.items():
                for s in SERVE_STAGES:
                    got = prom_value(
                        text, "pvraft_serve_stage_latency_ms_count",
                        f'{{bucket="{b}",stage="{s}"}}')
                    check(got == len(ids), f"serve observability: stage "
                          f"{s} of bucket {b} counts {got}, traced "
                          f"{len(ids)}")
            last = samples[-1]
            gauge = prom_value(text, "pvraft_device_hbm_bytes",
                               f'{{device="{last["device_id"]}"}}')
            check(gauge == last["bytes_in_use"],
                  f"serve observability: HBM gauge {gauge} is not the "
                  f"last sample {last['bytes_in_use']}")
            check(prom_value(text, "pvraft_serve_recompiles_total") == 0,
                  "serve observability: a recompile while serving")
            status, body, _ = http_call(
                port, "POST", "/admin/reload",
                json.dumps({"ckpt": paths["new"]}))
            swap = json.loads(body)
            _, text, _ = http_call(port, "GET", "/metrics?format=prometheus")
            recompiles = prom_value(text.decode(),
                                    "pvraft_serve_recompiles_total")
            swaps = [r for r in read_events(events)
                     if r["type"] == "weight_swap"]
            check(status == 200 and recompiles == 0 and len(swaps) == 1
                  and swaps[0]["digest"] == swap["digest"],
                  f"serve observability reload: {status}, recompiles "
                  f"{recompiles}, {len(swaps)} weight_swap records")
            check(compile_count() == compiles_at_seal,
                  f"serve observability: {compile_count() - compiles_at_seal}"
                  f" compiles while serving and swapping")
            out["stream"] = {
                "records": len(records),
                "types": {t: types.count(t) for t in sorted(set(types))},
                "memory_samples": len(samples),
                "last_sample": last,
                "memory_reserved": torch.cuda.memory_reserved(),
                "memory_allocated": torch.cuda.memory_allocated(),
                "pool_bytes": sum(r["pool_bytes"]
                                  for r in engine.compile_report()),
                "swap_ms": swap["swap_ms"], "recompiles_total": recompiles,
                "compiles_while_serving": compile_count() - compiles_at_seal}

            # (3) The tracing cost, alternating 1-in-1 and off, from a
            # client thread of this process and from a client process.
            pickled = os.path.join(root, "requests.pkl")
            with open(pickled, "wb") as f:
                pickle.dump(requests, f)
            out["tracing_cost"] = tracing_cost(
                server, requests, names,
                lambda reqs: concurrently([
                    (lambda r=r: http_predict(port, *r, True))
                    for r in reqs]))
            out["tracing_cost_client_process"] = tracing_cost_external(
                server, pickled, names)
            server.tracer.sample_every = 1
            # What the device_execute range costs with no profiler on.
            n_ranges = 100000
            t1 = time.perf_counter()
            for _ in range(n_ranges):
                with torch.profiler.record_function("device_execute"):
                    pass
            out["record_function_us"] = (1e6 * (time.perf_counter() - t1)
                                         / n_ranges)

            # (4) compile_trip, strict and not.
            trip = FaultPlan([FaultRule("compile_trip", nth=1, max_fires=1)])
            with faults.injected(trip):
                status, _, _ = http_predict(port, *lone2048, True)
            _, text, _ = http_call(port, "GET", "/metrics?format=prometheus")
            recs = [r for r in read_events(events)
                    if r["type"] == "recompile"]
            state = server.supervisor.state_of(0)
            check(status == 500
                  and prom_value(text.decode(),
                                 "pvraft_serve_recompiles_total") == 1
                  and len(recs) == 1 and state == "healthy",
                  f"serve observability strict compile_trip: {status}, "
                  f"{len(recs)} recompile records, replica 0 {state}")
            check(http_predict(port, *lone2048, True)[0] == 200,
                  "serve observability: no 200 after the strict trip")
            loose = build_service(engine, trace_sample_every=0,
                                  devmem_interval_s=0)
            keep_handler_errors(loose, handler_errors)
            loose.start()
            try:
                with faults.injected(trip):
                    status, _, _ = http_predict(loose.port, *lone2048, True)
                _, text, _ = http_call(loose.port, "GET",
                                       "/metrics?format=prometheus")
                loose_count = prom_value(text.decode(),
                                         "pvraft_serve_recompiles_total")
            finally:
                loose.shutdown(drain=True)
            check(status == 200 and loose_count == 1,
                  f"serve observability non-strict compile_trip: {status}, "
                  f"counter {loose_count}")
            out["compile_trip"] = {"strict_status": 500,
                                   "strict_replica": state,
                                   "loose_status": status,
                                   "loose_recompiles": loose_count}

            # (5) The sanitizer on a second engine and service.
            new_alone = [engine.predict(*r) for r in group]
            new_grouped = engine.predict_batch(group, group_bucket)
            os.environ["PVRAFT_CHECKS"] = "1"
            try:
                sanitizer.reset_order_graph()
                checked = InferenceEngine.from_checkpoint(paths["new"], cfg,
                                                          device=dev)
                sserver = build_service(checked, trace_sample_every=1,
                                        devmem_interval_s=DEVMEM_INTERVAL_S)
                keep_handler_errors(sserver, handler_errors)
                sserver.start()
                try:
                    locks = serving_locks(sserver)
                    plain = sorted(k for k, v in locks.items()
                                   if not isinstance(v,
                                                     sanitizer.OrderedLock))
                    check(not plain, f"serve observability sanitizer: plain "
                          f"locks {plain}")
                    flows = concurrently([
                        (lambda r=r: http_predict(sserver.port, *r, True))
                        for r in group])
                finally:
                    sserver.shutdown(drain=True)
            finally:
                del os.environ["PVRAFT_CHECKS"]
            kinds = []
            for i, (status, flow, _) in enumerate(flows):
                check(status == 200, f"serve observability sanitizer "
                      f"request {i}: {status}")
                kinds.append("bs1" if np.array_equal(flow, new_alone[i])
                             else "bs4" if np.array_equal(
                                 flow, new_grouped[i]) else None)
            check(None not in kinds, f"serve observability sanitizer: "
                  f"flows not bitwise as without checks: {kinds}")
            out["sanitizer"] = {"locks": len(locks), "matched": kinds,
                                "edges": len(sanitizer.order_edges())}
            del checked, sserver
            gc.collect()
            torch.cuda.empty_cache()

            # (6) The CLI with a stream, drained by SIGINT.
            cli_port = free_port()
            cli_events = os.path.join(root, "cli.events.jsonl")
            log_path = os.path.join(root, "cli.log")
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "pvraft_tpu_torch.serve", "serve",
                     "--ckpt", paths["new"], "--port", str(cli_port),
                     "--events", cli_events, "--trace_sample", "1",
                     "--strict_retrace", *TIER_CLI_FLAGS],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    stdout=log, stderr=subprocess.STDOUT)
            try:
                def healthy():
                    check(proc.poll() is None, "serve observability: the "
                          "CLI exited: " + open(log_path).read()[-2000:])
                    try:
                        return http_call(cli_port, "GET", "/healthz",
                                         timeout=5)[0] == 200
                    except OSError:
                        return False

                check(wait_for(healthy, CLI_START_S),
                      "serve observability: the CLI did not answer")
                health = http_json(cli_port, "/healthz")
                status, _, headers = http_predict(cli_port, *lone2048, True)
                proc.send_signal(signal.SIGINT)
                code = proc.wait(120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(30)
            problems = validate_events_file(cli_events)
            cli_types = [r["type"] for r in read_events(cli_events)]
            check(code == 0 and status == 200 and not problems
                  and cli_types[-1] == "serve_shutdown"
                  and "span" in cli_types
                  and health["telemetry"]["trace_sample_every"] == 1,
                  f"serve observability CLI: exit {code}, /predict "
                  f"{status}, stream problems {problems[:3]}, last "
                  f"{cli_types[-1:]}: {open(log_path).read()[-1500:]}")
            out["cli"] = {"exit": code, "records": len(cli_types),
                          "telemetry": health["telemetry"]}

            # (7) Last: a profiler window while a client sends requests.
            stop, answers = threading.Event(), []

            def client():
                while not stop.is_set():
                    answers.append(http_predict(port, *lone8192, True)[0])

            feeder = threading.Thread(target=client)
            feeder.start()
            check(wait_for(lambda: len(answers) >= 2, 60),
                  "serve observability: the window's client got no answer")
            window = {}

            def first_window():
                window["first"] = http_call(
                    port, "GET", f"/debug/trace?seconds={WINDOW_S}")

            opener = threading.Thread(target=first_window)
            n_before = len(answers)
            opener.start()
            check(wait_for(lambda: server_mod._DEBUG_TRACE_LOCK.locked()
                           or not opener.is_alive(), 30),
                  "serve observability: the window did not open")
            second = http_call(port, "GET", "/debug/trace?seconds=1")[0]
            opener.join(120)
            n_during = len(answers) - n_before
            stop.set()
            feeder.join(120)
            status, body, _ = window["first"]
            check(status == 200 and second == 409
                  and all(a == 200 for a in answers),
                  f"serve observability /debug/trace: {status} "
                  f"{body[:300]!r}, second window {second}")
            trace_dir = json.loads(body)["trace_dir"]
            with open(os.path.join(trace_dir, "trace.json")) as f:
                trace = json.load(f)["traceEvents"]
            kernels = collections.Counter(
                kernel_of(e.get("name", "")) for e in trace
                if e.get("cat") == "kernel")
            ranges = collections.Counter(
                e.get("cat") for e in trace
                if e.get("name") == "device_execute")
            windows = [r["action"] for r in read_events(events)
                       if r["type"] == "trace_window"]
            check(kernels["fused_corr_lookup"] > 0 and sum(ranges.values())
                  and windows == ["start", "stop"],
                  f"serve observability trace: kernel 1 launches "
                  f"{kernels['fused_corr_lookup']}, device_execute ranges "
                  f"{dict(ranges)}, windows {windows}")
            out["debug_trace"] = {
                "seconds": WINDOW_S, "requests_during": n_during,
                "kernel_launches": {k: v for k, v in kernels.items() if k},
                "device_execute_ranges": dict(ranges),
                "kernel1_per_range": (kernels["fused_corr_lookup"]
                                      / max(1, ranges["gpu_user_annotation"]
                                            or ranges["user_annotation"])),
                "second_window": second}
        finally:
            server.shutdown(drain=True)
            tel.close()
        types = [r["type"] for r in read_events(events)]
        problems = validate_events_file(events)
        check(not problems and types[-1] == "serve_shutdown",
              f"serve observability: final stream {problems[:3]}, last "
              f"{types[-1:]}")
        check(not handler_errors, f"serve observability: a handler thread "
              f"raised: {handler_errors[:2]}")
        out["stream"]["final_records"] = len(types)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -------------------------------------------------------------- phase 12 --

KSTEP = 4                    # steps per dispatch of phase 12's K-step graph
KSTEP_SCENES = 18            # 9 steps an epoch at B=2: 2 K-step calls, 1 tail
REMAT_WAYS = ("none", "full", "dots", "dots_no_batch", "save_corr")
LONG_POINTS = 16384          # the chunks' clouds (2 x 16,384)
LONG_CHUNK = 4096            # corr_chunk and graph_chunk there
FLAGSHIP_CHUNK = 2048        # corr_chunk and graph_chunk at 1 x 8,192
CHUNK_LOSS_REL = 1e-4        # dense against chunked loss at 16,384 points


def packed_config(seed, scenes=4, **par):
    from pvraft_tpu_torch.config import ParallelConfig
    from pvraft_tpu_torch.profile_train import flagship_train_config

    return flagship_train_config(seed, scenes=scenes,
                                 parallel=ParallelConfig(packed_state=True,
                                                         **par))


def kstep_runs(seed, dev, state):
    """An epoch of KSTEP_SCENES scenes (9 steps: two K-step calls and one
    tail step) through the K = 4 trainer and through the packed single
    step, under ``deterministic()`` from the same weights and batches:
    per-step losses and EPEs and the whole flat state (parameters, Adam's
    moments and steps) bitwise. Then the packed step with
    ``host_roundtrip`` against it, bitwise over two epochs, both timed."""
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer

    runs = {}
    with deterministic():
        for name, par in (("k4", {"steps_per_dispatch": KSTEP}), ("k1", {})):
            trainer = Trainer(packed_config(seed, KSTEP_SCENES, **par),
                              device=dev, weights=state)
            out = trainer.training(0)
            runs[name] = {"losses": out["losses"], "epes": out["epes"],
                          "flat": trainer.flat.clone(),
                          "programs": trainer.compile_report()}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    k4, k1 = runs["k4"], runs["k1"]
    steps = KSTEP_SCENES // 2
    check(len(k4["losses"]) == len(k1["losses"]) == steps
          and all(np.isfinite(k4["losses"])),
          f"train levers: K-step epoch losses {k4['losses']} / "
          f"{k1['losses']}")
    first = next((i for i, (a, b) in enumerate(zip(
        k4["losses"] + k4["epes"], k1["losses"] + k1["epes"])) if a != b),
        None)
    flat_equal = torch.equal(k4.pop("flat"), k1.pop("flat"))
    check(first is None and flat_equal,
          f"train levers: {KSTEP}-step calls against single replays are "
          f"not bitwise: first differing loss/EPE entry {first} (steps "
          f"then EPEs), flat state equal {flat_equal}; losses "
          f"{k4['losses']} / {k1['losses']}")
    multi = [r for r in k4["programs"]
             if r["name"].startswith("multistep_train_step")]
    single = [r for r in k1["programs"]
              if r["name"].startswith("packed_train_step")]
    want = want_serve("unfused_gru", 8 * KSTEP)
    check(len(multi) == 1 and multi[0]["graph"]
          and captured_share(multi, want),
          f"train levers: K-step program {multi}, expected launches {want}")
    result = {"k": KSTEP, "epoch_steps": steps,
              "k_step_calls": steps // KSTEP, "tail_steps": steps % KSTEP,
              "bitwise": True, "losses": k4["losses"], "epes": k4["epes"],
              "programs": {"k4": k4["programs"], "k1": k1["programs"]},
              "pool_bytes": {"k1": single[0]["pool_bytes"],
                             "k4": multi[0]["pool_bytes"]},
              "capture_s": {"k1": single[0]["capture_s"],
                            "k4": multi[0]["capture_s"]}}

    ways = (("packed", {}), ("host_roundtrip", {"host_roundtrip": True}))
    flats = {}
    with deterministic():
        for name, par in ways:
            trainer = Trainer(packed_config(seed, **par), device=dev,
                              weights=state)
            for epoch in range(2):
                trainer.training(epoch)
            flats[name] = trainer.flat.clone()
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    rt_bitwise = torch.equal(flats["packed"], flats["host_roundtrip"])
    check(rt_bitwise, "train levers: host_roundtrip is not bitwise equal "
                      "to the packed step")
    # Timed on trainers captured outside deterministic(): a capture keeps
    # the kernels of the mode it was made in.
    trainers = {name: Trainer(packed_config(seed, **par), device=dev,
                              weights=state) for name, par in ways}
    batch = to_device(first_batch(PrefetchLoader(
        trainers["packed"].train_ds, 2, num_workers=0)), dev)
    ms = {name: [] for name in trainers}
    for _ in range(2):
        for name, trainer in trainers.items():
            ms[name].append(cuda_ms(lambda: trainer.train_step(batch),
                                    reps=4, warmup=1))
    del trainers, batch
    gc.collect()
    torch.cuda.empty_cache()
    result["host_roundtrip"] = {"bitwise": rt_bitwise, "steps": 4,
                                "step_ms_in_turns": ms,
                                "flat_bytes": 4 * flats["packed"].numel()}
    return result


def remat_runs(seed, dev, state, batch):
    """One eager train step at 2 x 8,192 per remat policy (Adam at lr 0,
    so every step starts from the same weights): under
    ``deterministic()`` each policy's gradients against "none" (bitwise,
    else GRAD_BOUNDS), the lookup's eager launches (8 forward, 8 more
    where the backward recomputes it); in the default mode peak memory
    and ms. Then "full" graphed against its eager step on the same
    capturable Adam: it captures, and two steps' losses and parameters
    are bitwise equal."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.profile_train import flagship_train_config

    ways, grads = {}, {}
    for policy in REMAT_WAYS:
        model = PVRaft(ModelConfig(remat_policy=policy))
        model.load_state_dict(state)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=0.0)
        step = make_train_step(model, opt, lambda _: 0.0, 0.8, 8)
        with deterministic():
            zero_counts()
            loss = float(step(batch)["loss"])
            counts = read_counts()
        grads[policy] = (loss, {n: p.grad.detach().clone()
                                for n, p in model.named_parameters()})
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: step(batch), reps=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        lookups = 16 if policy in ("full", "dots", "dots_no_batch") else 8
        check(counts == {**NO_LAUNCHES, "fused_corr_lookup": lookups},
              f"remat {policy}: eager launches {counts}, expected "
              f"{lookups} lookups")
        ways[policy] = {"loss": loss, "step_ms": step_ms,
                        "peak_gb": peak / 1e9,
                        "peak_above_start_gb": (peak - before) / 1e9,
                        "eager_launches": counts}
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    for policy in REMAT_WAYS[1:]:
        got = grad_agreement(grads[policy], grads["none"])
        bitwise = grads[policy][0] == grads["none"][0] and all(
            torch.equal(grads[policy][1][n], g)
            for n, g in grads["none"][1].items())
        ways[policy]["grads_bitwise_to_none"] = bitwise
        if not bitwise:
            ways[policy]["grad_agreement"] = got
            bar = GRAD_BOUNDS["iters8"]
            check(got["loss_rel"] <= bar["loss_rel"]
                  and got["min_cos"] >= bar["min_cos"],
                  f"remat {policy} against none: {got} (bars {bar})")
    del grads

    cfg = flagship_train_config(seed, remat_policy="full")
    graphed = {}
    with deterministic():
        for path in ("graphed", "eager"):
            trainer = Trainer(cfg, device=dev, weights=state,
                              graphs=path == "graphed", capturable=True)
            out = trainer.training(0)
            graphed[path] = {
                "losses": out["losses"],
                "params": [p.detach().clone()
                           for p in trainer.model.parameters()],
                "programs": trainer.compile_report()}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    g, e = graphed["graphed"], graphed["eager"]
    bitwise = g["losses"] == e["losses"] and all(
        torch.equal(a, b) for a, b in zip(g.pop("params"), e.pop("params")))
    want = {**NO_LAUNCHES, "fused_corr_lookup": 16}
    check(bitwise and g["programs"][0]["graph"]
          and captured_share(g["programs"][:1], want),
          f"remat full graphed against eager: bitwise {bitwise}, losses "
          f"{g['losses']} / {e['losses']}, programs {g['programs']}")
    return {"policies": ways, "full_graphed": {
        "bitwise": bitwise, "losses": g["losses"],
        "program": g["programs"][0]}}


def chunk_runs(seed, dev, state):
    """The streaming levers. One eager train step at 2 x 16,384, dense
    against corr_chunk / graph_chunk LONG_CHUNK with remat "full": peak
    memory and ms of each, the losses within CHUNK_LOSS_REL (a dense step
    that does not fit is recorded, and the chunked step runs alone). A
    1-iteration forward at 1 x 8,192 with chunks of FLAGSHIP_CHUNK
    against the dense one, at phase 2's bar (FLOW_BOUND_1)."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import (PrefetchLoader, SyntheticDataset,
                                       first_batch, to_device)
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.models import PVRaft

    ds = SyntheticDataset(size=2, nb_points=LONG_POINTS, noise=0.01,
                          seed=seed, n_objects=4)
    batch = to_device(first_batch(PrefetchLoader(ds, 2, num_workers=0)), dev)
    ways = {}
    for name, kw in (("dense", {}),
                     ("chunked", {"corr_chunk": LONG_CHUNK,
                                  "graph_chunk": LONG_CHUNK,
                                  "remat_policy": "full"})):
        model = PVRaft(ModelConfig(**kw))
        model.load_state_dict(state)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=0.0)
        step = make_train_step(model, opt, lambda _: 0.0, 0.8, 8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            loss = float(step(batch)["loss"])
            step_ms = cuda_ms(lambda: step(batch), reps=2, warmup=0)
            ways[name] = {"loss": loss, "step_ms": step_ms,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        except torch.cuda.OutOfMemoryError as err:
            if name != "dense":
                raise
            ways[name] = {"out_of_memory": str(err).splitlines()[0]}
        ways[name]["config"] = kw
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    result = {"points": LONG_POINTS, "batch": 2, "steps": ways}
    if "loss" in ways["dense"]:
        rel = abs(ways["chunked"]["loss"] - ways["dense"]["loss"]) / abs(
            ways["dense"]["loss"])
        result["loss_rel"] = rel
        check(rel <= CHUNK_LOSS_REL,
              f"chunks at {LONG_POINTS}: loss rel {rel} > {CHUNK_LOSS_REL}")
    del batch

    n = MAIN_SHAPE[1]
    x1, x2 = (torch.from_numpy(c[None]).to(dev)
              for c in scene(np.random.default_rng(seed + 3), n, n))
    flows = {}
    for name, kw in (("dense", {}), ("chunked", {
            "corr_chunk": FLAGSHIP_CHUNK, "graph_chunk": FLAGSHIP_CHUNK})):
        model = PVRaft(ModelConfig(**kw)).eval()
        model.load_state_dict(state)
        model.to(dev)
        with torch.no_grad():
            flows[name] = model(x1, x2, 1)[0][-1]
        del model
    diff = float((flows["chunked"] - flows["dense"]).abs().max())
    check(diff <= FLOW_BOUND_1, f"chunked forward at 1 x 8192: max |dflow| "
                                f"{diff} > {FLOW_BOUND_1}")
    result["flagship_forward"] = {"chunk": FLAGSHIP_CHUNK, "iters": 1,
                                  "max_abs_flow_diff": diff,
                                  "bitwise": diff == 0.0}
    return result


def kstep_launches(seed, dev, state, ways=TRAIN_WAYS[:2]):
    """One K-step call of the flagship trainer (8 scenes: no tail, so no
    single step is captured) under the profiler, each of ``ways``
    (fused_gru off and on): the card must run kernel 1 (and with
    fused_gru kernel 2) 8 K times, and no wrapper may launch eagerly."""
    from pvraft_tpu_torch.config import ParallelConfig
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.steps import stack_batches
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_train import flagship_train_config

    got = {}
    for name, kw in ways:
        trainer = Trainer(flagship_train_config(
            seed, scenes=2 * KSTEP, parallel=ParallelConfig(
                packed_state=True, steps_per_dispatch=KSTEP), **kw),
            device=dev, weights=state)
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
        stacked = stack_batches([batch] * KSTEP)
        _, counts, wrapper = measured(lambda: trainer.multi_step(stacked))
        want = want_serve(name, trainer.cfg.train.iters * KSTEP)
        check(counts == want and wrapper == NO_LAUNCHES,
              f"launches: {KSTEP}-step call {name}: the card ran {counts} "
              f"(wrappers {wrapper}), expected {want}")
        got[name] = counts
        del trainer, batch, stacked
        gc.collect()
        torch.cuda.empty_cache()
    return got


def train_levers_phase(seed, dev):
    """Phase 12: the K-step train graph and the model levers at full
    width (see the module docstring). Eager times are taken before the
    profiler runs (the launches come last)."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.trainer import build_datasets
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    t0 = time.perf_counter()
    out = {"kstep": kstep_runs(seed, dev, state)}
    train_ds = build_datasets(flagship_train_config(seed))[0]
    batch = to_device(first_batch(PrefetchLoader(train_ds, 2,
                                                 num_workers=0)), dev)
    out["remat"] = remat_runs(seed, dev, state, batch)
    del batch
    out["chunks"] = chunk_runs(seed, dev, state)
    out["kstep"]["launches"] = kstep_launches(seed, dev, state)
    out["wall_s"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------------- phase 14 --

# The monitors of the graphed kernel step against the plain eager step's
# (use_pallas=False): this many times the plain path's own run-to-run
# spread, and never below MONITOR_MIN_BAR (relative).
MONITOR_FLOOR_FACTOR = 10.0
MONITOR_MIN_BAR = 1e-4
MONITORED = ("grad_norm", "param_norm", "update_ratio")
ZSCORE_FLOW_SCALE = 100.0    # the ground truth flow of the z-score epoch
TB_TAGS = ("Train/Loss", "Train/EPE", "telemetry/grad_norm",
           "telemetry/update_ratio", "Val/Loss", "Val/EPE", "Val/Outlier",
           "Val/Acc3dRelax", "Val/Acc3dStrict")


class _Altered:
    """A dataset whose scenes ``alter(index, scene)`` rewrites (a NaN
    cloud, a scaled flow); ``alter`` may be replaced between epochs."""

    def __init__(self, dataset, alter):
        self.dataset = dataset
        self.alter = alter

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.alter(i, dict(self.dataset[i]))


@contextlib.contextmanager
def altered_training_set(alter):
    """Trainers built inside train on ``_Altered(train set, alter)``;
    the altered set is yielded, so that ``alter`` can change later."""
    from pvraft_tpu_torch.engine import trainer as trainer_mod

    real = trainer_mod.build_datasets
    made = []

    def build(cfg):
        train, val, test = real(cfg)
        made.append(_Altered(train, alter))
        return made[-1], val, test

    trainer_mod.build_datasets = build
    try:
        yield made
    finally:
        trainer_mod.build_datasets = real


def kernel_totals(fn):
    """Run ``fn()`` under the profiler (``device_kernels``): (each
    wrapper's kernels, every device activity the card ran for it)."""
    from pvraft_tpu_torch.ops.cuda import device_kernels, kernel_of

    counts = dict(NO_LAUNCHES)
    _, names = device_kernels(fn)
    for name in names:
        wrapper = kernel_of(name)
        if wrapper is not None:
            counts[wrapper] += 1
    return counts, len(names)


def plain_monitors(state, cfg, schedule, batch, dev):
    """The first step's monitors of the plain eager step
    (``use_pallas=False``) from ``state`` on ``batch`` on ``schedule``
    (the trainer's)."""
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.models.raft import PVRaft

    model = PVRaft(dataclasses.replace(cfg.model, use_pallas=False))
    model.load_state_dict(state, strict=True)
    model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)
    t = cfg.train
    step = make_train_step(model, optimizer, schedule, t.gamma, t.iters,
                           telemetry=True)
    tel = step(batch)["telemetry"]
    out = {k: float(tel[k]) for k in MONITORED}
    del model, optimizer, step, tel
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def train_observability_phase(seed, dev, smi):
    """Phase 14 (``train_observability``; after phase 13, before the
    profiler phases): the flagship ``TrainConfig`` (B = 2 x 8,192, 8
    iterations, fp32, graphed, ``strict_retrace``) on synthetic scenes.
    (1) A ``telemetry`` Trainer with ``profile_dir`` and divergence
    window 2 runs one epoch and validation: the stream validates; every
    ``step`` event carries every leaf, ``delta_flow_norm`` 8 entries,
    ``nonfinite`` 0; no ``recompile``; one ``device_memory`` sample; the
    TensorBoard tags; kernel 1 eight times a step in the Chrome trace. The
    first step's grad_norm, param_norm and update_ratio against the plain
    eager step's (``use_pallas=False``), within MONITOR_FLOOR_FACTOR x
    the plain step's own spread (two runs). (2) Epoch 1 of the same
    Trainer with every flow scaled by ZSCORE_FLOW_SCALE: a ``zscore``
    trip. (3) A NaN in one scene's first point at 8,192 points under
    ``halt_on_divergence``: a ``nonfinite`` trip at that scene's step, a
    snapshot, the step events flushed, ``DivergenceHalt``, no CUDA
    error; ``python -m pvraft_tpu_torch.doctor`` on the card names
    ``batch``. (4) A default Trainer afterwards: its graphed step's
    kernels (against phase 7's count in ``main``) and the telemetry step's,
    every kernel counted; one healthy epoch. (5) The step profiler at the
    flagship: the record validates, its ``gru_fused`` rung launches
    kernel 2."""
    import subprocess

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.obs.divergence import DivergenceHalt
    from pvraft_tpu_torch.obs.events import read_events, validate_events_file
    from pvraft_tpu_torch.obs.monitors import TELEMETRY_LEAVES
    from pvraft_tpu_torch.ops.cuda import kernel_of
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.profiling import profile_step, validate_step_profile
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    base = flagship_train_config(seed)
    out = {"gpu": smi}
    t_phase = time.perf_counter()

    def config(exp, **train):
        return base.replace(exp_path=exp, train=dataclasses.replace(
            base.train, strict_retrace=True, **train))

    with scratch_dir() as root:
        # (1) One epoch and validation, armed, under profile_dir.
        exp = os.path.join(root, "telemetry")
        profile = os.path.join(exp, "profile")
        scale = [1.0]

        def scaled(i, s):
            s["flow"] = s["flow"] * scale[0]
            return s

        with altered_training_set(scaled):
            trainer = Trainer(config(exp, telemetry=True, profile_dir=profile,
                                     divergence_window=2),
                              device=dev, weights=state)
        first = to_device(first_batch(trainer.train_loader), dev)
        t0 = time.perf_counter()
        train = trainer.training(0)
        epoch_s = time.perf_counter() - t0
        trainer.save(0, base.train.checkpoint_interval)
        val = trainer.val_test(0, "val")
        events = os.path.join(exp, "train.events.jsonl")
        problems = validate_events_file(events)
        check(not problems, f"train observability: the stream: {problems}")
        records = read_events(events)
        steps = [r for r in records if r["type"] == "step"]
        leaves = set(TELEMETRY_LEAVES)
        check(len(steps) == train["steps"] == 2 and all(
                  set(r["telemetry"]) == leaves
                  and len(r["telemetry"]["delta_flow_norm"])
                  == base.train.iters
                  and r["telemetry"]["nonfinite"] == 0 for r in steps),
              f"train observability: step events {steps}")
        kinds = collections.Counter(r["type"] for r in records)
        memory = [r for r in records if r["type"] == "device_memory"]
        tags = sorted(trainer.tb.history)
        check(kinds["recompile"] == 0 and len(memory) == 1
              and memory[0]["context"] == "train"
              and set(TB_TAGS) <= set(tags),
              f"train observability: recompiles {kinds['recompile']}, "
              f"memory samples {memory}, TensorBoard tags {tags}")
        with open(os.path.join(profile, "trace.json")) as f:
            trace = json.load(f)["traceEvents"]
        in_window = collections.Counter(
            kernel_of(e.get("name", "")) for e in trace
            if e.get("cat") == "kernel")
        windows = [r["action"] for r in records
                   if r["type"] == "trace_window"]
        check(in_window["fused_corr_lookup"]
              == base.train.iters * train["steps"]
              and windows == ["start", "stop"],
              f"train observability: kernel 1 ran "
              f"{in_window['fused_corr_lookup']} times in the profile_dir "
              f"window of {train['steps']} steps; windows {windows}")
        graphed = {k: steps[0]["telemetry"][k] for k in MONITORED}
        plain = [plain_monitors(state, trainer.cfg, trainer.schedule, first,
                                dev) for _ in range(2)]
        floor = {k: rel(plain[1][k], plain[0][k]) for k in MONITORED}
        err = {k: rel(graphed[k], plain[0][k]) for k in MONITORED}
        bar = {k: max(MONITOR_FLOOR_FACTOR * floor[k], MONITOR_MIN_BAR)
               for k in MONITORED}
        check(all(err[k] <= bar[k] for k in MONITORED),
              f"train observability: monitors of the kernel step {graphed} "
              f"against the plain step's {plain[0]}: relative {err}, bars "
              f"{bar}")
        out["armed_epoch"] = {
            "steps": train["steps"], "loss": train["loss"],
            "step_ms": train["step_ms"], "epoch_s": epoch_s,
            "val_epe3d": val["epe3d"], "events": dict(kinds),
            "first_step_telemetry": steps[0]["telemetry"],
            "kernel1_in_window": in_window["fused_corr_lookup"],
            "kernels_in_window": sum(v for k, v in in_window.items() if k),
            "trace_bytes": os.path.getsize(os.path.join(profile,
                                                        "trace.json")),
            "device_memory": memory[0]["devices"],
            "tensorboard": {"backend": trainer.tb.backend, "tags": tags},
            "monitors_vs_plain": {"graphed": graphed, "plain": plain,
                                  "floor_rel": floor, "err_rel": err,
                                  "bar_rel": bar}}
        del trace

        # (2) Epoch 1 with the flows scaled up: the loss spikes above the
        # window of epoch 0's two healthy steps.
        scale[0] = ZSCORE_FLOW_SCALE
        zs = trainer.training(1)
        trainer.close()
        trips = [r for r in read_events(events) if r["type"] == "divergence"]
        check(len(trips) >= 1 and trips[0]["reason"] == "zscore"
              and trips[0]["step"] == 3,
              f"train observability: the scaled epoch's trips {trips}")
        out["zscore"] = {"losses": zs["losses"], "trips": trips}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (3) A NaN point at 8,192 points through the kernels, halting.
        def poisoned(i, s):
            if i == 2:
                s["pc1"] = s["pc1"].copy()
                s["pc1"][0, :] = np.nan
            return s

        exp = os.path.join(root, "nan")
        with altered_training_set(poisoned):
            trainer = Trainer(config(exp, telemetry=True,
                                     halt_on_divergence=True),
                              device=dev, weights=state)
        want_step = 1 + [np.isnan(b["pc1"]).any() for b in
                         trainer.train_loader.epoch(0)].index(True)
        halted = None
        try:
            trainer.training(0)
        except DivergenceHalt as e:
            halted = str(e)
        torch.cuda.synchronize()
        trainer.close()
        records = read_events(os.path.join(exp, "train.events.jsonl"))
        kinds = [r["type"] for r in records]
        trip = next((r for r in records if r["type"] == "divergence"), {})
        snaps = sorted(os.listdir(os.path.join(exp, "snapshots")))
        check(halted is not None and trip.get("reason") == "nonfinite"
              and trip.get("step") == want_step and len(snaps) == 1
              and kinds.count("step") == want_step
              and "epoch_summary" not in kinds,
              f"train observability NaN: halted {halted!r}, trip {trip}, "
              f"expected at step {want_step}, snapshots {snaps}, events "
              f"{kinds}")
        report = os.path.join(root, "doctor.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pvraft_tpu_torch.doctor",
             os.path.join(exp, "snapshots", snaps[0]), "--json", report],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        doctor_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"doctor: rc {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        with open(report) as f:
            doc = json.load(f)
        check(doc["first_nonfinite_stage"] == "batch"
              and doc["device"].startswith("cuda"),
              f"doctor: first non-finite stage "
              f"{doc['first_nonfinite_stage']!r} on {doc['device']}")
        out["nan"] = {
            "trip": trip, "want_step": want_step, "halted": halted,
            "events": kinds, "doctor_s": doctor_s,
            "doctor": {r["stage"]: r["finite"] for r in doc["stages"]}}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (4) A default Trainer afterwards: the kernels of its step and of
        # the telemetry step, and a healthy epoch.
        trainer = Trainer(config(os.path.join(root, "after")), device=dev,
                          weights=state)
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
        off, off_total = kernel_totals(lambda: trainer.train_step(batch))
        after = trainer.training(0)
        trainer.close()
        check(all(np.isfinite(after["losses"])),
              f"train observability: the Trainer after the NaN run: "
              f"{after['losses']}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        armed = Trainer(config(os.path.join(root, "armed"), telemetry=True),
                        device=dev, weights=state)
        on, on_total = kernel_totals(
            lambda: armed.dispatch(armed.train_step, batch))
        armed.close()
        check(on == off, f"train observability: the telemetry step ran "
              f"{on} of the port's kernels, the default step {off}")
        out["launches"] = {"off": off, "on": on, "all_kernels_off": off_total,
                           "all_kernels_on": on_total,
                           "healthy_losses": after["losses"]}
        del armed, batch
        gc.collect()
        torch.cuda.empty_cache()

    # (5) The step profiler at the flagship.
    record = profile_step(ModelConfig(), points=8192, batch=2, iters=8,
                          reps=3, device=dev, variant="fp32", seed=seed)
    problems = validate_step_profile(record)
    fused = record["measurements"]["gru_fused"].get("launches", {})
    check(not problems and fused.get("fused_gru_update") == 8
          and record["platform"] == "gpu",
          f"step profiler: {problems}; gru_fused rung launches {fused}")
    out["step_profile"] = {"record": record,
                           "step_ms": 1e3 * record["total_step_s"]}
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------- phase 6 --

# name: ModelConfig keywords of an 8,192-point serve request that the tuned
# kernels do not take: the general lookup, and the general GRU update
# (hidden + context must stay 128, the context encoder's width).
# name -> the figure of PERF.md §6's Bound column (MB) its bytes give.
PERF_BOUND_MB = {"cuda_corr_lookup_fwd": "75.1", "cuda_voxel_corr_fwd": "69.8",
                 "cuda_gru_iter_bf16_fwd": "7.81",
                 "cuda_gru_iter_general_fwd": "7.69"}
# Counted on the CPU and on the card at "tiny" in the same process.
CROSS_DEVICE = ("serve_predict_bf16_b2048_bs1", "flagship_train_step_fp32")
# The only ops whose counts may differ there: Adam's, capturable on the
# card (its step and bias corrections on the device), on the host's
# clock on the CPU.
ADAM_OPS = re.compile(r"^(_foreach_\w+|_local_scalar_dense)$")
COST_REPS = 3                # each request (group) sent this many times
# The cost plane's Prometheus families (serve/metrics.py::_render_cost).
COST_FAMILIES = {"pvraft_serve_predicted_device_seconds_total",
                 "pvraft_serve_device_busy_seconds_total",
                 "pvraft_serve_replica_utilization",
                 "pvraft_serve_cost_predicted_seconds_total",
                 "pvraft_serve_cost_measured_seconds_total",
                 "pvraft_serve_cost_dispatches_total",
                 "pvraft_serve_cost_calibration_ratio"}


def kernel_spec_cost(spec):
    """The analytic cost (ops/kernel_bounds.py) of a ``kernel`` spec's one
    launch, from its geometry."""
    from pvraft_tpu_torch.ops.cuda.gru_iter import gru_cost

    kind, geo = next(iter(spec.geometry.items()))
    b, n = geo["b"], geo["n"]
    if kind == "lookup":
        return kernel_bounds.lookup_cost(b, n, geo["k"], geo["levels"],
                                         geo["resolution"], geo["knn"])
    if kind == "voxel":
        return kernel_bounds.voxel_cost(b, n, geo["k"], geo["levels"],
                                        geo["resolution"])
    return gru_cost(b, n, geo["hidden"], geo["context"], geo["corr"],
                    getattr(torch, geo["dtype"]))


def cross_device_counts(dev):
    """Each of CROSS_DEVICE counted at "tiny" on the CPU and on the card:
    flops, bytes and the ops whose (calls, bytes, flops) differ."""
    from pvraft_tpu_torch.programs import get
    from pvraft_tpu_torch.programs.costs import count_program

    out = {}
    for name in CROSS_DEVICE:
        rows = {}
        for where in ("cpu", dev):
            fn, inputs = get(name).build(where, "tiny")
            got = count_program(fn, inputs)
            rows[str(where)] = got
            del fn, inputs
        cpu, card = rows["cpu"], rows[str(dev)]
        ops = sorted(set(cpu["by_op"]) | set(card["by_op"]))
        out[name] = {
            "cpu": {"flops": cpu["flops"], "bytes": cpu["bytes_accessed"]},
            "gpu": {"flops": card["flops"], "bytes": card["bytes_accessed"]},
            "equal": (cpu["flops"], cpu["bytes_accessed"])
            == (card["flops"], card["bytes_accessed"]),
            "ops_differ": {op: {"cpu": cpu["by_op"].get(op),
                                "gpu": card["by_op"].get(op)}
                           for op in ops
                           if cpu["by_op"].get(op) != card["by_op"].get(op)}}
    return out


def cost_plane_phase(seed, dev, smi):
    """The cost plane and the program inventory (``cost_plane``; after
    phase 14, before the profiler phases). (1) The inventory: every spec
    of the catalog (``python -m pvraft_tpu_torch.programs list``) counted
    on the card at the flagship size (``programs/costs.py::run_costs``)
    into ``programs/costs.py::default_costs_path()``: every record ok,
    the port's validator and coverage check clean, each ``kernel``
    forward spec's bytes equal to its analytic bytes
    (``ops/kernel_bounds.py``) and those of PERF_BOUND_MB to PERF.md's
    Bound column; CROSS_DEVICE counted on the CPU and on the card in this
    process: the serve spec equal, the train step equal but for Adam's
    ops (ADAM_OPS), which are named. (2) Serving: ``ServeConfig()``
    behind ``build_service`` with the inventory as its cost surface and a
    ``ServeTelemetry`` stream; phase 2's requests over HTTP (each lone
    request and the concurrent group of four COST_REPS times): the
    stream validates, one valid ``cost_calibration`` per dispatch
    (platform gpu, comparable false), the ``/healthz`` ``cost`` rows
    count exactly the dispatches of each (bucket, batch), the seven cost
    families in the Prometheus exposition; the measured/predicted ratio
    per (bucket, batch, dtype). (3) Training: a Trainer on the flagship
    ``TrainConfig`` with the inventory trains one epoch of 2 steps: its
    ``epoch_summary`` carries the ``cost`` block (platform gpu, comparable
    false), ``step_ratio`` and ``hw_utilization``. (4) The replay harness
    (``analysis/determinism/replay.py``) at the flagship size: the train
    step and the serve dispatch bitwise across two builds from scratch."""
    from pvraft_tpu_torch.analysis.determinism.replay import replay_report
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.obs.events import read_events, validate_events_file
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.programs import load_catalog, specs
    from pvraft_tpu_torch.programs.costs import (check_coverage,
                                                 default_costs_path,
                                                 run_costs, validate_costs)
    from pvraft_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                        ServeTelemetry, build_service)
    from pvraft_tpu_torch.weights import seeded_state_dict

    out = {"gpu": smi}
    t_phase = time.perf_counter()
    # (1) The inventory.
    load_catalog()
    catalog = list(specs().values())
    t0 = time.perf_counter()
    doc = run_costs(catalog, dev, "flagship")
    out["inventory_s"] = time.perf_counter() - t0
    path = default_costs_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    failed = {r["name"]: r.get("error") for r in doc["programs"]
              if not r["ok"]}
    check(not failed, f"cost plane: records not ok: {failed}")
    problems = validate_costs(doc, path) + check_coverage(doc, catalog, path)
    check(not problems, f"cost plane: the inventory: {problems}")
    out["inventory"] = {
        "topology": doc["topology"], "hbm_limit_bytes": doc["hbm_limit_bytes"],
        "programs": {r["name"]: {
            "flops": r["flops"], "bytes": r["bytes_accessed"],
            "live_bytes": r["memory"]["live_bytes_estimate"],
            "max_memory_allocated": r["memory"].get("max_memory_allocated"),
            "kernel_launches": r["kernel_launches"], "count_s": r["count_s"]}
            for r in doc["programs"]}}
    kernels = {}
    for spec in catalog:
        if "kernel" not in spec.tags or not spec.name.endswith("_fwd"):
            continue
        cost = kernel_spec_cost(spec)
        got = out["inventory"]["programs"][spec.name]["bytes"]
        check(got == cost.bytes, f"cost plane: {spec.name} counts {got} "
              f"bytes, its kernel's analytic bytes are {cost.bytes}")
        kernels[spec.name] = {"bytes": got, "flops": cost.flops,
                              "analytic_bytes": cost.bytes,
                              **kernel_bounds.cost_bound(cost)}
    for name, mb in PERF_BOUND_MB.items():
        digits = len(mb.split(".")[1])
        got = f"{kernels[name]['bytes'] / 1e6:.{digits}f}"
        check(got == mb, f"cost plane: {name} {got} MB, PERF.md's Bound "
              f"column {mb} MB")
    out["kernels"] = kernels
    cross = out["cross_device"] = cross_device_counts(dev)
    serve_spec, train_spec = CROSS_DEVICE
    check(cross[serve_spec]["equal"], f"cost plane: {serve_spec} counts "
          f"differ between the CPU and the card: {cross[serve_spec]}")
    odd = [op for op in cross[train_spec]["ops_differ"]
           if not ADAM_OPS.match(op)]
    check(cross[train_spec]["cpu"]["flops"]
          == cross[train_spec]["gpu"]["flops"] and not odd,
          f"cost plane: {train_spec} differs between the CPU and the card "
          f"beyond Adam's ops: {odd}, {cross[train_spec]}")
    # (2) Serving with the surface armed.
    cfg = ServeConfig()
    requests = serve_requests(np.random.default_rng(seed + 1))
    with scratch_dir() as root:
        events = os.path.join(root, "serve.events.jsonl")
        tel = ServeTelemetry(events, cfg=cfg)
        engine = InferenceEngine(seeded_state_dict(cfg.model, seed), cfg,
                                 device=dev, telemetry=tel)
        server = build_service(engine, telemetry=tel, cost_surface=path,
                               devmem_interval_s=0)
        server.start()
        try:
            for _ in range(COST_REPS):
                for kind, group, bucket in requests:
                    got = concurrently([
                        (lambda r=r: http_predict(server.port, *r, True))
                        for r in group])
                    check(all(s == 200 for s, _, _ in got),
                          f"cost plane: /predict {[s for s, _, _ in got]}")
            health = http_json(server.port, "/healthz")
            status, prom, _ = http_call(server.port, "GET",
                                        "/metrics?format=prometheus")
            metrics = http_json(server.port, "/metrics")
        finally:
            server.shutdown(drain=True)
            tel.close()
        check(not validate_events_file(events),
              f"cost plane: {validate_events_file(events)[:5]}")
        records = read_events(events)
    batches = collections.Counter((r["bucket"], r["batch"]) for r in records
                                  if r["type"] == "serve_batch")
    calib = [r for r in records if r["type"] == "cost_calibration"]
    check(len(calib) == sum(batches.values()) == metrics["batches_total"],
          f"cost plane: {len(calib)} cost_calibration events, "
          f"{sum(batches.values())} serve_batch, "
          f"{metrics['batches_total']} batches")
    check(all(r["platform"] == "gpu" and r["comparable"] is False
              and r["basis"] == "roofline" for r in calib),
          "cost plane: a cost_calibration off platform gpu or comparable")
    rows = {(r["bucket"], r["batch"]): r for r in health["cost"]["calibration"]}
    check({k: r["n"] for k, r in rows.items()} == dict(batches),
          f"cost plane: /healthz cost rows {sorted(rows)} count "
          f"{[r['n'] for r in rows.values()]}, dispatches {dict(batches)}")
    families = set(re.findall(r"^# TYPE (\S+) ", prom.decode(), re.M))
    missing = COST_FAMILIES - families
    check(status == 200 and not missing,
          f"cost plane: families missing {sorted(missing)}")
    out["serve"] = {
        "cost_surface": health["cost_surface"],
        "utilization": health["cost"]["utilization"],
        "calibration": [
            {k: r[k] for k in ("bucket", "batch", "dtype", "n", "predicted_s",
                               "measured_s", "ratio", "extrapolated")}
            for r in health["cost"]["calibration"]]}
    # (3) Training with the surface.
    with scratch_dir() as root:
        tcfg = flagship_train_config(seed).replace(exp_path=root)
        trainer = Trainer(tcfg, device=dev, cost_surface=path)
        try:
            trainer.training(0)
        finally:
            trainer.close()
        stream = os.path.join(root, "train.events.jsonl")
        check(not validate_events_file(stream),
              f"cost plane: {validate_events_file(stream)[:5]}")
        summary = [r for r in read_events(stream)
                   if r["type"] == "epoch_summary"]
    cost = summary[-1].get("cost") if summary else None
    check(cost is not None and cost["platform"] == "gpu"
          and cost["comparable"] is False,
          f"cost plane: the epoch_summary's cost block: {cost}")
    out["train"] = {"steps": summary[-1]["steps"],
                    "step_ms": summary[-1]["step_ms"], "cost": cost}
    # (4) The replay harness.
    t0 = time.perf_counter()
    report = replay_report(dev, "flagship")
    out["replay_s"] = time.perf_counter() - t0
    out["replay"] = {e["name"]: {k: e[k] for k in (
        "bitwise_identical", "n_output_leaves", "digest")}
        | ({"first_difference": e["first_difference"]}
           if "first_difference" in e else {})
        for e in report["programs"]}
    check(report["verdict"] == "bitwise",
          f"cost plane: the replay is {report['verdict']}: {out['replay']}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -------------------------------------------------------------- phase 16 --

PARALLEL_STEPS = 3           # compared train steps of each leg
GLOO_STEPS = 5               # eager steps of leg (b): 3 compared, all timed
PARALLEL_LEG_S = 420.0       # bound on each leg's process
EVAL_BATCH = 4               # leg (c): scenes a step
EVAL_SCENE_TOL = 1e-5        # leg (c): per-scene EPE, eval_batch 4 against 1,
                             # at 1 iteration
PARALLEL_LOSS_REL = 1e-4     # leg (b): losses against one process
# Leg (b)'s step-1 gradients against one process at batch 4, worst leaf
# ||g - g_ref|| / ||g_ref|| (4.5e-2 in two runs on the H100: the batch
# size changes GroupNorm's summation order, leg (c)).
BATCH4_GRAD_REL = 0.1
# NCCL's reduction kernels: the ring/tree AllReduce, and the one-rank
# premultiplied sum that an average over one rank launches.
ALLREDUCE_KERNEL = re.compile(r"AllReduce|oneRankReduce")


def replay_kernels(fn):
    """``fn()`` under the profiler (``device_kernels``): per wrapper the
    kernels of ``KERNEL_SYMBOLS`` the card ran (replays included), and
    the NCCL reduction kernels by name."""
    from pvraft_tpu_torch.ops import cuda as kernels

    counts = dict(NO_LAUNCHES)
    reduce = collections.Counter()
    _, names = kernels.device_kernels(fn)
    for name in names:
        wrapper = kernels.kernel_of(name)
        if wrapper is not None:
            counts[wrapper] += 1
        elif ALLREDUCE_KERNEL.search(name):
            reduce[name] += 1
    return counts, dict(reduce)


def param_digest(model) -> str:
    """sha256 of every parameter's bytes, in order."""
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def epoch_batches(loader, n, dev):
    """The first batch of each of epochs 0 .. n-1, on the card."""
    from pvraft_tpu_torch.data import to_device

    out = []
    for epoch in range(n):
        it = loader.epoch(epoch)
        try:
            out.append(to_device(next(it), dev))
        finally:
            it.close()
    return out


def compared_steps(trainer, batches):
    """Loss, EPE and the parameters' digest after each step."""
    out = []
    for b in batches:
        m = trainer.train_step(b)
        out.append((float(m["loss"]), float(m["epe"]),
                    param_digest(trainer.model)))
    return out


def eager_steps(trainer, batches):
    """The eager steps of leg (b): each step's loss, EPE, host ms
    (synchronised) and parameter digest, the gradients after step 1 (on
    the host), the wrapper launches per step and the peak GB. The first
    ``PARALLEL_STEPS`` steps, the compared ones, run under
    ``deterministic()``; the rest as in training (the timed ones)."""
    losses, epes, ms, digests = [], [], [], []
    grads = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with (deterministic() if i < PARALLEL_STEPS
              else contextlib.nullcontext()):
            m = trainer.train_step(b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        epes.append(float(m["epe"]))
        digests.append(param_digest(trainer.model))
        if i == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in trainer.model.named_parameters()}
    counts = read_counts()
    return {"losses": losses, "epes": epes, "ms": ms, "digests": digests,
            "grads": grads,
            "launches_per_step": {k: v / len(batches)
                                  for k, v in counts.items()},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def batch_first_difference(model, batch, iters=1):
    """The first submodule call (in the order calls finish) whose output
    for scene 0 differs between ``model`` run on the whole ``batch`` and
    on scene 0 alone, eagerly, without gradients: ``{"module", "call",
    "shape", "max_abs_diff"}``, or None."""
    def run(b):
        records, calls = [], collections.Counter()

        def hook_for(name):
            def hook(_mod, _args, out):
                calls[name] += 1
                outs = out if isinstance(out, (tuple, list)) else (out,)
                records.append(((name, calls[name]), [
                    t.detach().clone() for t in outs if torch.is_tensor(t)]))
            return hook

        handles = [m.register_forward_hook(hook_for(n))
                   for n, m in model.named_modules() if n]
        try:
            with torch.no_grad():
                model(b["pc1"], b["pc2"], iters)
        finally:
            for h in handles:
                h.remove()
        return records

    n = batch["pc1"].shape[0]
    alone = dict(run({k: v[:1] for k, v in batch.items()}))
    for key, tensors in run(batch):
        for a, b in zip(tensors, alone.get(key, ())):
            if a.dim() and a.shape[0] == n and b.shape[0] == 1:
                a = a[:1]
            if a.shape == b.shape and not torch.equal(a, b):
                return {"module": key[0], "call": key[1],
                        "shape": list(a.shape),
                        "max_abs_diff": float((a.double() - b.double())
                                              .abs().max())}
    return None


def eval_batch_pair(cfg, dev, root):
    """The graphed Evaluator at ``eval_batch`` 1 and :data:`EVAL_BATCH` on
    ``cfg``'s test scenes: each one's means and ms a scene, the per-scene
    EPE of the first batch from both, and their largest difference."""
    from pvraft_tpu_torch.data import first_batch, to_device
    from pvraft_tpu_torch.engine.evaluator import Evaluator

    evs, out = {}, {}
    for eb in (1, EVAL_BATCH):
        ev = Evaluator(cfg.replace(
            train=dataclasses.replace(cfg.train, eval_batch=eb),
            exp_path=os.path.join(root, f"eval_batch{eb}")), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means = ev.run()
        torch.cuda.synchronize()
        out[f"eval_batch{eb}"] = {
            "means": means, "programs": ev.compile_report(),
            "ms_per_scene": 1e3 * (time.perf_counter() - t0)
            / len(ev.dataset)}
        evs[eb] = ev
    batch = to_device(first_batch(evs[EVAL_BATCH].loader), dev)
    four = evs[EVAL_BATCH].eval_step(batch)[0]["epe3d"].clone()
    one = torch.stack([evs[1].eval_step({k: v[b:b + 1] for k, v in
                                         batch.items()})[0]["epe3d"][0].clone()
                       for b in range(four.shape[0])])
    out.update({"epe_batch1": one.tolist(), "epe_batch4": four.tolist(),
                "per_scene_max_abs_err": float((four - one).abs().max()),
                "means_max_abs_err": max(
                    abs(out[f"eval_batch{EVAL_BATCH}"]["means"][k] - v)
                    for k, v in out["eval_batch1"]["means"].items()),
                "scenes": int(four.shape[0]), "model": evs[1].model})
    for ev in evs.values():
        ev.close()
    return out, batch


def accumulated_steps(trainer, batches, parts=2):
    """The twin of ``parts`` data-parallel ranks in one process: each
    step splits its batch into ``parts`` equal slices (the ranks' blocks,
    ``PrefetchLoader(shard=...)``), sums their backward passes' gradients
    into ``.grad`` in rank order, scales them by 1 / ``parts``, and takes
    ``trainer``'s eager Adam step at its schedule; the loss and EPE are
    the slices' means. Returns what :func:`eager_steps` does, gradients
    after step 1 and digests included."""
    from pvraft_tpu_torch.engine.metrics import epe_train
    from pvraft_tpu_torch.engine.steps import sequence_loss_of, set_lr

    t, model, opt = trainer.cfg.train, trainer.model, trainer.optimizer
    losses, epes, digests, grads = [], [], [], None
    for i, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        set_lr(opt, trainer.schedule(i))
        loss = epe = 0.0
        n = batch["pc1"].shape[0] // parts
        for j in range(parts):
            part = {k: v[j * n:(j + 1) * n] for k, v in batch.items()}
            lj, flows = sequence_loss_of(model, part, t.gamma, t.iters)
            lj.backward()
            with torch.no_grad():
                loss = loss + lj.detach()
                epe = epe + epe_train(flows[-1], part["mask"], part["flow"])
        with torch.no_grad():
            for p in model.parameters():
                p.grad.mul_(1.0 / parts)
        opt.step()
        losses.append(float(loss * (1.0 / parts)))
        epes.append(float(epe * (1.0 / parts)))
        digests.append(param_digest(model))
        if i == 0:
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()}
    return {"losses": losses, "epes": epes, "digests": digests,
            "grads": grads}


def eval_batch_leg(seed, dev, root):
    """Leg (c): the graphed Evaluator at ``eval_batch`` 4 against 1 on the
    flagship's 4 synthetic test scenes. At 1 iteration the per-scene EPE
    and the means agree within :data:`EVAL_SCENE_TOL`; at the default 32
    they are recorded: the first op whose result depends on the batch
    size (found eagerly, at 1 iteration) starts a summation-order
    difference that an untrained model's diverging iterations grow."""
    from pvraft_tpu_torch.profile_train import flagship_train_config

    cfg = flagship_train_config(seed)
    out = {}
    for iters in (1, cfg.train.eval_iters):
        pair, batch = eval_batch_pair(cfg.replace(train=dataclasses.replace(
            cfg.train, eval_iters=iters)), dev, root)
        model = pair.pop("model")
        if iters == 1:
            check(pair["scenes"] == EVAL_BATCH
                  and pair["per_scene_max_abs_err"] <= EVAL_SCENE_TOL
                  and pair["means_max_abs_err"] <= EVAL_SCENE_TOL,
                  f"eval_batch {EVAL_BATCH} against 1, 1 iteration: "
                  f"per-scene EPE {pair['epe_batch4']} / "
                  f"{pair['epe_batch1']} (bar {EVAL_SCENE_TOL})")
            out["first_difference"] = batch_first_difference(model, batch)
        else:
            check(all(np.isfinite(pair["epe_batch4"] + pair["epe_batch1"])),
                  f"eval_batch at {iters} iterations: {pair}")
        out[f"iters{iters}"] = pair
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def parallel_leg_one(seed, port, path):
    """Legs (c) and (a), and the one-process reference of leg (b), in one
    process of their own: (c) the Evaluator; (a) the flagship graphed
    Trainer without a process group, then in an NCCL group of one rank
    (``initialize``): captured under ``deterministic()``, 3 steps bitwise
    equal, then one replay of each under the profiler; one replayed
    ``fused_gru`` step in the group. Then the group is left and the
    reference of (b) runs: the eager Trainer at batch 4."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import initialize, shutdown
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.weights import seeded_state_dict

    dev = torch.device("cuda")
    state = seeded_state_dict(ModelConfig(), seed)
    out = {}

    def release(*trainers):
        for t in trainers:
            t.close()
        gc.collect()
        torch.cuda.empty_cache()

    with scratch_dir() as root:
        out["evaluator"] = eval_batch_leg(seed, dev, root)
        release()
        cfg = flagship_train_config(seed)

        def trainer(name, cfg=cfg):
            # Leg (a) compares train steps: the eval step each Trainer
            # captures too runs 1 iteration, to keep the captures short.
            return Trainer(cfg.replace(
                train=dataclasses.replace(cfg.train, eval_iters=1),
                exp_path=os.path.join(root, name)), device=dev,
                weights=state)

        # The groupless trainer is built before the group exists: a step
        # reduces over the process group there is when it is made.
        with deterministic():
            plain = trainer("plain")
            batches = epoch_batches(plain.train_loader, PARALLEL_STEPS, dev)
            plain_steps = compared_steps(plain, batches)
        check(plain.train_step.reduce is None,
              "leg (a): the groupless step reduces")
        initialize(f"localhost:{port}", num_processes=1, process_id=0,
                   backend="nccl", local_rank=0)
        with deterministic():
            nccl = trainer("nccl")
            reduce = nccl.train_step.reduce
            check(reduce is not None and reduce.average
                  and reduce.world == 1,
                  "leg (a): the step in an NCCL group of one rank does not "
                  "average over it")
            nccl_steps = compared_steps(nccl, batches)
        check(nccl_steps == plain_steps,
              f"leg (a): NCCL world 1 against no group, 3 steps: "
              f"{nccl_steps} / {plain_steps}")
        del reduce
        counts, kernels_reduce = replay_kernels(
            lambda: nccl.train_step(batches[0]))
        plain_counts, plain_reduce = replay_kernels(
            lambda: plain.train_step(batches[0]))
        check(counts["fused_corr_lookup"] == cfg.train.iters
              and sum(kernels_reduce.values()) == 1 and not plain_reduce
              and plain_counts == counts,
              f"leg (a): one replay ran {counts} and reductions "
              f"{kernels_reduce} (groupless: {plain_counts}, "
              f"{plain_reduce})")
        programs = nccl.compile_report()[:1]
        plain_programs = plain.compile_report()[:1]
        release(plain, nccl)
        del plain, nccl
        # Kernel 2 beside the collective: one fused_gru step, replayed.
        fused = trainer("nccl_fused_gru",
                        flagship_train_config(seed, fused_gru=True))
        first = fused.train_step(batches[0])
        fused_counts, fused_reduce = replay_kernels(
            lambda: fused.train_step(batches[0]))
        check(fused.train_step.reduce is not None
              and fused_counts["fused_corr_lookup"] == cfg.train.iters
              and fused_counts["fused_gru_update"] == cfg.train.iters
              and sum(fused_reduce.values()) == 1
              and np.isfinite(float(first["loss"])),
              f"leg (a): the fused_gru step in the group ran "
              f"{fused_counts} and reductions {fused_reduce}, loss "
              f"{float(first['loss'])}")
        release(fused)
        del fused
        out["nccl_world1"] = {
            "steps": nccl_steps, "bitwise": True,
            "launches_per_step": counts, "allreduce_kernels": kernels_reduce,
            "groupless_launches_per_step": plain_counts,
            "fused_gru_launches_per_step": fused_counts,
            "fused_gru_allreduce_kernels": fused_reduce,
            "fused_gru_loss": float(first["loss"]),
            "programs": programs, "groupless_programs": plain_programs,
            "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
            "mode": "deterministic() captures, compared bitwise and "
                    "replayed"}
        shutdown()
        # The reference at batch 4, and the two ranks' twin in this
        # process (under deterministic(), as the ranks' compared steps).
        for name in ("batch4", "accumulated"):
            ref = Trainer(cfg.replace(
                train=dataclasses.replace(cfg.train, batch_size=4),
                exp_path=os.path.join(root, name)), device=dev,
                weights=state, graphs=False)
            batches = epoch_batches(ref.train_loader, GLOO_STEPS, dev)
            if name == "accumulated":
                with deterministic():
                    out[name] = accumulated_steps(
                        ref, batches[:PARALLEL_STEPS])
            else:
                out[name] = eager_steps(ref, batches)
            ref.close()
            del ref, batches
            gc.collect()
            torch.cuda.empty_cache()
    torch.save(out, path)


def parallel_leg_rank(seed, rank, world, port, path):
    """Leg (b), one rank: the flagship eager Trainer at per-device batch
    2 in a gloo group of ``world`` ranks on the one card."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import initialize, shutdown
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.weights import seeded_state_dict

    dev = torch.device("cuda")
    initialize(f"localhost:{port}", num_processes=world, process_id=rank,
               backend="gloo", local_rank=0)
    try:
        with scratch_dir() as root:
            cfg = flagship_train_config(seed).replace(
                exp_path=os.path.join(root, f"rank{rank}"))
            trainer = Trainer(cfg, device=dev, graphs=False,
                              weights=seeded_state_dict(ModelConfig(), seed))
            check(trainer.train_step.reduce is not None
                  and not trainer.train_step.reduce.average
                  and trainer.train_loader.shard == (rank, world),
                  "leg (b): the rank's step or loader is not sharded")
            out = eager_steps(trainer, epoch_batches(trainer.train_loader,
                                                     GLOO_STEPS, dev))
            trainer.close()
        torch.save(out, path)
    finally:
        shutdown()


def run_legs(legs, logs):
    """Start every ``(name, argv)`` leg (this script with ``--leg``)
    together, wait for them (``PARALLEL_LEG_S`` each at most; a hung one
    is killed) and raise with a leg's last output lines if it failed."""
    import subprocess

    procs = []
    for name, argv in legs:
        log = open(os.path.join(logs, f"{name}.log"), "w")
        procs.append((name, log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv],
            stdout=log, stderr=subprocess.STDOUT)))
    deadline = time.monotonic() + PARALLEL_LEG_S
    try:
        for _, _, p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for name, _, p in procs:
        if p.returncode != 0:
            with open(os.path.join(logs, f"{name}.log")) as fh:
                tail = fh.read()[-4000:]
            raise RuntimeError(f"parallel leg {name} exited {p.returncode}:"
                               f"\n{tail}")


def parallel_phase(seed):
    """Phase 16 (``parallel``; after phase 15, before the profiler phases):
    data parallelism over ``torch.distributed``, each leg in a process of
    its own so that no process group outlives it. (a) The flagship graphed
    Trainer in an NCCL group of one rank against no group: 3 steps
    bitwise (``deterministic()`` captures), then one NCCL reduction
    kernel and 8 kernel-1 launches a replayed step of those captures, and
    a ``fused_gru`` step with 8 kernel-2 launches beside the reduction. (b) Two gloo ranks on the one card, eager, at
    per-device batch 2, against one process at batch 4 (step 1's loss
    within ``PARALLEL_LOSS_REL``, its gradients under ``GRAD_BOUNDS``, 8
    iterations, and ``BATCH4_GRAD_REL`` on the worst leaf) and against their twin in one process
    (:func:`accumulated_steps`: the compared steps of both under
    ``deterministic()``, 3 steps' losses, step 1's gradients and the
    parameters after each step bitwise), the ranks' parameters bitwise
    equal after every step, ms a step (the steps after the compared
    ones) and peak GB per rank.
    (c) The graphed Evaluator at ``eval_batch`` 4 against 1: per-scene
    EPE within 1e-5 at 1 iteration, recorded at 32
    (``eval_batch_leg``)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with scratch_dir() as root:
        one = os.path.join(root, "one.pt")
        run_legs([("one", ["--leg", "one", "--seed", str(seed),
                           "--port", str(free_port()), "--out", one])], root)
        port = str(free_port())
        ranks = [os.path.join(root, f"rank{r}.pt") for r in range(2)]
        run_legs([(f"rank{r}", ["--leg", "rank", "--seed", str(seed),
                                "--rank", str(r), "--world", "2",
                                "--port", port, "--out", ranks[r]])
                  for r in range(2)], root)
        out = torch.load(one, weights_only=False)
        ranks = [torch.load(p, weights_only=False) for p in ranks]
    ref, twin = out.pop("batch4"), out.pop("accumulated")
    check(ranks[0]["digests"] == ranks[1]["digests"]
          and ranks[0]["losses"] == ranks[1]["losses"],
          "leg (b): the two ranks' parameters or losses differ")
    # Against one process at batch 4: step 1's loss and gradients. The
    # forward at per-device batch 2 sums in other orders than at batch 4
    # (GroupNorm's reduction depends on the batch, leg (c)), 8 iterations
    # of an untrained model grow that, and so do Adam's first updates
    # (~lr x sign(g)): the later steps' losses are recorded.
    rel = [abs(x - y) / abs(y) for x, y in zip(
        ranks[0]["losses"][:PARALLEL_STEPS], ref["losses"])]
    check(rel[0] <= PARALLEL_LOSS_REL,
          f"leg (b): step-1 loss {ranks[0]['losses'][0]} against one "
          f"process {ref['losses'][0]} (relative {rel[0]})")
    grads = grad_agreement((ranks[0]["losses"][0], ranks[0]["grads"]),
                           (ref["losses"][0], ref["grads"]))
    bar = dict(GRAD_BOUNDS["iters8"], max_rel=BATCH4_GRAD_REL)
    check(grads["loss_rel"] <= bar["loss_rel"]
          and grads["min_cos"] >= bar["min_cos"]
          and grads["max_rel"] <= bar["max_rel"],
          f"leg (b): step-1 gradients against one process: {grads} "
          f"(bars {bar})")
    # Against the ranks' twin in one process (the same slices, their
    # gradients summed in rank order and halved, both under
    # deterministic()): the collective must do exactly what the twin
    # does, so every compared step's loss, step 1's gradients and the
    # parameters after each step are equal to the bit. A reduction that
    # sums without scaling, or mixes the buckets, fails here.
    twin_grads = grad_agreement((ranks[0]["losses"][0], ranks[0]["grads"]),
                                (twin["losses"][0], twin["grads"]))
    bitwise_twin = {
        "losses": ranks[0]["losses"][:PARALLEL_STEPS] == twin["losses"],
        "grads_step1": all(torch.equal(ranks[0]["grads"][k], g)
                           for k, g in twin["grads"].items()),
        "params": ranks[0]["digests"][:PARALLEL_STEPS] == twin["digests"]}
    check(all(bitwise_twin.values()),
          f"leg (b): against the ranks' twin {bitwise_twin}: losses "
          f"{ranks[0]['losses'][:PARALLEL_STEPS]} / {twin['losses']}, "
          f"step-1 gradients {twin_grads}")
    for r in ranks:
        check(r["launches_per_step"]["fused_corr_lookup"] == 8,
              f"leg (b): a rank's eager step launched "
              f"{r['launches_per_step']}")
    for r in (*ranks, ref, twin):
        del r["grads"], r["digests"]
    out["gloo_two_ranks"] = {
        "ranks": ranks, "batch4": ref, "accumulated": twin,
        "loss_rel": rel, "grads": grads, "grads_accumulated": twin_grads,
        "bitwise_accumulated": bitwise_twin, "bitwise_ranks": True,
        "bounds": bar, "mode": f"steps 1-{PARALLEL_STEPS} under "
        f"deterministic(), the rest as in training"}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -------------------------------------------------------------- phase 17 --

SEQ_WORLD = 2                # ranks of the seq group (one card, gloo)
SEQ_STEPS = 3                # compared eager train steps, on one batch
SEQ_TIMED = 2                # timed eager steps after them
SEQ_LOSS_REL = 1e-6          # (b) the 1-iteration step's loss
SEQ_EVAL_TOL = 1e-5          # (c) per-scene EPE at 1 iteration
# (a) the flagship parity leg's bars (tests/test_torch_flagship_parity.py):
# a point no flip reaches within atol 5e-4 / rtol 1e-3; flips below 2% of
# the points, each a near-tie (gap below 1e-3); points beyond the bar
# below 2%.
SEQ_FLOW_ATOL, SEQ_FLOW_RTOL = 5e-4, 1e-3
SEQ_TIE_GAP, SEQ_RARE = 1e-3, 0.02
# (a) a kNN graph flip (a point whose 32 neighbours differ between the
# ring and the dense build) is a near-tie when its 32nd and 33rd squared
# distances lie within this (~100 float32 ulps of the O(1) terms whose
# cancellation gives them).
SEQ_KNN_GAP = 1e-5
# (a) 8 untrained iterations amplify any float32 difference chaotically
# (measured on one H100: features 9e-6 apart part the flows by up to 0.58).
# There the sharded flows are held to the one-process model's own floor,
# the same model on the same graphs with its input clouds moved by one
# ulp (seq_floor): their median error within SEQ_FLOOR_FACTOR of the
# floor's (the sharded features start up to ~10x further apart than such
# a move leaves them).
SEQ_FLOOR_FACTOR = 10.0
# (d) the refine leg: eager refine steps at 8 iterations timed on each
# rank, after one untimed; its model runs fused_gru, so that both kernels
# run in the sharded backbone.
SEQ_REFINE_TIMED = 2
SEQ_REFINE_MODEL = {"fused_gru": True}


def seq_cfg(seed, seq):
    """Phase 17's flagship training config: ``seq_shard`` on a seq axis of
    :data:`SEQ_WORLD` for the ranks (``seq``), off for the one-process
    reference."""
    from pvraft_tpu_torch.config import ParallelConfig
    from pvraft_tpu_torch.profile_train import flagship_train_config

    return flagship_train_config(
        seed, parallel=ParallelConfig(seq_axis=SEQ_WORLD if seq else 1),
        seq_shard=seq)


def recording(encoder, fmaps, graphs):
    """A forward hook on ``encoder`` (a PointEncoder) that appends each
    call's features and graph indices to ``fmaps`` and ``graphs`` (on the
    host)."""
    def hook(_m, _a, out):
        fmaps.append(out[0].detach().cpu())
        graphs.append(out[1].neighbors.detach().cpu())

    return encoder.register_forward_hook(hook)


@contextlib.contextmanager
def given_graphs(encoder, neighbors):
    """``encoder`` (a PointEncoder) takes the kNN graphs ``neighbors``
    (global indices, in turn, cycling) where it would build its own: the
    one-process reference on the ranks' graphs, so that a graph flip at a
    near-tie (named by :func:`graph_flips`) moves neither side's
    features."""
    import itertools

    from pvraft_tpu_torch.ops.geometry import Graph, gather_neighbors

    turn = itertools.cycle(neighbors)
    own = encoder.forward

    def forward(pc, graph=None, mask=None):
        if graph is None:
            idx = next(turn).to(pc.device)
            graph = Graph(idx, gather_neighbors(pc, idx) - pc[:, :, None, :])
        return own(pc, graph, mask)

    encoder.forward = forward
    try:
        yield
    finally:
        del encoder.forward


@contextlib.contextmanager
def given_truncation(model, keep):
    """``model`` (a PVRaft) keeps the candidates ``keep`` (B, N, K) global
    indices into pc2, the ranks' ring truncation, in place of its own
    top-K: the values are its own products at those indices, so its
    gradients flow as its truncation's would. (b)'s reference runs so,
    and a truncation flip at a near-tie (named in (a)) moves neither
    side's gradients."""
    from pvraft_tpu_torch.ops.corr import CorrState, corr_volume
    from pvraft_tpu_torch.ops.geometry import gather_neighbors

    def corr_init(fmap1, fmap2, xyz2, valid2=None):
        idx = keep.to(fmap1.device)
        corr = torch.gather(corr_volume(fmap1, fmap2), -1, idx)
        return CorrState(corr=corr, xyz=gather_neighbors(xyz2, idx))

    model._corr_init = corr_init
    try:
        yield
    finally:
        del model._corr_init


def seq_forward(model, batch):
    """The flows at 1 and 8 iterations, both clouds' features and graph
    indices (pc1's, then pc2's), without gradients."""
    fmaps, graphs = [], []
    handle = recording(model.feature_extractor, fmaps, graphs)
    out = {}
    try:
        with torch.no_grad():
            for iters in (1, 8):
                flows, _ = model(batch["pc1"], batch["pc2"], iters)
                out[f"flows{iters}"] = flows[-1].cpu()
    finally:
        handle.remove()
    out["fmap1"], out["fmap2"] = fmaps[:2]
    out["graph1"], out["graph2"] = graphs[:2]
    return out


def seq_probe(model, batch, gamma):
    """(b)'s step at 1 iteration, under ``deterministic()``, on an SGD at
    rate 0 (the parameters do not move; the step reduces its gradients
    as any train step of ``model`` does): its loss and gradients."""
    from pvraft_tpu_torch.engine.steps import make_train_step

    step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                  lr=0.0),
                           lambda _: 0.0, gamma, 1)
    with deterministic():
        loss = float(step(batch)["loss"])
    return loss, {n: p.grad.detach().cpu().clone()
                  for n, p in model.named_parameters()}


def seq_steps(trainer, batch, window):
    """(b)'s eager steps on one batch: first :func:`seq_probe`'s step at
    1 iteration, then :data:`SEQ_STEPS` under
    ``deterministic()`` (each one's loss, step 1's gradients) and
    :data:`SEQ_TIMED` as in training (ms each, synchronised), the
    wrapper launches and the seq axis's collectives a step, the peak GB;
    then ``window(step)``'s profiler count of one more step."""
    from pvraft_tpu_torch.parallel import collectives

    probe = seq_probe(trainer.model, batch, trainer.cfg.train.gamma)
    losses, ms, grads = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.CALLS.clear()
    for i in range(SEQ_STEPS + SEQ_TIMED):
        t0 = time.perf_counter()
        with (deterministic() if i < SEQ_STEPS
              else contextlib.nullcontext()):
            m = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in trainer.model.named_parameters()}
    n = SEQ_STEPS + SEQ_TIMED
    out = {"losses": losses, "ms": ms, "grads": grads, "probe": probe,
           "launches_per_step": {k: v / n for k, v in read_counts().items()},
           "collectives_per_step": {k: v / n for k, v in
                                    collectives.CALLS.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["window"] = window(lambda: trainer.train_step(batch))
    return out


def encoder_of(model):
    """The feature encoder of a PVRaft, or of a PVRaftRefine's backbone."""
    return getattr(model, "backbone", model).feature_extractor


def seq_eval(ev):
    """The Evaluator's per-scene EPE (this rank's shares on a rank) over
    its scenes in order, the graphs it used (pc1's and pc2's of each
    scene), and its means."""
    per, graphs = [], []
    handle = recording(encoder_of(ev.model), [], graphs)
    try:
        for host in ev.loader.epoch(0):
            per += ev.eval_step(ev._put(host))[0]["epe3d"].tolist()
    finally:
        handle.remove()
    return {"epe": per, "graphs": graphs, "means": ev.run()}


def group_window(mesh, dev):
    """A profiler window (``ops/cuda.device_kernels``) that the ranks of a
    group take together: ``fn`` runs in the first window only, and where
    any rank's profiler lost records and ran its window again (with no
    work in it), every rank takes another, up to three times. Returns
    (the kernels per wrapper, the windows taken)."""
    from pvraft_tpu_torch.ops import cuda as kernels
    from pvraft_tpu_torch.parallel.mesh import all_true

    def window(fn):
        for attempt in range(1, 4):
            ran = []

            def once():
                if not ran:
                    ran.append(fn())

            before = kernels.window_counts["run_again"]
            _, names = kernels.device_kernels(once)
            if all_true(kernels.window_counts["run_again"] == before, mesh,
                        dev):
                counts = dict(NO_LAUNCHES)
                for name in names:
                    wrapper = kernels.kernel_of(name)
                    if wrapper is not None:
                        counts[wrapper] += 1
                return {"launches": counts, "windows": attempt}
        raise RuntimeError("the ranks' profiler windows lost records three "
                           "times")

    return window


def seq_refine_cfg(seed, seq):
    """(d)'s config: :func:`seq_cfg`'s with ``train.refine`` (8
    iterations) and :data:`SEQ_REFINE_MODEL`."""
    cfg = seq_cfg(seed, seq)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **SEQ_REFINE_MODEL),
        train=dataclasses.replace(cfg.train, refine=True))


def seq_refine_state(seed, cfg):
    """(d)'s weights: the stage-1 legs' seeded backbone (``seed``) under a
    head of its own seed."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(cfg.model, seed + 1, refine=True)
    state.update({f"backbone.{k}": v for k, v in
                  seeded_state_dict(ModelConfig(), seed).items()})
    return state


def refine_probe(model, batch):
    """(d)'s refine step at 1 iteration under ``deterministic()``, on an
    SGD at rate 0 over the head (the step reduces the head's gradients as
    any refine step of ``model`` does): its loss, the head's gradients,
    and the backbone leaves that got one."""
    from pvraft_tpu_torch.engine.steps import make_refine_train_step
    from pvraft_tpu_torch.weights import trained_parameters

    head = trained_parameters(model)
    step = make_refine_train_step(
        model, torch.optim.SGD([p for _, p in head], lr=0.0),
        lambda _: 0.0, 1)
    with deterministic():
        loss = float(step(batch)["loss"])
    return ((loss, {n: p.grad.detach().cpu().clone() for n, p in head}),
            [n for n, p in model.backbone.named_parameters()
             if p.grad is not None])


def seq_refine_rank(seed, root, rank, world, dev):
    """(d) on one rank: the eager refine Trainer on the seq group, its
    rows' refined flows at 1 and 8 iterations with the graphs and the
    ring truncation they used, :func:`refine_probe`, timed refine steps
    (ms each, wrapper launches, collectives a step, peak GB) and the
    eager refine Evaluator at 1 iteration."""
    from pvraft_tpu_torch.data import first_batch
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import collectives, make_mesh
    from pvraft_tpu_torch.parallel.ring import ring_truncation

    cfg = seq_refine_cfg(seed, True).replace(
        exp_path=os.path.join(root, f"refine{rank}"))
    trainer = Trainer(cfg, device=dev, graphs=False,
                      weights=seq_refine_state(seed, cfg))
    model = trainer.model
    check(model.seq_group is not None
          and model.ref_conv3.gn3.seq_group is model.seq_group
          and trainer.train_step.reduce.n_seq == world,
          "phase 17 (d): the rank's refine model or step is not "
          "sequence-parallel")
    batch = trainer._put(first_batch(trainer.train_loader))
    fmaps, graphs = [], []
    handle = recording(model.backbone.feature_extractor, fmaps, graphs)
    try:
        with torch.no_grad():
            out = {f"flow{it}": model(batch["pc1"], batch["pc2"], it).cpu()
                   for it in (1, 8)}
    finally:
        handle.remove()
    out["graphs"] = graphs[:2]
    with torch.no_grad():
        out["keep"] = ring_truncation(
            fmaps[0].to(dev), fmaps[1].to(dev), cfg.model.truncate_k,
            model.seq_group)[1].cpu()
    out["probe"], out["backbone_grads"] = refine_probe(model, batch)
    ms, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.CALLS.clear()
    n = 1 + SEQ_REFINE_TIMED
    for _ in range(n):
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    out["steps"] = {
        "losses": losses, "ms": ms, "timed_ms": ms[1:],
        "launches_per_step": {k: v / n for k, v in read_counts().items()},
        "collectives_per_step": {k: v / n for k, v in
                                 collectives.CALLS.items()},
        "step_reductions": trainer.train_step.reduce.calls,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    state = seq_refine_state(seed, cfg)
    out["backbone_unchanged"] = all(
        torch.equal(p.cpu(), state[f"backbone.{k}"])
        for k, p in model.backbone.named_parameters())
    trainer.close()
    del trainer, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    ev = Evaluator(cfg.replace(
        train=dataclasses.replace(cfg.train, eval_iters=1),
        exp_path=os.path.join(root, f"refine_eval{rank}")), device=dev,
        mesh=make_mesh(n_seq=world), graphs=False)
    out["eval"] = seq_eval(ev)
    ev.close()
    return out


def seq_refine_reference(seed, dev, root, ranks):
    """(d)'s one-process side, on the ranks' graphs (and truncation where
    named): the refine model on the same weights and batch, its refined
    flows at 1 iteration (graphs and truncation given) and 8 (graphs
    given), its one-ulp floor at 8 as :func:`seq_floor`'s (the clouds
    moved up by one ulp against the clouds as they are), beside the
    sharded flow's error, :func:`refine_probe` on the clouds and on the
    clouds moved by one ulp (the step's floor), and the eager refine
    Evaluator at 1 iteration on the ranks' eval graphs."""
    from pvraft_tpu_torch.data import first_batch
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer

    cfg = seq_refine_cfg(seed, False).replace(
        exp_path=os.path.join(root, "refine_one"))
    trainer = Trainer(cfg, device=dev, graphs=False,
                      weights=seq_refine_state(seed, cfg))
    model = trainer.model
    batch = trainer._put(first_batch(trainer.train_loader))
    graphs = [torch.cat(g, dim=1) for g in zip(
        *(r["refine"]["graphs"] for r in ranks))]
    keep = torch.cat([r["refine"]["keep"] for r in ranks], dim=1)
    joined = {it: torch.cat([r["refine"][f"flow{it}"] for r in ranks], dim=1)
              for it in (1, 8)}
    up = ulp_up(batch)
    with given_graphs(encoder_of(model), graphs):
        with torch.no_grad():
            flow8, flow8_up = (model(b["pc1"], b["pc2"], 8).cpu()
                               for b in (batch, up))
        with given_truncation(model.backbone, keep):
            with torch.no_grad():
                flow1 = model(batch["pc1"], batch["pc2"], 1).cpu()
            probe_floor, _ = refine_probe(model, up)
            probe, backbone_grads = refine_probe(model, batch)
    floor, seq8 = (flow8_up - flow8).abs(), (joined[8] - flow8).abs()
    trainer.close()
    del trainer, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    ev = Evaluator(cfg.replace(
        train=dataclasses.replace(cfg.train, eval_iters=1),
        exp_path=os.path.join(root, "refine_eval")), device=dev,
        graphs=False)
    eval_graphs = [torch.cat(g, dim=1) for g in zip(
        *(r["refine"]["eval"]["graphs"] for r in ranks))]
    with given_graphs(encoder_of(ev.model), eval_graphs):
        one_eval = seq_eval(ev)
    ev.close()
    err1 = (joined[1] - flow1).abs()
    beyond = (err1 > SEQ_FLOW_ATOL + SEQ_FLOW_RTOL * joined[1].abs()).any(-1)
    return {"iters1": {"max_abs_err": float(err1.max()),
                       "beyond": int(beyond.sum()),
                       "points": beyond.numel()},
            "floor8": {"median_abs_err": float(floor.median()),
                       "max_abs_err": float(floor.max()),
                       "seq_median_abs_err": float(seq8.median()),
                       "seq_max_abs_err": float(seq8.max())},
            "probe": probe, "probe_floor": probe_floor,
            "backbone_grads": backbone_grads, "eval": one_eval}


def seq_refine_checks(ranks, one, need):
    """(d)'s bars, each through ``need``; returns the record the phase
    prints."""
    f1 = one["iters1"]
    need(f1["beyond"] == 0,
         f"phase 17 (d): the sharded refined flow at 1 iteration against "
         f"one process on the ranks' graphs and truncation: {f1}")
    floor = one["floor8"]
    need(np.isfinite(floor["seq_max_abs_err"])
         and floor["seq_median_abs_err"]
         <= SEQ_FLOOR_FACTOR * floor["median_abs_err"],
         f"phase 17 (d): the sharded refined flow at 8 iterations against "
         f"one process, beside its own floor: {floor}")
    got = [r["refine"] for r in ranks]
    for r in got[1:]:
        need(r["probe"][0] == got[0]["probe"][0]
             and r["steps"]["losses"] == got[0]["steps"]["losses"],
             "phase 17 (d): the ranks' refine losses differ")
    probe = grad_agreement(got[0]["probe"], one["probe"])
    probe["floor"] = grad_agreement(one["probe_floor"], one["probe"])
    bar = dict(GRAD_BOUNDS["iters1"], max_rel=max(
        GRAD_BOUNDS["iters1"]["max_rel"],
        SEQ_FLOOR_FACTOR * probe["floor"]["max_rel"]), loss_rel=SEQ_LOSS_REL)
    need(probe["loss_rel"] <= bar["loss_rel"]
         and probe["min_cos"] >= bar["min_cos"]
         and probe["max_rel"] <= bar["max_rel"],
         f"phase 17 (d): the refine step at 1 iteration against one "
         f"process: {probe} (bars {bar})")
    need(all(not r["backbone_grads"] for r in got)
         and not one["backbone_grads"]
         and all(r["backbone_unchanged"] for r in got),
         f"phase 17 (d): backbone leaves with a gradient "
         f"{[r['backbone_grads'][:3] for r in got]} / "
         f"{one['backbone_grads'][:3]}, or a backbone that moved")
    for r in got:
        launches = r["steps"]["launches_per_step"]
        need(launches["fused_corr_lookup"] == 8
             and launches["fused_gru_update"] == 8
             and r["steps"]["step_reductions"] == 1 + SEQ_REFINE_TIMED,
             f"phase 17 (d): a rank's refine step launched {launches}")
        need(all(np.isfinite(r["steps"]["losses"])),
             f"phase 17 (d): refine losses {r['steps']['losses']}")
    per_scene = np.sum([r["eval"]["epe"] for r in got], axis=0)
    eval_err = float(np.max(np.abs(per_scene - np.asarray(
        one["eval"]["epe"]))))
    need(eval_err <= SEQ_EVAL_TOL
         and all(r["eval"]["means"] == got[0]["eval"]["means"] for r in got),
         f"phase 17 (d): refine per-scene EPE {per_scene.tolist()} against "
         f"{one['eval']['epe']}")
    return {"iters1": f1, "floor8": floor, "step_iters1": probe,
            "step_iters1_bounds": bar,
            "ranks": [{k: r[k] for k in ("steps", "backbone_unchanged")}
                      for r in got],
            "eval": {"per_scene_epe": per_scene.tolist(),
                     "one_process": one["eval"]["epe"],
                     "per_scene_max_abs_err": eval_err,
                     "ranks_means": got[0]["eval"]["means"],
                     "one_process_means": one["eval"]["means"]}}


def seq_leg_rank(seed, rank, world, port, path, dev=None):
    """Phase 17, one rank of the seq group: the flagship eager Trainer on
    a 1 x ``world`` mesh in a gloo group on the one card; (a) its rows'
    forward, (b) its train steps, (c) the eager Evaluator at 1
    iteration, (d) stage 2 (:func:`seq_refine_rank`)."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import first_batch
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import initialize, make_mesh, shutdown
    from pvraft_tpu_torch.parallel.ring import ring_truncation
    from pvraft_tpu_torch.weights import seeded_state_dict

    dev = dev or torch.device("cuda")
    initialize(f"localhost:{port}", num_processes=world, process_id=rank,
               backend="gloo", local_rank=0)
    try:
        with scratch_dir() as root:
            cfg = seq_cfg(seed, True).replace(
                exp_path=os.path.join(root, f"rank{rank}"))
            trainer = Trainer(cfg, device=dev, graphs=False,
                              weights=seeded_state_dict(ModelConfig(), seed))
            mesh = trainer.mesh
            check(mesh.shape == {"data": 1, "seq": world}
                  and mesh.seq_index == rank
                  and trainer.model.seq_group is not None
                  and trainer.train_step.reduce.n_seq == world,
                  "phase 17: the rank's mesh, model or step is not "
                  "sequence-parallel")
            batch = trainer._put(first_batch(trainer.train_loader))
            out = {"forward": seq_forward(trainer.model, batch),
                   "rows": list(batch["pc1"].shape)}
            with torch.no_grad():
                out["keep"] = ring_truncation(
                    out["forward"]["fmap1"].to(dev),
                    out["forward"]["fmap2"].to(dev), cfg.model.truncate_k,
                    mesh.seq_group)[1].cpu()
            out["steps"] = seq_steps(trainer, batch, group_window(mesh, dev))
            trainer.close()
            del trainer, batch
            gc.collect()
            torch.cuda.empty_cache()
            ecfg = cfg.replace(train=dataclasses.replace(
                cfg.train, eval_iters=1))
            ev = Evaluator(ecfg.replace(exp_path=os.path.join(
                root, f"eval{rank}")), device=dev,
                mesh=make_mesh(n_seq=world), graphs=False)
            out["eval"] = seq_eval(ev)
            ev.close()
            del ev
            gc.collect()
            torch.cuda.empty_cache()
            out["refine"] = seq_refine_rank(seed, root, rank, world, dev)
        torch.save(out, path)
    finally:
        shutdown()


def graph_flips(pc, neighbors, k):
    """The points whose ``k`` nearest neighbours (global indices
    ``neighbors``, the ranks' ring) differ from the dense build's, and
    the largest of their k-th to (k+1)-th squared-distance gaps."""
    from pvraft_tpu_torch.ops.geometry import pairwise_sqdist

    d = torch.topk(pairwise_sqdist(pc, pc), k + 1, dim=-1, largest=False)
    want = d.indices[..., :k].sort(-1).values.cpu()
    flip = (want != neighbors.sort(-1).values).any(-1)
    gap = (d.values[..., k] - d.values[..., k - 1]).cpu()
    return {"flips": int(flip.sum()),
            "max_gap": float(gap[flip].max()) if flip.any() else 0.0}


def seq_flips(one, joined, iters, dev, k):
    """The points whose truncation (each side's top-K of its own
    features) differs between one process and the joined ranks, on the
    same graphs, their truncation gaps (one process's K-th less (K+1)-th
    correlation), the points within ``iters`` graph hops of a flip, and
    the flows' agreement on the points no flip reaches."""
    import math

    gaps = None
    for side in (one, joined):
        f1, f2 = side["fmap1"].to(dev), side["fmap2"].to(dev)
        corr = torch.bmm(f1, f2.transpose(1, 2)) / math.sqrt(f1.shape[-1])
        top = torch.topk(corr, k + 1, dim=-1)
        side["keep"] = top.indices[..., :k].sort(-1).values
        if side is one:
            gaps = (top.values[..., k - 1] - top.values[..., k]).cpu()
        del corr, top
    flipped = (one["keep"] != joined["keep"]).any(-1).cpu()
    reached = flipped.clone()
    nbr = one["graph1"]
    for _ in range(iters):
        reached = reached | torch.gather(
            reached, 1, nbr.reshape(nbr.shape[0], -1)).reshape(
                nbr.shape).any(-1)
    want, got = one[f"flows{iters}"], joined[f"flows{iters}"]
    err = (want - got).abs()
    beyond = (err > SEQ_FLOW_ATOL + SEQ_FLOW_RTOL * got.abs()).any(-1)
    points = flipped.numel()
    far = ~reached
    return {"corr_flips": int(flipped.sum()),
            "flip_share": float(flipped.sum()) / points,
            "max_flip_gap": float(gaps[flipped].max())
            if flipped.any() else 0.0,
            "fmap_max_abs_err": max(
                float((one[f] - joined[f]).abs().max())
                for f in ("fmap1", "fmap2")),
            "reached_share": float(reached.sum()) / points,
            "beyond_share": float(beyond.sum()) / points,
            "max_abs_err": float(err.max()),
            "unreached_max_abs_err": float(err[far].max())
            if far.any() else 0.0,
            "unreached_beyond": int((beyond & far).sum())}


def ulp_up(batch):
    """``batch`` with both clouds moved up by one ulp."""
    return dict(batch, **{k: torch.nextafter(
        batch[k], torch.full_like(batch[k], torch.inf))
        for k in ("pc1", "pc2")})


def seq_floor(model, batch, graphs, gamma, seq_flows):
    """The one-process model's own float32 floor at 8 iterations: the
    same model on the same graphs with both clouds moved up by one ulp,
    against the clouds as they are: the flows' median and worst
    |difference| beside ``seq_flows``' (the sharded flows' against one
    process), and the sequence loss's relative change."""
    from pvraft_tpu_torch.engine.loss import sequence_loss

    with torch.no_grad(), given_graphs(model.feature_extractor, graphs):
        flows = [model(b["pc1"], b["pc2"], 8)[0]
                 for b in (batch, ulp_up(batch))]
    floor = (flows[1][-1] - flows[0][-1]).abs().cpu()
    loss = [float(sequence_loss(f, batch["mask"], batch["flow"], gamma))
            for f in flows]
    return {"median_abs_err": float(floor.median()),
            "max_abs_err": float(floor.max()),
            "seq_median_abs_err": float(seq_flows.median()),
            "seq_max_abs_err": float(seq_flows.max()),
            "loss_rel": abs(loss[1] - loss[0]) / abs(loss[0])}


def seq_parallel_phase(seed, dev):
    """Phase 17 (``seq_parallel``; after phase 16, before the profiler
    phases): sequence parallelism. Two gloo ranks on the card as one seq
    group (``--leg seq`` processes) hold 4,096 rows of each cloud of the
    flagship per-device batch 2 x 8,192; this process runs the one-rank
    eager Trainer and Evaluator on the same weights and batch. (a) The
    ranks' ring kNN graphs against the dense build (:func:`graph_flips`:
    flips near-ties and rare); the reference then runs on the ranks'
    graphs (:func:`given_graphs`) here and in (b) and (c), so that a
    graph flip's change of the features does not hide what the rest of
    the sharded model computes. The forward at 1 and 8 iterations
    against one process (:func:`seq_flips`: truncation flips near-ties
    and rare, every point no flip reaches within the flagship parity
    bar, points beyond it rare); at 8 iterations (:func:`seq_floor`)
    their median error within :data:`SEQ_FLOOR_FACTOR` of the model's own
    one-ulp floor. (b) The reference on the ranks' truncation too
    (:func:`given_truncation`). A step at 1 iteration (:func:`seq_probe`): loss
    within :data:`SEQ_LOSS_REL`, gradients under ``GRAD_BOUNDS["iters1"]``
    (the worst leaf there, or within :data:`SEQ_FLOOR_FACTOR` of the same
    step's one-ulp floor);
    then 3 eager steps on one batch under ``deterministic()``: step 1
    under ``GRAD_BOUNDS["iters8"]``, the loss falling on both sides, the
    ranks equal; 8 kernel-1 launches a
    step per rank (wrapper counts, and the card's in one profiler window
    the ranks take together); ms a step, peak GB, collectives a step.
    (c) The eager Evaluator at 1 iteration: per-scene EPE (the ranks'
    shares summed) within :data:`SEQ_EVAL_TOL` of one process. (d) Stage
    2 on the same group (:func:`seq_refine_rank`, the reference
    :func:`seq_refine_reference`, the bars :func:`seq_refine_checks`):
    the refined flow at 1 iteration on the ranks' graphs and truncation,
    every point within the flagship parity bar; at 8 iterations on their
    graphs, the median error within :data:`SEQ_FLOOR_FACTOR` of the
    refine model's one-ulp floor (32 untrained iterations are chaotic:
    phase 9); a refine step at 1 iteration under ``deterministic()``:
    loss within :data:`SEQ_LOSS_REL`, head gradients under (b)'s
    1-iteration bar, every backbone leaf's gradient None; 8 launches of
    kernels 1 and 2 a step per rank (wrapper counts), ms a step, peak GB,
    collectives a step; the refine Evaluator's per-scene EPE within
    :data:`SEQ_EVAL_TOL`."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import first_batch
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.ops import cuda as kernels
    from pvraft_tpu_torch.weights import seeded_state_dict

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with scratch_dir() as root:
        port = str(free_port())
        paths = [os.path.join(root, f"seq{r}.pt") for r in range(SEQ_WORLD)]
        run_legs([(f"seq{r}", ["--leg", "seq", "--seed", str(seed),
                               "--rank", str(r), "--world", str(SEQ_WORLD),
                               "--port", port, "--out", paths[r]])
                  for r in range(SEQ_WORLD)], root)
        legs_s = time.perf_counter() - t_phase
        ranks = [torch.load(p, weights_only=False) for p in paths]
        joined = {k: torch.cat([r["forward"][k] for r in ranks], dim=1)
                  for k in ranks[0]["forward"]}
        cfg = seq_cfg(seed, False).replace(exp_path=os.path.join(root,
                                                                 "one"))
        trainer = Trainer(cfg, device=dev, graphs=False,
                          weights=seeded_state_dict(ModelConfig(), seed))
        batch = trainer._put(first_batch(trainer.train_loader))
        knn = {f"pc{c}": graph_flips(batch[f"pc{c}"], joined[f"graph{c}"],
                                     cfg.model.graph_k) for c in (1, 2)}

        def window(fn):
            _, counts = kernels.measured_launches(fn)
            return {"launches": counts, "windows": 1}

        graphs = [joined["graph1"], joined["graph2"]]
        with given_graphs(trainer.model.feature_extractor, graphs):
            one_fwd = seq_forward(trainer.model, batch)
        floor = seq_floor(trainer.model, batch, graphs, cfg.train.gamma,
                          (joined["flows8"] - one_fwd["flows8"]).abs())
        keep = torch.cat([r.pop("keep") for r in ranks], dim=1)
        with given_graphs(trainer.model.feature_extractor, graphs), \
                given_truncation(trainer.model, keep):
            # The 1-iteration step's own floor: the clouds moved by one ulp.
            probe_floor = seq_probe(trainer.model, ulp_up(batch),
                                    cfg.train.gamma)
            one_steps = seq_steps(trainer, batch, window)
        trainer.close()
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        ev = Evaluator(cfg.replace(
            train=dataclasses.replace(cfg.train, eval_iters=1),
            exp_path=os.path.join(root, "eval")), device=dev, graphs=False)
        eval_graphs = [torch.cat(g, dim=1) for g in zip(
            *(r["eval"]["graphs"] for r in ranks))]
        with given_graphs(ev.model.feature_extractor, eval_graphs):
            one_eval = seq_eval(ev)
        ev.close()
        del ev
        gc.collect()
        torch.cuda.empty_cache()
        one_refine = seq_refine_reference(seed, dev, root, ranks)
    # Every check of the phase is read before any fails it.
    fails = []

    def need(cond, msg):
        if not cond:
            fails.append(msg)

    # (a) the graphs, then the forward on them.
    for cloud, g in knn.items():
        need(g["flips"] < SEQ_RARE * joined["graph1"].shape[1]
             and g["max_gap"] < SEQ_KNN_GAP,
             f"phase 17 (a): {cloud}'s ring kNN graph against the dense "
             f"one: {g}")
    need(ranks[0]["rows"] == [cfg.train.batch_size,
                              cfg.data.max_points // SEQ_WORLD, 3],
         f"phase 17: a rank holds {ranks[0]['rows']} rows")
    forward = {}
    for iters in (1, 8):
        forward[f"iters{iters}"] = seq_flips(one_fwd, joined, iters, dev,
                                             cfg.model.truncate_k)
    f = forward["iters1"]
    need(f["flip_share"] < SEQ_RARE and f["max_flip_gap"] < SEQ_TIE_GAP
         and f["beyond_share"] < SEQ_RARE and f["unreached_beyond"] == 0,
         f"phase 17 (a): the sharded flows at 1 iteration against one "
         f"process: {f}")
    forward["floor8"] = floor
    need(np.isfinite(floor["seq_max_abs_err"])
         and floor["seq_median_abs_err"]
         <= SEQ_FLOOR_FACTOR * floor["median_abs_err"],
         f"phase 17 (a): the sharded flows at 8 iterations against one "
         f"process, beside its own floor: {floor}")
    # (b) the steps.
    for r in ranks[1:]:
        need(r["steps"]["losses"][:SEQ_STEPS]
             == ranks[0]["steps"]["losses"][:SEQ_STEPS],
             "phase 17 (b): the ranks' losses differ")
    got, want = ranks[0]["steps"], one_steps
    # The ranks' gradients: each rank's share of the scenes', summed over
    # the group by the step's reduction; the reference on the ranks' graphs
    # and truncation (given_truncation). At 1 iteration the loss is held to
    # SEQ_LOSS_REL and the gradients to GRAD_BOUNDS["iters1"]; at the
    # flagship's 8, whose untrained iterations amplify float32 differences
    # as (a) shows, to GRAD_BOUNDS["iters8"] (the floor's loss change
    # beside them).
    # A scalar leaf whose gradient sums millions of terms of both signs
    # (measured on one H100: the lookup's PReLU slope) moves by
    # ~1e-2 under any change of summation order: its worst leaf is held
    # to 1e-2 or to SEQ_FLOOR_FACTOR times the one-ulp floor's.
    probe = grad_agreement(got["probe"], want["probe"])
    probe["floor"] = grad_agreement(probe_floor, want["probe"])
    bar1 = dict(GRAD_BOUNDS["iters1"], max_rel=max(
        GRAD_BOUNDS["iters1"]["max_rel"],
        SEQ_FLOOR_FACTOR * probe["floor"]["max_rel"]), loss_rel=SEQ_LOSS_REL)
    need(probe["loss_rel"] <= bar1["loss_rel"]
         and probe["min_cos"] >= bar1["min_cos"]
         and probe["max_rel"] <= bar1["max_rel"],
         f"phase 17 (b): the step at 1 iteration against one process: "
         f"{probe} (bars {bar1})")
    grads = grad_agreement((got["losses"][0], got["grads"]),
                           (want["losses"][0], want["grads"]))
    loss_rel = grads["loss_rel"]
    bar = GRAD_BOUNDS["iters8"]
    need(grads["min_cos"] >= bar["min_cos"]
         and grads["loss_rel"] <= bar["loss_rel"],
         f"phase 17 (b): step 1 at 8 iterations against one process: "
         f"{grads} (bars {bar}; the one-ulp floor {floor})")
    for side in (got, want):
        losses = side["losses"][:SEQ_STEPS]
        need(losses[-1] < losses[0],
             f"phase 17 (b): the loss does not fall: {losses}")
    for r in ranks:
        need(r["steps"]["launches_per_step"]["fused_corr_lookup"] == 8
             and r["steps"]["window"]["launches"]["fused_corr_lookup"] == 8,
             f"phase 17 (b): a rank's step launched kernel 1 "
             f"{r['steps']['launches_per_step']} (wrapper) / "
             f"{r['steps']['window']} (profiler)")
    # (c) the Evaluator.
    per_scene = np.sum([r["eval"]["epe"] for r in ranks], axis=0)
    eval_err = float(np.max(np.abs(per_scene - np.asarray(
        one_eval["epe"]))))
    means_err = max(abs(ranks[0]["eval"]["means"][k] - v)
                    for k, v in one_eval["means"].items())
    need(eval_err <= SEQ_EVAL_TOL and means_err <= SEQ_EVAL_TOL
         and all(r["eval"]["means"] == ranks[0]["eval"]["means"]
                 for r in ranks),
         f"phase 17 (c): per-scene EPE {per_scene.tolist()} against "
         f"{one_eval['epe']}, means {ranks[0]['eval']['means']} / "
         f"{one_eval['means']}")
    refine = seq_refine_checks(ranks, one_refine, need)
    check(not fails, " | ".join(fails))
    for side in (*[r["steps"] for r in ranks], one_steps):
        del side["grads"], side["probe"]
    for r in (*ranks, {"eval": one_eval}):
        del r["eval"]["graphs"]
    return {"knn": knn, "forward": forward,
            "steps": {"ranks": [r["steps"] for r in ranks],
                      "one_process": one_steps, "loss_rel": loss_rel,
                      "grads": grads, "bounds": bar, "iters1": probe,
                      "iters1_bounds": bar1},
            "eval": {"per_scene_epe": per_scene.tolist(),
                     "one_process": one_eval, "per_scene_max_abs_err":
                     eval_err, "means_max_abs_err": means_err,
                     "ranks_means": ranks[0]["eval"]["means"]},
            "refine": refine,
            "legs_s": legs_s, "phase_s": time.perf_counter() - t_phase}


# -------------------------------------------------------------- phase 18 --

LOAD_REQUESTS = 48           # run_load's requests, direct and routed
LOAD_CONCURRENCY = 4
LOAD_POINTS = (8192, 3000, 2048)
LEG_REQUESTS = 24            # each chaos leg's requests through the router
# The SLO the report is held to, and the stage-sum band it records (the
# stages' p99s over the end-to-end p99; at concurrency 4 independent
# stalls land in different stages' tails, so it is wider than a serial
# client's [0.9, 1.1]). The phase prints the ratio; it does not gate on it.
LOAD_SLO_P99_MS = 2000.0
LOAD_RATIO_BAND = (0.5, 1.5)
LOAD_LEG_TIMEOUT_S = 300.0


def load_fleet_cfg():
    """Phase 18's serve config: the flagship ``ModelConfig`` with
    ``fused_gru`` (so kernels 1 and 2 both run), fp32, buckets 2048 and
    8192, batch size 1, one replica."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve import ServeConfig

    return ServeConfig(model=ModelConfig(fused_gru=True),
                       buckets=(2048, 8192), batch_sizes=(1,),
                       dtype="float32", replicas=1)


def serve_identity(port):
    """(requests, responses + rejected + in_flight) of one atomic
    Prometheus render of a serve host."""
    status, out, _ = http_call(port, "GET", "/metrics?format=prometheus",
                               timeout=10)
    if status != 200:
        raise ValueError(f"/metrics: {status}")
    text = out.decode("utf-8")
    rejected = sum(float(v) for v in re.findall(
        r"^pvraft_serve_rejected_total\{[^}]*\} (\S+)$", text, re.M))
    return (prom_value(text, "pvraft_serve_requests_total"),
            prom_value(text, "pvraft_serve_responses_total") + rejected
            + prom_value(text, "pvraft_serve_in_flight"))


def fleet_identity(port):
    """The same identity of the router's ledger, from its ``/healthz``."""
    status, out, _ = http_call(port, "GET", "/healthz", timeout=10)
    if status != 200:
        raise ValueError(f"/healthz: {status}")
    m = json.loads(out)["metrics"]
    return (m["requests_total"], m["responses_total"]
            + sum(m["rejected"].values()) + m["in_flight"])


class IdentityPoller:
    """A thread that reads an identity every ``interval_s`` until
    stopped: the snapshots it read, those where the two sides differed,
    and the reads that failed."""

    def __init__(self, read, interval_s):
        import threading

        self.read, self.interval_s = read, interval_s
        self.snapshots, self.errors, self.violations = 0, 0, []
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._halt.wait(self.interval_s):
            try:
                lhs, rhs = self.read()
            except (OSError, ValueError, KeyError):
                self.errors += 1
                continue
            self.snapshots += 1
            if lhs != rhs:
                self.violations.append([lhs, rhs])

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._halt.set()
        self._thread.join(30)
        check(not self._thread.is_alive(), "load fleet: a poller hung")


def latency(m):
    """The headline numbers of one ``run_load`` measurement."""
    return {"p50_ms": m["latency_ms"]["p50"], "p95_ms": m["latency_ms"]["p95"],
            "p99_ms": m["latency_ms"]["p99"],
            "requests_per_s": m["throughput_rps"],
            "requests": m["requests"], "duration_s": m["duration_s"]}


def ms_stats(samples):
    """Mean, median (nearest rank) and max of a few millisecond samples:
    with ~50 of them a p99 is the max, so the max is named as such."""
    from pvraft_tpu_torch.obs.slo import exact_quantile

    return {"mean_ms": sum(samples) / len(samples),
            "p50_ms": exact_quantile(samples, 0.5), "max_ms": max(samples)}


def stage_breakdown(records, trace_ids, client_ms):
    """Where one load run's time went, from the hosts' span trees of its
    requests (``trace_ids``): each serve stage's and the host's whole
    request span's ``ms_stats``, beside the client's latency. The client's
    mean less the request span's is the time outside the host: the HTTP
    hops and, where there is one, the router."""
    from pvraft_tpu_torch.obs.trace import SERVE_STAGES, trace_shape

    trees = {}
    for r in records:
        if r["type"] == "span":
            trees.setdefault(r["trace_id"], []).append(r)
    stages = {s: [] for s in SERVE_STAGES}
    request = []
    for tid in trace_ids:
        roots, _, durations, complete = trace_shape(trees.get(tid, []),
                                                    SERVE_STAGES)
        check(complete, f"load fleet: trace {tid} is not a complete tree")
        request.append(roots[0]["end_ms"] - roots[0]["start_ms"])
        for s in SERVE_STAGES:
            stages[s].append(durations[s])
    client = ms_stats(client_ms)
    host = ms_stats(request)
    return {"requests": len(request), "client": client,
            "request_span": host,
            "outside_host_mean_ms": client["mean_ms"] - host["mean_ms"],
            "stages": {s: ms_stats(v) for s, v in stages.items()}}


def load_fleet_phase(seed, dev, smi):
    """Phase 18 (``load_fleet``; after phase 17, before the profiler
    phases): the load tools and the fleet tier on the card, at
    ``load_fleet_cfg()`` with seeded weights. (a) One host
    (``build_service``, every request traced, the cost surface armed from
    phase 15's inventory): ``run_load`` sends LOAD_REQUESTS requests from
    LOAD_CONCURRENCY clients, point counts cycling LOAD_POINTS, while a
    poller reads the ledger identity from the host's Prometheus text. The
    ``pvraft_serve_load/v1`` document, its event stream and its trace
    document must be valid; from them the ``pvraft_slo/v1`` report (every
    request a complete tree, ``stage_sum_ratio`` per program), the bucket
    advisor's report, the capacity plan on the port's surface and the
    calibration records (identity violations 0, every record
    ``comparable: false``), each valid. (b) Two hosts behind the port's
    ``FleetRouter`` (cost surface armed) on one stream: the run's first
    requests sent through the router, steered to each host in turn (the
    host's served count must rise by one and the other's not at all),
    each flow bitwise the host engine's ``predict``; one 8,192-point request
    through the router under the profiler launches kernels 1 and 2 eight
    times each, replayed, and no wrapper eagerly; then the same traffic
    as (a) through the router. Of both runs, direct and routed, the
    per-stage breakdown of the hosts' span trees (``stage_breakdown``).
    (c) The fleet chaos scenario: host 1 shut down mid-load (every
    request resolves, spillovers > 0, the router walks it to quarantined;
    served again on its port with no capture, it is revived);
    ``/admin/reload`` of a checkpoint of other weights fanned out
    mid-traffic (both digests change; no capture, no recompile
    recorded); a canary of those weights saved again promotes; a canary
    of another seed's weights is rejected. The ``pvraft_fleet_chaos/v1``
    document (traffic mix from (a)'s capacity plan, the router's identity
    polled throughout) must be valid, every client response must have
    its ``fleet_route`` record and the stream must be valid."""
    import threading

    from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
    from pvraft_tpu_torch.fleet import (FLEET_CHAOS_SCHEMA, FleetConfig,
                                        build_fleet, validate_fleet_artifact)
    from pvraft_tpu_torch.obs.calibration import (CALIBRATION_SCHEMA,
                                                  validate_calibration)
    from pvraft_tpu_torch.obs.capacity import (build_capacity_report,
                                               validate_capacity)
    from pvraft_tpu_torch.obs.events import read_events, validate_events_file
    from pvraft_tpu_torch.obs.retrace import compile_count
    from pvraft_tpu_torch.obs.slo import build_slo_report, validate_slo_report
    from pvraft_tpu_torch.programs.costs import CostSurface, default_costs_path
    from pvraft_tpu_torch.rng import host_rng
    from pvraft_tpu_torch.serve import (InferenceEngine, ServeTelemetry,
                                        SupervisorConfig, build_service,
                                        params_digest)
    from pvraft_tpu_torch.serve.advisor import build_advisor_report
    from pvraft_tpu_torch.serve.loadgen import (SCHEMA_VERSION, _post_json,
                                                merge_measurements, run_load,
                                                validate_load_artifact,
                                                write_load_and_trace)
    from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

    t_phase = time.perf_counter()
    cfg = load_fleet_cfg()
    model = cfg.model
    surface_path = default_costs_path()
    check(os.path.exists(surface_path),
          f"load fleet: no cost inventory at {surface_path} (phase 15 "
          f"writes it)")
    surface = CostSurface.load(surface_path)
    state = seeded_state_dict(model, seed)
    out = {"gpu": smi, "config": {
        "buckets": list(cfg.buckets), "batch_sizes": list(cfg.batch_sizes),
        "num_iters": cfg.num_iters, "dtype": cfg.dtype,
        "fused_gru": model.fused_gru, "requests": LOAD_REQUESTS,
        "concurrency": LOAD_CONCURRENCY, "point_counts": list(LOAD_POINTS),
        "leg_requests": LEG_REQUESTS}}
    with scratch_dir() as root:
        # (a) One host, the load generator and the reports.
        events = os.path.join(root, "load.events.jsonl")
        telemetry = ServeTelemetry(events, cfg=cfg)
        engine = InferenceEngine(state, cfg, device=dev, telemetry=telemetry)
        server = build_service(engine, telemetry=telemetry,
                               trace_sample_every=1, cost_surface=surface)
        server.start()
        try:
            poller = IdentityPoller(lambda: serve_identity(server.port),
                                    0.02).start()
            try:
                direct = run_load(server, n_requests=LOAD_REQUESTS,
                                  concurrency=LOAD_CONCURRENCY,
                                  point_counts=list(LOAD_POINTS), seed=seed)
                time.sleep(0.05)
            finally:
                poller.stop()
            health = http_json(server.port, "/healthz")
        finally:
            server.shutdown(drain=True)
            telemetry.close()
        check(direct["requests"]["ok"] == LOAD_REQUESTS,
              f"load fleet (a): {direct['requests']}")
        load_doc = {
            "schema": SCHEMA_VERSION,
            "config": {**out["config"], "compute_dtype": cfg.dtype,
                       "truncate_k": model.truncate_k,
                       "graph_k": model.graph_k, "corr_knn": model.corr_knn,
                       "weights": f"seeded {seed}",
                       "platform": engine.platform,
                       "replicas": len(engine.replicas)},
            "compile": engine.compile_report(), **direct}
        load_path = os.path.join(root, "load.json")
        _, trace_doc = write_load_and_trace(load_path, load_doc, events)
        check(validate_events_file(events) == [],
              f"load fleet (a): {validate_events_file(events)[:3]}")
        check(trace_doc["counts"]["complete"] == LOAD_REQUESTS,
              f"load fleet (a): traces {trace_doc['counts']}")
        slo_doc = build_slo_report(
            [(load_path, load_doc, events, read_events(events))],
            LOAD_SLO_P99_MS, ratio_band=LOAD_RATIO_BAND)
        problems = validate_slo_report(slo_doc)
        check(not problems and slo_doc["totals"]["complete"] == LOAD_REQUESTS,
              f"load fleet (a): SLO report {problems} {slo_doc['totals']}")
        rp = direct["request_points"]
        advice = build_advisor_report(
            rp["edges"], rp["counts"], list(cfg.buckets),
            min_bucket=cfg.min_points, source=load_path,
            cost_surface=surface, dtype=cfg.dtype)
        capacity = build_capacity_report(
            surface, load_doc, slo_doc, buckets=cfg.buckets,
            batch_sizes=cfg.batch_sizes, dtype=cfg.dtype,
            inputs={"costs": surface_path, "load": load_path})
        problems = validate_capacity(capacity)
        check(not problems and capacity["demand"],
              f"load fleet (a): capacity plan {problems}")
        cost = health.get("cost") or {}
        calibration = {
            "schema": CALIBRATION_SCHEMA, "surface": surface_path,
            "surface_coverage": health.get("cost_surface"),
            "platform": engine.platform, "dtype": cfg.dtype,
            "config": load_doc["config"],
            "identity": {"snapshots": poller.snapshots,
                         "violations": len(poller.violations),
                         "poll_errors": poller.errors},
            "requests": direct["requests"],
            "throughput_rps": direct["throughput_rps"],
            "records": cost.get("calibration", []),
            "device_busy_seconds": cost.get("device_busy_seconds"),
            "predicted_device_seconds_total": cost.get(
                "predicted_device_seconds_total")}
        problems = validate_calibration(calibration)
        check(not problems and poller.snapshots >= 10
              and not any(r["comparable"] for r in calibration["records"])
              and sum(r["n"] for r in calibration["records"])
              == LOAD_REQUESTS,
              f"load fleet (a): calibration {problems}, "
              f"{poller.snapshots} snapshots, records "
              f"{calibration['records']}")
        out["direct"] = latency(direct)
        out["direct"]["breakdown"] = stage_breakdown(
            read_events(events),
            [r["trace_id"] for r in direct["per_request"]],
            [r["ms"] for r in direct["per_request"]])
        out["slo"] = {
            "p99_ms": LOAD_SLO_P99_MS, "ratio_band": list(LOAD_RATIO_BAND),
            "totals": slo_doc["totals"],
            "max_qps_under_slo": slo_doc["max_qps_under_slo"],
            "programs": [{k: p[k] for k in ("bucket", "batch", "requests",
                                             "stage_p99_sum_ms",
                                             "stage_sum_ratio", "meets_slo")}
                         | {"e2e_p99_ms": p["e2e"]["p99_ms"]}
                         for p in slo_doc["programs"]]}
        out["advisor"] = {"objective": advice["objective"],
                          "proposed": advice["proposed"],
                          "current": advice["current"],
                          "improvement": advice["improvement"]}
        out["capacity"] = {"traffic": capacity["traffic"],
                           "per_bucket": capacity["per_bucket"],
                           "demand": capacity["demand"],
                           "measured_evidence":
                               capacity["measured_evidence"]}
        out["calibration"] = {"identity": calibration["identity"],
                              "records": calibration["records"]}
        del engine, server
        gc.collect()
        torch.cuda.empty_cache()

        # (b) Two hosts behind the port's router, on one stream.
        fleet_events = os.path.join(root, "fleet.events.jsonl")
        ftel = ServeTelemetry(fleet_events, cfg=cfg)
        engines = [InferenceEngine(state, cfg, device=dev, telemetry=ftel)
                   for _ in range(2)]
        compiles = compile_count()
        sup_cfg = SupervisorConfig(degraded_after=1, quarantine_after=2,
                                   probe_interval_s=0.1)

        def host(i, port=0):
            s = build_service(engines[i], telemetry=ftel,
                              trace_sample_every=1, supervisor_cfg=sup_cfg,
                              port=port)
            s.start()
            return s

        servers = [host(0), host(1)]
        every_server = list(servers)
        # The default poll cadence (0.5 s): a lost host stays in the
        # rotation for two polls, and the requests sent to it meanwhile
        # spill over.
        fleet_cfg = FleetConfig(quarantine_after=2, predict_timeout_s=120.0,
                                canary_fraction=0.5, canary_min_samples=6)
        router = build_fleet(servers, cfg=fleet_cfg, telemetry=ftel,
                             cost_surface=surface)
        router.start()
        target = f"{router.host}:{router.port}"
        sampler = IdentityPoller(lambda: fleet_identity(router.port),
                                 0.15).start()
        try:
            # The run's first requests, each steered to one host by a
            # dispatch held open on the other.
            rng = host_rng(seed, "serve.loadgen")
            bitwise = []
            for i in range(2 * len(LOAD_POINTS)):
                n = LOAD_POINTS[i % len(LOAD_POINTS)]
                pc1 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
                pc2 = pc1 + rng.normal(0, 0.05, (n, 3)).astype(np.float32)
                b = i % 2
                served = [s.batcher.counts["served"] for s in servers]
                router.backends[1 - b].begin_dispatch(1.0)
                try:
                    status, flow, _ = http_predict(router.port, pc1, pc2)
                finally:
                    router.backends[1 - b].end_dispatch(1.0)
                # Counted before the answer, so it is read exactly here.
                gained = [s.batcher.counts["served"] - c
                          for s, c in zip(servers, served)]
                check(gained == [int(h == b) for h in range(2)],
                      f"load fleet (b): request {i} steered to host {b} "
                      f"was served {gained} times by hosts 0 and 1")
                want = engines[b].predict(pc1, pc2)
                check(status == 200 and np.array_equal(flow, want),
                      f"load fleet (b): request {i} ({n} points) through "
                      f"the router to host {b}: status {status}, max |d| "
                      f"{float(np.abs(flow - want).max()) if flow is not None else None}")
                bitwise.append({"points": n, "host": b})
                if i == 0:
                    lone = (pc1, pc2)
            _, counts, wrapper = measured(
                lambda: http_predict(router.port, *lone))
            want_launches = want_serve("fused_gru", cfg.num_iters)
            check(counts == want_launches and wrapper == NO_LAUNCHES,
                  f"load fleet (b): a routed request ran {counts} (wrappers "
                  f"{wrapper}), expected {want_launches}")
            # The router passes no trace id on: the routed run's span
            # trees are those whose root began while it ran.
            routed_from = time.monotonic() * 1000.0
            routed = run_load(None, targets=[target],
                              n_requests=LOAD_REQUESTS,
                              concurrency=LOAD_CONCURRENCY,
                              point_counts=list(LOAD_POINTS), seed=seed)
            routed_to = time.monotonic() * 1000.0
            check(routed["requests"]["ok"] == LOAD_REQUESTS,
                  f"load fleet (b): routed {routed['requests']}")
            rounds = [routed]

            def leg(n, leg_seed, retries):
                res = {}

                def drive():
                    res["round"] = run_load(
                        None, targets=[target], n_requests=n,
                        concurrency=LOAD_CONCURRENCY,
                        point_counts=list(LOAD_POINTS), seed=leg_seed,
                        retries=retries)

                t = threading.Thread(target=drive, daemon=True)
                t.start()
                return t, res

            def joined(t, res):
                t.join(LOAD_LEG_TIMEOUT_S)
                check(not t.is_alive() and "round" in res,
                      "load fleet (c): a load leg did not finish")
                rounds.append(res["round"])
                return res["round"]

            def responses():
                return router.metrics.snapshot()["responses_total"]

            # (c1) Host 1 shut down mid-load, then served again.
            before = router.metrics.snapshot()
            t, res = leg(LEG_REQUESTS, seed + 1, 2)
            wait_for(lambda: responses() >= before["responses_total"]
                     + LEG_REQUESTS // 4, LOAD_LEG_TIMEOUT_S)
            port1 = servers[1].port
            servers[1].shutdown(drain=True)
            killed_at = responses()
            loss = joined(t, res)
            quarantined = wait_for(
                lambda: router.backends[1].state == "quarantined", 15)
            spillovers = (router.metrics.snapshot()["spillovers_total"]
                          - before["spillovers_total"])
            resolved = loss["requests"]["errors"] == 0
            check(resolved and spillovers > 0 and quarantined,
                  f"load fleet (c1): {loss['requests']}, spillovers "
                  f"{spillovers}, host 1 {router.backends[1].state}")
            servers[1] = host(1, port=port1)
            every_server.append(servers[1])
            revived = wait_for(
                lambda: router.backends[1].state == "healthy", 15)
            check(revived and compile_count() == compiles,
                  f"load fleet (c1): host 1 {router.backends[1].state}, "
                  f"{compile_count() - compiles} captures")

            # (c2) A checkpoint of other weights fanned out mid-traffic.
            paths = {}
            states = {"v2": seeded_state_dict(model, seed + 1),
                      "v4": seeded_state_dict(model, seed + 7)}
            states["v3"] = states["v2"]
            for epoch, name in enumerate(("v2", "v3", "v4"), start=1):
                paths[name], = save_checkpoint(
                    os.path.join(root, name), params_to_jax(states[name]),
                    {}, epoch, checkpoint_interval=0)
            before = router.metrics.snapshot()
            t, res = leg(LEG_REQUESTS, seed + 2, 1)
            wait_for(lambda: responses() >= before["responses_total"]
                     + LEG_REQUESTS // 4, LOAD_LEG_TIMEOUT_S)
            swap = _post_json(router.host, router.port, "/admin/reload",
                              {"ckpt": paths["v2"], "drain_timeout_s": 60.0},
                              timeout=LOAD_LEG_TIMEOUT_S)
            swapped = joined(t, res)
            rows = (swap["body"] or {}).get("swapped") or []
            new_digest = params_digest(states["v2"])
            check(swap["status"] == 200 and len(rows) == 2
                  and all(r["status"] == 200
                          and r["report"]["digest"] == new_digest
                          != r["report"]["previous_digest"] for r in rows)
                  and swapped["requests"]["errors"] == 0,
                  f"load fleet (c2): swap {swap['status']} {rows}, "
                  f"{swapped['requests']}")
            check(compile_count() == compiles,
                  f"load fleet (c2): {compile_count() - compiles} captures")

            # (c3, c4) Canaries: the same weights saved again, then
            # another seed's.
            verdicts = {}
            for name, want in (("v3", "promote"), ("v4", "reject")):
                armed = _post_json(
                    router.host, router.port, "/admin/reload",
                    {"ckpt": paths[name], "backend": 1, "canary": True,
                     "drain_timeout_s": 60.0}, timeout=LOAD_LEG_TIMEOUT_S)
                check(armed["status"] == 200
                      and armed["body"]["canary"]["armed"],
                      f"load fleet (c): canary {name}: {armed}")
                verdict = None
                for r in range(4):
                    joined(*leg(LEG_REQUESTS, seed + 3 + r, 0))
                    verdict = router.canary.status()["verdict"]
                    if verdict is not None:
                        break
                check(verdict is not None and verdict["verdict"] == want,
                      f"load fleet (c): canary {name}: {verdict}, want "
                      f"{want}")
                verdicts[want] = {"ckpt": name, "swap": armed["body"],
                                  **verdict}
            router.disarm_canary()
            final = router.metrics.snapshot()
        finally:
            sampler.stop()
            router.shutdown()
            for s in servers:
                s.shutdown(drain=True)
            ftel.close()
        watchdog_trips = sum(s.batcher.metrics.recompiles_total
                             for s in every_server)
        problems = validate_events_file(fleet_events)
        check(not problems, f"load fleet: the fleet stream {problems[:3]}")
        records = read_events(fleet_events)
        routed_traces = sorted({
            r["trace_id"] for r in records
            if r["type"] == "span" and "parent_id" not in r
            and routed_from <= r["start_ms"] <= routed_to})
        check(len(routed_traces) == LOAD_REQUESTS,
              f"load fleet (b): {len(routed_traces)} span trees began in "
              f"the routed run of {LOAD_REQUESTS} requests")
        recompiles = sum(r["type"] == "recompile" for r in records)
        routes = [r for r in records if r["type"] == "fleet_route"]
        reasons = collections.Counter(r["reason"] for r in routes)
        client_routes = len(routes) - reasons["shadow"]
        check(client_routes == final["requests_total"]
              and reasons["shadow"] == final["shadow_total"],
              f"load fleet: {dict(reasons)} fleet_route records for "
              f"{final['requests_total']} requests, "
              f"{final['shadow_total']} shadows")
        verdict_records = [r["verdict"] for r in records
                           if r["type"] == "canary_verdict"]
        check(verdict_records == ["promote", "reject"],
              f"load fleet: canary_verdict records {verdict_records}")
        merged = merge_measurements(rounds)
        fleet_load = {
            "schema": SCHEMA_VERSION,
            "config": {**load_doc["config"], "targets": [target],
                       "requests": merged["requests"]["total"],
                       "weights": f"seeded {seed} (+ v2/v3/v4 swaps)"},
            "compile": [row for e in engines for row in e.compile_report()],
            **merged}
        mix = [{"bucket": r["bucket"], "fraction": r["traffic_fraction"],
                "capacity_bucket": r["bucket"]}
               for r in capacity["per_bucket"]]
        chaos = {
            "schema": FLEET_CHAOS_SCHEMA,
            "config": {
                "backends": 2,
                "targets": [f"127.0.0.1:{s.port}" for s in servers],
                "router": target, "buckets": list(cfg.buckets),
                "batch_sizes": list(cfg.batch_sizes),
                "compute_dtype": cfg.dtype, "replicas_per_backend": 1,
                "traffic_mix": mix,
                "traffic_mix_source": "phase 18 (a)'s capacity plan",
                "fleet": dataclasses.asdict(fleet_cfg), "seed": seed},
            "load": fleet_load,
            "phases": [
                {"phase": "baseline", "requests": routed["requests"],
                 "duration_s": routed["duration_s"]},
                {"phase": "backend_loss", "killed_backend": 1,
                 "killed_at_responses": killed_at,
                 "spillovers": spillovers, "resolved": resolved,
                 "observed": {"quarantined": quarantined,
                              "revived": revived},
                 "requests": loss["requests"], "retries": 2},
                {"phase": "hot_swap",
                 "swap": {"ckpt": paths["v2"], "swapped": rows},
                 "requests": swapped["requests"]},
                {"phase": "canary", "verdict": verdicts["promote"],
                 "rejected_candidate": verdicts["reject"],
                 "canary_served": final["canary_total"],
                 "shadows": final["shadow_total"]}],
            "reconciliation": {"holds": not sampler.violations,
                               "snapshots": sampler.snapshots,
                               "final": final},
            "recompiles": recompiles, "watchdog_trips": watchdog_trips}
        problems = (validate_fleet_artifact(chaos)
                    + validate_load_artifact(fleet_load))
        check(not problems, f"load fleet: the fleet chaos document "
                            f"{problems}")
        out["routed"] = latency(routed)
        out["routed"]["breakdown"] = stage_breakdown(
            records, routed_traces, [r["ms"] for r in routed["per_request"]])
        out["fleet"] = {
            "bitwise": bitwise, "spillovers": spillovers,
            "killed_at_responses": killed_at, "loss": loss["requests"],
            "quarantined": quarantined, "revived": revived,
            "swap_digests": [r["report"]["digest"] for r in rows],
            "recompiles": recompiles, "watchdog_trips": watchdog_trips,
            "captures_after_build": compile_count() - compiles,
            "verdicts": {k: {f: v[f] for f in ("ckpt", "epe", "bound",
                                               "rel_epe", "rel_bound",
                                               "samples")}
                         for k, v in verdicts.items()},
            "identity": {"snapshots": sampler.snapshots,
                         "violations": len(sampler.violations),
                         "poll_errors": sampler.errors},
            "ledger": final, "fleet_route": dict(reasons),
            "load": merged["requests"]}
        out["launches"] = counts
    del engines, servers, every_server, router
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


OFF_FLAGSHIP = (("truncate_k1024_knn64", {"truncate_k": 1024,
                                          "corr_knn": 64}),
                ("hidden32_context96_fused_gru",
                 {"hidden_dim": 32, "context_dim": 96, "fused_gru": True}))


# -------------------------------------------------------------- phase 19 --

# The port's static checks: (CLI subcommand, the tool's name in its
# summary line).
STATIC_CHECKS = (("concurrency", "threadcheck"), ("determinism", "detcheck"),
                 ("sharding", "shardcheck"), ("lint", "graftlint"))
# The pod plan's prediction for phase 12's chunked step against its
# measured peak.
PLAN_BAND = (0.8, 1.25)


def plan_leg(dev, chunked=None):
    """The pod plan (``analysis/sharding/planner.py``) for H100 meshes,
    built from phase 15's card inventory (``programs/costs.py::
    default_costs_path()``; where there is none, as when phase 19 runs
    alone, the plan's two programs are counted here) and written to
    ``_build/pod_plan.json``: its scene verdicts, its 1 x 1 rows and its
    sharded-step cross-check. ``chunked``: phase 12's chunked step
    (``chunk_runs``: 2 x LONG_POINTS, chunks LONG_CHUNK, remat "full");
    the plan's prediction for that step must lie within PLAN_BAND of its
    measured peak. Without it nothing is compared, and the record says
    so."""
    from pvraft_tpu_torch.analysis.sharding.planner import (
        basis_inventory,
        build_plan,
        default_plan_path,
        predict_step_bytes,
        write_plan,
    )
    from pvraft_tpu_torch.programs.costs import default_costs_path

    t0 = time.perf_counter()
    costs = default_costs_path()
    out = {"inventory": costs}
    if not os.path.exists(costs):
        costs = basis_inventory(dev)
        out["inventory"] = "counted here: " + ", ".join(
            r["name"] for r in costs["programs"])
    try:
        plan = build_plan(costs)
    except ValueError as err:
        check(False, f"static checks: the pod plan: {err}")
    write_plan(plan, default_plan_path())
    out.update(
        path=default_plan_path(), scene_verdicts=plan["scene_verdicts"],
        scenario=plan["scenario"],
        mesh_1x1=next(m for m in plan["meshes"]
                      if (m["dp"], m["sp"]) == (1, 1)),
        cross_check=plan["sharded_step_cross_check"])
    predicted = predict_step_bytes(plan, LONG_POINTS, 2, LONG_CHUNK)
    out["predicted_2x16384"] = predicted
    if chunked is None:
        out["compared"] = ("nothing: phase 12's chunked step did not run "
                           "in this process")
    else:
        measured = chunked["peak_gb"] * 1e9
        ratio = predicted["total_bytes"] / measured
        out.update(measured_peak_gb=chunked["peak_gb"], ratio=ratio,
                   band=list(PLAN_BAND))
        check(PLAN_BAND[0] <= ratio <= PLAN_BAND[1],
              f"static checks: the pod plan predicts "
              f"{predicted['total_bytes'] / 1e9:.3f} GB for phase 12's "
              f"chunked step, which peaked at {chunked['peak_gb']:.3f} GB: "
              f"ratio {ratio:.3f} outside {PLAN_BAND}")
    out["seconds"] = time.perf_counter() - t0
    return out


def static_checks_phase(seed, dev, chunked=None):
    """Phase 19 (``static_checks``; after phase 18, before the profiler
    phases): the port's static checks over its own source, each CLI in a
    subprocess of this Python: ``python -m pvraft_tpu_torch.analysis
    concurrency`` (threadcheck, GC rules over ``serve/``, ``fleet/``,
    ``obs/``, ``data/loader.py``), ``... determinism`` (detcheck, GD
    rules over the package, the program registry's hazard closure
    included), ``... sharding`` (shardcheck, GS004 over ``engine/``,
    ``obs/``, ``parallel/``) and ``... lint`` (graftlint, GL006 and GL007
    over the package, this script and ``tests/test_torch_*.py``). Each
    must exit 0 with 0 findings; the files checked, findings and seconds
    of each. Then :func:`plan_leg`, with
    phase 12's chunked step where ``main`` ran it. Launches no kernel."""
    import subprocess

    out = {"python": sys.version.split()[0]}
    for cmd, tool in STATIC_CHECKS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pvraft_tpu_torch.analysis", cmd],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        seconds = time.perf_counter() - t0
        m = re.search(rf"{tool}: (\d+) finding\(s\) in (\d+) file\(s\)",
                      proc.stderr)
        check(m is not None,
              f"static checks: {cmd} printed no summary (exit "
              f"{proc.returncode}): {proc.stderr[-2000:]}")
        findings, files = int(m.group(1)), int(m.group(2))
        check(proc.returncode == 0 and findings == 0,
              f"static checks: {tool} exit {proc.returncode}, {findings} "
              f"finding(s):\n{proc.stdout[-4000:]}")
        check(files > 0, f"static checks: {tool} checked no file")
        out[cmd] = {"tool": tool, "files": files, "findings": findings,
                    "seconds": seconds}
    out["plan"] = plan_leg(dev, chunked)
    return out


def off_flagship_phase(seed, dev):
    """One 8,192-point request per OFF_FLAGSHIP configuration, seeded
    weights, ``use_pallas=None``, through ``predict`` of a captured engine
    with the counts zeroed just before it: the profiler must see the
    general kernel launched once per GRU iteration and nothing of the
    plain path's kernels in its place; the flow must be finite and, after
    1 iteration, within FLOW_BOUND_1 of the plain versions'."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    request = serve_requests(np.random.default_rng(seed + 1))[0]
    out = {}
    for name, kw in OFF_FLAGSHIP:
        model = ModelConfig(**kw)
        state = seeded_state_dict(model, seed)
        cfg = ServeConfig(model, buckets=(8192,), batch_sizes=(1,),
                          dtype="float32")
        engine = InferenceEngine(state, cfg, device=dev)
        (flows, times), counts, wrapper = measured(
            lambda: drive(engine, [request]))
        takes = engine.model.cfg
        want = dict(NO_LAUNCHES)
        want[LOOKUP_KERNELS[lookup_variant(takes.truncate_k, takes.corr_knn,
                                           takes.resolution)]] = cfg.num_iters
        if takes.fused_gru:
            want[GRU_KERNELS[gru_variant(takes.hidden_dim, takes.context_dim,
                                         WIDTH)]] = cfg.num_iters
        check(counts == want and wrapper == NO_LAUNCHES,
              f"off-flagship {name}: the card ran {counts} (wrappers "
              f"{wrapper}), expected {want}")
        del engine
        one = {}
        for plain in (False, True):
            m = dataclasses.replace(model, use_pallas=False if plain else None)
            engine = InferenceEngine(state, ServeConfig(
                m, buckets=(8192,), batch_sizes=(1,), num_iters=1,
                dtype="float32"), device=dev)
            one[plain], _ = drive(engine, [request])
            del engine
        d1 = point_diffs(one[False], one[True])
        check(d1.max() <= FLOW_BOUND_1,
              f"off-flagship {name}, 1 iteration: kernels vs plain max "
              f"|dflow| {d1.max()}")
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = {"config": kw, "launches": counts, "request": times[0],
                     "iters1_max_vs_plain": float(d1.max()),
                     "max_abs_flow": float(np.abs(flows[0][0]).max())}
    return out


# --------------------------------------------------------------- phase 7 --


def launches_phase(seed, dev):
    """The main paths driven once more, each pass alone under the
    profiler with the counts zeroed just before it and read just after:
    each serve group of phase 2's requests through ``predict`` or
    ``predict_batch`` of a freshly captured engine, and one train step and
    one eval step of a freshly captured ``Trainer``, every way of phases 2
    and 3, one call of phase 12's K-step train graph, and of stage 2
    (phase 9): one refine train step and one refine eval step (32
    iterations) with fused_gru off and on, and phase 2's first two
    request groups through a refine engine, and of the bf16
    slice (phase 10): every serve group through an engine at the default
    dtype (bfloat16), fused_gru off and on, and one bf16 train step and
    eval step with fused_gru. The kernels the
    card ran are counted by their device symbols
    (``measured``): what the replays launched, which no wrapper sees, in
    windows that two marker kernels show whole (``device_kernels``).
    Each pass must launch what its capture recorded and no wrapper may
    launch eagerly. This phase runs last: after a profiler session the
    process's eager launches run slower (CUPTI stays attached), which
    would tilt every eager-against-graphed time; the eager train step is
    timed once more here to show it."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.ops.cuda import window_counts
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                        build_service)
    from pvraft_tpu_torch.weights import seeded_state_dict

    state = seeded_state_dict(ModelConfig(), seed)
    requests = serve_requests(np.random.default_rng(seed + 1))
    serve = {}
    for name, kw in SERVE_WAYS:
        cfg = ServeConfig(ModelConfig(**kw), dtype="float32")
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
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
        scene = to_device(first_batch(PrefetchLoader(
            trainer.val_ds, 1, num_workers=0)), dev)
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
    train["kstep"] = kstep_launches(seed, dev, state, TRAIN_WAYS[:1])
    refine = {}
    refine_state = seeded_state_dict(ModelConfig(), seed, refine=True)
    for name, kw in TRAIN_WAYS[:2]:
        trainer = Trainer(flagship_train_config(seed, refine=True, **kw),
                          device=dev, weights=refine_state)
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), dev)
        scene = to_device(first_batch(PrefetchLoader(
            trainer.val_ds, 1, num_workers=0)), dev)
        got = {}
        for step, run in (("train_step", lambda: trainer.train_step(batch)),
                          ("eval_step", lambda: trainer.eval_step(scene))):
            _, counts, wrapper = measured(run)
            # Stage 2 evaluates at train.iters too.
            want = want_serve(name, trainer.cfg.train.iters)
            check(counts == want and wrapper == NO_LAUNCHES,
                  f"launches: refine {step} {name}: the card ran {counts} "
                  f"(wrappers {wrapper}), expected {want}")
            got[step] = counts
        refine[name] = got
        del trainer, batch, scene
        gc.collect()
        torch.cuda.empty_cache()
    cfg = ServeConfig(refine=True, dtype="float32", **REFINE_SERVE)
    engine = InferenceEngine(refine_state, cfg, device=dev)
    refine["serve"] = dict(NO_LAUNCHES)
    for request in requests[:2]:
        _, counts, wrapper = measured(lambda: drive(engine, [request]))
        want = want_serve("unfused_gru", cfg.num_iters)
        check(counts == want and wrapper == NO_LAUNCHES,
              f"launches: refine serve {request[0]} {request[2]}: the card "
              f"ran {counts} (wrappers {wrapper}), expected {want}")
        refine["serve"] = {k: refine["serve"][k] + counts[k]
                           for k in counts}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = {}
    for name, kw in BF16_SERVE_WAYS:
        cfg = ServeConfig(ModelConfig(**kw))
        engine = InferenceEngine(state, cfg, device=dev)
        total = dict(NO_LAUNCHES)
        for request in requests:
            _, counts, wrapper = measured(lambda: drive(engine, [request]))
            want = want_bf16(name, cfg.num_iters)
            check(counts == want and wrapper == NO_LAUNCHES,
                  f"launches: bf16 serve {name} {request[0]} {request[2]}: "
                  f"the card ran {counts} (wrappers {wrapper}), expected "
                  f"{want}")
            total = {k: total[k] + counts[k] for k in total}
        bf16[f"serve_{name}"] = total
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    http = dict(NO_LAUNCHES)
    engine = InferenceEngine(state, ServeConfig(), device=dev)
    server = build_service(engine)
    server.start()
    try:
        for kind, group, bucket in requests:
            (status, _, _), counts, wrapper = measured(
                lambda: http_predict(server.port, *group[0]))
            want = want_bf16("unfused_gru", engine.cfg.num_iters)
            check(status == 200 and counts == want
                  and wrapper == NO_LAUNCHES,
                  f"launches: HTTP {kind} {bucket}: status {status}, the "
                  f"card ran {counts} (wrappers {wrapper}), expected {want}")
            http = {k: http[k] + counts[k] for k in http}
    finally:
        server.shutdown(drain=True)
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(flagship_train_config(
        seed, grad_dtype="bfloat16", fused_gru=True,
        compute_dtype="bfloat16"), device=dev, weights=state)
    batch = to_device(first_batch(PrefetchLoader(
        trainer.train_ds, 2, num_workers=0)), dev)
    scene = to_device(first_batch(PrefetchLoader(
        trainer.val_ds, 1, num_workers=0)), dev)
    t = trainer.cfg.train
    bf16["fused_gru"] = {}
    for step, run, iters in (
            ("train_step", lambda: trainer.train_step(batch), t.iters),
            ("eval_step", lambda: trainer.eval_step(scene), t.eval_iters)):
        _, counts, wrapper = measured(run)
        want = want_bf16("fused_gru", iters)
        check(counts == want and wrapper == NO_LAUNCHES,
              f"launches: bf16 {step}: the card ran {counts} (wrappers "
              f"{wrapper}), expected {want}")
        bf16["fused_gru"][step] = counts
    del trainer, batch, scene
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(flagship_train_config(seed), device=dev, weights=state,
                      graphs=False)
    batch = to_device(first_batch(PrefetchLoader(
        trainer.train_ds, 2, num_workers=0)), dev)
    for _ in range(2):
        trainer.train_step(batch)
    after_ms = cuda_ms(lambda: trainer.train_step(batch),
                       reps=TIMED_STEPS, warmup=0)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve": serve, "train": train, "refine": refine, "bf16": bf16,
            "http": http, "eager_train_step_ms_after_profiler": after_ms,
            "profiler_windows": dict(window_counts)}


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


# The phases that run alone after the kernel build (``--phase``): each
# needs only the seed and the device.
ALONE = {"refine": refine_phase, "seq_parallel": seq_parallel_phase,
         "static_checks": static_checks_phase}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", action="append", choices=sorted(ALONE),
                    help="run only this phase after the build (repeat for "
                         "more, in order); the kernels line is not printed")
    # Phase 16 runs its legs as processes of this script (--leg).
    ap.add_argument("--leg", choices=("one", "rank", "seq"), default=None,
                    help=argparse.SUPPRESS)
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace; phase 3 compares
    # gradients under torch.use_deterministic_algorithms.
    fix_cublas_workspace()
    if args.leg is not None:
        set_tf32(False)
        if args.leg == "one":
            parallel_leg_one(args.seed, args.port, args.out)
        elif args.leg == "seq":
            seq_leg_rank(args.seed, args.rank, args.world, args.port,
                         args.out)
        else:
            parallel_leg_rank(args.seed, args.rank, args.world, args.port,
                              args.out)
        return 0
    from pvraft_tpu_torch.ops import cuda as kernels
    from pvraft_tpu_torch.profile_serve import nvidia_smi

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    set_tf32(False)
    t0 = time.perf_counter()
    libs = kernels.build_all()
    for name in libs:
        kernels.library(name)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in libs.items():
        with open(f"{path}.log", encoding="utf-8", errors="replace") as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln]
    emit({"phase": "setup", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kernel_build_s": build_s, "ptxas": ptxas,
          "tf32_matmul": False, "tf32_cudnn": False})
    if args.phase:
        for name in args.phase:
            t1 = time.perf_counter()
            res = ALONE[name](args.seed, dev)
            emit({"phase": name, **res,
                  "alone_s": time.perf_counter() - t1})
        print(smi, flush=True)
        emit({"ok": True, "phases": args.phase})
        return 0

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
    general_rng = np.random.default_rng(args.seed + 13)
    general = check_general(general_rng, dev)
    backward["general_1x8192"] = check_general_backward(general_rng, dev)
    split["general"] = general_lookup_split(general_rng, dev)
    emit({"phase": "kernels", "general": general,
          "fused_corr_lookup": lookup,
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

    checkpoints = checkpoint_phase(args.seed, dev)
    emit({"phase": "checkpoints", **checkpoints})

    real = real_data_phase(args.seed, dev,
                           train["ways"]["unfused_gru"]["train_step_ms"])
    emit({"phase": "real_data", **real})

    refine = refine_phase(args.seed, dev)
    emit({"phase": "refine", **refine})

    bf16 = bf16_phase(args.seed, dev)
    emit({"phase": "bf16", **bf16})

    tier = serving_tier_phase(args.seed, dev, smi)
    emit({"phase": "serving_tier", **tier})

    levers = train_levers_phase(args.seed, dev)
    emit({"phase": "train_levers", **levers})

    observability = serve_observability_phase(args.seed, dev, smi)
    emit({"phase": "serve_observability", **observability})

    train_obs = train_observability_phase(args.seed, dev, smi)
    emit({"phase": "train_observability", **train_obs})

    cost_plane = cost_plane_phase(args.seed, dev, smi)
    emit({"phase": "cost_plane", **cost_plane})

    parallel = parallel_phase(args.seed)
    emit({"phase": "parallel", **parallel})

    seq = seq_parallel_phase(args.seed, dev)
    emit({"phase": "seq_parallel", **seq})

    load_fleet = load_fleet_phase(args.seed, dev, smi)
    emit({"phase": "load_fleet", **load_fleet})

    static = static_checks_phase(args.seed, dev,
                                 levers["chunks"]["steps"]["chunked"])
    emit({"phase": "static_checks", **static})

    # Phases 6 and 7 run the profiler, which slows the process's later
    # eager launches: they come last.
    off = off_flagship_phase(args.seed, dev)
    emit({"phase": "off_flagship", **off})

    launches = launches_phase(args.seed, dev)
    emit({"phase": "launches", **launches})
    check(train_obs["launches"]["off"]
          == launches["train"]["unfused_gru"]["train_step"],
          f"launches: phase 14's default train step ran "
          f"{train_obs['launches']['off']}, phase 7's "
          f"{launches['train']['unfused_gru']['train_step']}")
    steps = launches["train"]["fused_gru"]
    off_runs = {k: sum(o["launches"][k] for o in off.values())
                for k in NO_LAUNCHES}

    main_key = f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}"
    rows = []
    extra = {"fused_corr_lookup": {"model_inputs_ms": lookup_model["ms"],
                                   "split_ms": split["synthetic"]},
             "corr_lookup_general": {"split_ms": split["general"]},
             "fused_gru_update": {
                 "fp32_bound_ms": gru[main_key]["fp32_bound_ms"]},
             "gru_iter_general": {
                 "fp32_bound_ms":
                     general["gru"][MAIN_GENERAL[1]]["fp32_bound_ms"],
                 "mode": general["gru"][MAIN_GENERAL[1]]["mode"],
                 "modes": {k: v["mode"] for k, v in general["gru"].items()}},
             "gru_iter_bf16": {
                 "fp32_bound_ms": bf16["kernel"]["width64"]["fp32_bound_ms"],
                 "dtype": "bfloat16"}}
    bf16_steps = launches["bf16"]["fused_gru"]
    for name, source, replaces, res, runs, key, per_step in (
            ("fused_corr_lookup", "pvraft_tpu_torch/csrc/corr_lookup.cu",
             "pvraft_tpu/ops/pallas/corr_lookup.py:109",
             {**lookup, **lookup_edges, "model_inputs": lookup_model},
             launches["serve"]["fused_gru"], main_key, steps),
            ("fused_gru_update", "pvraft_tpu_torch/csrc/gru_iter.cu",
             "pvraft_tpu/ops/pallas/gru_iter.py:129", {**gru, **gru_edges},
             launches["serve"]["fused_gru"], main_key, steps),
            ("voxel_bin_means_pallas", "pvraft_tpu_torch/csrc/voxel_corr.cu",
             "pvraft_tpu/ops/pallas/voxel_corr.py:114",
             {**voxel, **voxel_edges}, kbench["launches"], main_key, steps),
            ("corr_lookup_general",
             "pvraft_tpu_torch/csrc/corr_lookup_general.cu",
             "pvraft_tpu/ops/pallas/corr_lookup.py:109",
             {**general["lookup"],
              **{f"voxel_{k}": v for k, v in general["voxel"].items()}},
             off_runs, MAIN_GENERAL[0], steps),
            ("gru_iter_general", "pvraft_tpu_torch/csrc/gru_iter_general.cu",
             "pvraft_tpu/ops/pallas/gru_iter.py:129", general["gru"],
             off_runs, MAIN_GENERAL[1], steps),
            ("gru_iter_bf16", "pvraft_tpu_torch/csrc/gru_iter_bf16.cu",
             "pvraft_tpu/ops/pallas/gru_iter.py:129",
             {**bf16["kernel"], **bf16["shapes"]},
             launches["bf16"]["serve_fused_gru"], "width64", bf16_steps)):
        r = res[key]
        check(runs[name] > 0, f"{name}: no launch on its main path")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs[name],
            "train_launches_per_step": per_step["train_step"][name],
            "eval_launches_per_step": per_step["eval_step"][name],
            "refine_train_launches_per_step":
                launches["refine"]["fused_gru"]["train_step"][name],
            "refine_eval_launches_per_step":
                launches["refine"]["fused_gru"]["eval_step"][name],
            "refine_serve_launches": launches["refine"]["serve"][name],
            "http_serve_launches": launches["http"][name],
            "nccl_world1_train_launches_per_step":
                parallel["nccl_world1"]["launches_per_step"][name],
            "nccl_world1_fused_gru_train_launches_per_step":
                parallel["nccl_world1"]["fused_gru_launches_per_step"][name],
            "gloo_rank_train_launches_per_step":
                parallel["gloo_two_ranks"]["ranks"][0]["launches_per_step"][
                    name],
            "seq_rank_train_launches_per_step":
                seq["steps"]["ranks"][0]["window"]["launches"][name],
            "seq_rank_refine_train_launches_per_step":
                seq["refine"]["ranks"][0]["steps"]["launches_per_step"][name],
            "fleet_routed_request_launches": load_fleet["launches"][name],
            **extra.get(name, {}),
            "max_abs_err": max(v["max_abs_err"] for v in res.values()),
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "ptxas": ptxas[os.path.basename(source)[:-3]]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
