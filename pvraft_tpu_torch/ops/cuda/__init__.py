"""Build and load the port's hand-written CUDA kernels.

Every ``pvraft_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes``. Nothing is built or loaded when a module is
imported: the first launch builds (all sources at once, one ``nvcc`` each,
in parallel) into ``pvraft_tpu_torch/_build/<content hash>/``, a
directory ``.gitignore`` lists. A build failure raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.

The two tuned voxel kernels (``csrc/corr_lookup.cu`` and
``csrc/voxel_corr.cu``, binning in ``csrc/voxel_bins.cuh``) run one warp
per query point, 16 candidates per lane in registers, so they take up to
:data:`MAX_CANDIDATES` candidates per point, a kNN of up to
:data:`MAX_KNN` and a resolution of :data:`RESOLUTION`; the tuned GRU
kernel (``csrc/gru_iter.cu``) takes widths of :data:`GRU_WIDTH`. Two
host-side facts choose their paths, both computing the same values:
:func:`vector_loads` (16-byte loads, else scalar loads of the same slots)
and :func:`reciprocal_is_exact` (multiply by ``1/r`` instead of dividing
by ``r``, bitwise equal where it holds). Every other shape the Pallas
kernels take runs a general kernel: ``csrc/corr_lookup_general.cu`` for
the lookup and the voxel means, ``csrc/gru_iter_general.cu`` for the GRU
update. A bfloat16 model's GRU update runs ``csrc/gru_iter_bf16.cu`` at
every width (on the bf16 tensor cores); its lookup stays float32 (the
correlation cache is float32 at every compute dtype) and runs the kernels
above.
:func:`kernel_takes` says which variant ("tuned", "general" or "bf16")
each kernel runs for a model configuration; a CUDA tensor never takes
the plain version unless the caller chose ``use_pallas=False``.

Launch counts: each wrapper's ``launches`` attribute counts its eager
launches, where it launches its kernel. A launch made while a CUDA graph
is being captured is recorded into the graph, not run: the wrapper
counts it into :data:`captured` instead, and the program keeps that
share (``serve/aot.py::GraphProgram.launches``). What a replay launches
is measured, not inferred: :func:`measured_launches` runs a function
under ``torch.profiler`` and counts the card's kernels by their device
symbols (:data:`KERNEL_SYMBOLS`), replayed ones included, in a window
that two marker kernels show whole (:func:`device_kernels`). A kernel's
first launch on a device builds and loads its library and, for the tuned
GRU kernel, opts in to its shared memory; :func:`check_capturable`
refuses a capture before that first eager launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import struct
import subprocess
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from pvraft_tpu_torch.obs.retrace import note_compile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
# Candidates per query point the voxel and lookup kernels take: 16 per
# lane of the point's warp, 4 groups of 4 (kMaxPerLane, csrc/voxel_bins.cuh).
MAX_CANDIDATES = 512
MAX_KNN = 32           # the lookup's kNN: a sorted (distance, index) per lane
RESOLUTION = 3         # the voxel kernels' cube: 27 cells per level
GRU_WIDTH = 64         # the GRU kernel's hidden, context and feature width
# Shared memory of one block on the H100: without an opt-in, and at most.
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def sources() -> Dict[str, str]:
    """Kernel name -> path of its ``.cu`` source."""
    return {f[:-3]: os.path.join(CSRC_DIR, f)
            for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cu")}


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together; returns kernel name -> shared library path. The
    compiler's output (ptxas registers, shared memory, spills) is kept
    beside each library as ``lib<name>.so.log``."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"lib{name}.so")
            for name in sources()}
    procs = []
    for name, src in sources().items():
        if os.path.exists(libs[name]):
            continue
        tmp = f"{libs[name]}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
        else:
            with open(f"{libs[name]}.log", "wb") as fh:
                fh.write(log)
            os.replace(tmp, libs[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    note_compile(len(procs))
    return libs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use).
    A build and a load each count as compiles of the process
    (``obs/retrace.py::note_compile``)."""
    lib = ctypes.CDLL(build_all()[name])
    note_compile()
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_cuda(what: str, *tensors: torch.Tensor,
                 dtypes: Union[torch.dtype, Sequence[torch.dtype]]
                 = torch.float32) -> None:
    """Check device, dtype and contiguity of a kernel's operands:
    ``dtypes`` is the dtype every operand must have, or one per operand.
    Nothing is cast: an operand of another dtype raises."""
    if isinstance(dtypes, torch.dtype):
        dtypes = [dtypes] * len(tensors)
    if len(dtypes) != len(tensors):
        raise ValueError(f"{what}: {len(tensors)} operands, "
                         f"{len(dtypes)} dtypes")
    dev = tensors[0].device
    for i, (t, dtype) in enumerate(zip(tensors, dtypes)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{what}: every operand must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: operand {i} must be {dtype}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


@functools.lru_cache(maxsize=64)
def reciprocal_is_exact(base_scale: float, num_levels: int) -> bool:
    """True when every level's edge ``r = base_scale * 2^l`` (float32,
    ``l < num_levels``) is a power of two whose reciprocal is a normal
    float32. Then ``rel * (1 / r)`` is the correctly rounded value of the
    same real number as ``rel / r``, so it is bitwise the division the
    plain version makes, and the voxel kernels multiply; otherwise they
    keep the IEEE division."""
    if not (math.isfinite(base_scale) and 0 < base_scale < 2.0**127):
        return False
    r = struct.unpack("f", struct.pack("f", base_scale))[0]  # float32
    mant, exp = math.frexp(r)           # r = mant * 2^exp, mant in [0.5, 1)
    if mant != 0.5:
        return False
    top = exp - 1 + max(num_levels, 1) - 1
    return -126 <= exp - 1 and top <= 126


def vector_loads(k: int, *tensors: torch.Tensor) -> bool:
    """Whether the voxel kernels may read each point's candidates with
    16-byte loads: K a multiple of 4 and every row 16-byte aligned."""
    return k % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lookup_variant(k: int, knn: int, resolution: int) -> str:
    """"tuned" where the tuned lookup kernel takes the shapes (K <=
    MAX_CANDIDATES, knn <= min(MAX_KNN, K), resolution RESOLUTION), else
    "general". The voxel-only pass is the knn = 0 case."""
    tuned = (k <= MAX_CANDIDATES and knn <= min(MAX_KNN, k)
             and resolution == RESOLUTION)
    return "tuned" if tuned else "general"


def gru_variant(hidden: int, context: int, corr_ch: int,
                dtype: str = "float32") -> str:
    """"bf16" at ``dtype="bfloat16"`` (the bf16 kernel takes every
    width); at float32, "tuned" where the tuned GRU kernel takes the
    widths (all GRU_WIDTH), else "general"."""
    if dtype == "bfloat16":
        return "bf16"
    tuned = hidden == context == corr_ch == GRU_WIDTH
    return "tuned" if tuned else "general"


def kernel_takes(cfg) -> Dict[str, str]:
    """Kernel name -> the variant ("tuned", "general" or "bf16") that
    runs ``cfg``'s shapes and compute dtype (a ``ModelConfig``) on a
    CUDA tensor. The correlation features reach the GRU update at width
    64 (the ``CorrLookup`` head); the lookup's operands are float32 at
    every compute dtype."""
    k, res = cfg.truncate_k, cfg.resolution
    return {"corr_lookup": lookup_variant(k, cfg.corr_knn, res),
            "voxel_corr": lookup_variant(k, 0, res),
            "gru_iter": gru_variant(cfg.hidden_dim, cfg.context_dim,
                                    GRU_WIDTH, cfg.compute_dtype)}


# Launches recorded into CUDA graphs while capturing, by wrapper name.
captured: Dict[str, int] = collections.Counter()
_warm = set()          # (wrapper name, device index) launched eagerly


def check_capturable(what: str, device: torch.device) -> None:
    """Raise if a capture is under way and ``what`` has not yet launched
    eagerly on ``device``: its first launch builds, loads and (GRU) sets
    a function attribute, none of which a graph can hold."""
    if (torch.cuda.is_current_stream_capturing()
            and (what, device.index) not in _warm):
        raise RuntimeError(
            f"{what}: first launch on {device} inside a CUDA graph capture; "
            "run it once eagerly first (serve/aot.py warms up)")


def record_launch(wrapper, device: torch.device) -> None:
    """Count one launch of ``wrapper``'s kernel: into ``captured`` while
    a graph is being captured, else into ``wrapper.launches``."""
    name = wrapper.__name__
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        wrapper.launches += 1
        _warm.add((name, device.index))


def _wrappers():
    from pvraft_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup_general,
        fused_corr_lookup,
    )
    from pvraft_tpu_torch.ops.cuda.gru_iter import (
        fused_gru_update,
        gru_iter_bf16,
        gru_iter_general,
    )
    from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas

    return (fused_corr_lookup, fused_gru_update, voxel_bin_means_pallas,
            corr_lookup_general, gru_iter_general, gru_iter_bf16)


def launch_counts() -> Dict[str, int]:
    """Wrapper name -> eager kernel launches since the last
    :func:`zero_launch_counts`: the three tuned kernels under their
    Functions' names, the general and bf16 kernels under their own
    (``corr_lookup_general``, which the lookup and the voxel Function
    both launch, ``gru_iter_general`` and ``gru_iter_bf16``)."""
    return {f.__name__: f.launches for f in _wrappers()}


def zero_launch_counts() -> None:
    for f in _wrappers():
        f.launches = 0


# Wrapper name -> the device function it launches (csrc/*.cu), as the
# profiler names the kernel ("(anonymous namespace)::gru_kernel(float
# const*, ...)").
KERNEL_SYMBOLS = {"fused_corr_lookup": "corr_lookup_kernel",
                  "fused_gru_update": "gru_kernel",
                  "voxel_bin_means_pallas": "voxel_corr_kernel",
                  "corr_lookup_general": "corr_lookup_general_kernel",
                  "gru_iter_general": "gru_general_kernel",
                  "gru_iter_bf16": "gru_bf16_kernel"}


def kernel_of(event_name: str):
    """The wrapper whose kernel a profiler event names, or None."""
    for wrapper, symbol in KERNEL_SYMBOLS.items():
        if re.search(rf"(^|[\s:]){symbol}[(<]", event_name):
            return wrapper
    return None


# The marker kernel that frames a profiler window's work
# (``torch.cuda._sleep``); the head markers of each try of a window; and
# the windows :func:`device_kernels` opened, those it ran again, and the
# head markers the profiler lost.
MARKER_KERNEL = "spin_kernel"
HEAD_MARKERS = (256, 4096, 32768)
window_counts = collections.Counter()


def device_kernels(fn: Callable[[], Any]) -> Tuple[Any, List[str]]:
    """Run ``fn()`` in a ``torch.profiler`` (CUPTI) window and return its
    result and the names of the device activities the card ran for it
    (kernels, copies, replayed ones included), in start order.

    The profiler can drop the first records of a window, from a dozen to
    a thousand (``profiling/windows.py``). So the window waits
    ``profiling/timers.py::PROFILER_LEAD_S``, launches head markers
    (:data:`MARKER_KERNEL`), runs ``fn()`` between synchronizes, then
    one tail marker and the wait again. The records are whole when a
    head marker and the tail marker survive; else the window runs again
    with more head markers, :data:`HEAD_MARKERS` in turn; then
    RuntimeError."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pvraft_tpu_torch.profiling.timers import PROFILER_LEAD_S

    lost = []
    for markers in HEAD_MARKERS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_LEAD_S)
            for _ in range(markers):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(PROFILER_LEAD_S)
        window_counts["windows"] += 1
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        work = [i for i, n in enumerate(names) if MARKER_KERNEL not in n]
        seen = len(names) - len(work)
        if work:
            head, tail = work[0], len(names) - 1 - work[-1]
            whole = head >= 1 and tail == 1 and seen == head + 1
        else:
            head, whole = max(seen - 1, 0), seen == markers + 1
        window_counts["head_markers_lost"] += markers - head
        if whole:
            return out, [names[i] for i in work]
        window_counts["run_again"] += 1
        lost.append({"head_markers": markers, "seen": seen,
                     "activities": len(names), "first": names[:2],
                     "last": names[-2:]})
    raise RuntimeError(f"the profiler lost the head or the tail marker in "
                       f"each of {len(HEAD_MARKERS)} windows, no count is "
                       f"whole: {lost}")


def measured_launches(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """Run ``fn()`` under :func:`device_kernels`; returns its result
    and, per wrapper, the kernels of :data:`KERNEL_SYMBOLS` that the card
    ran meanwhile: eager launches and those a CUDA graph's replay made
    alike."""
    out, names = device_kernels(fn)
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for name in names:
        wrapper = kernel_of(name)
        if wrapper is not None:
            counts[wrapper] += 1
    return out, counts
