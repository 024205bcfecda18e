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

The two voxel kernels (``csrc/corr_lookup.cu`` and ``csrc/voxel_corr.cu``,
binning in ``csrc/voxel_bins.cuh``) run one warp per query point, 16
candidates per lane in registers, so they take up to
:data:`MAX_CANDIDATES` candidates per point. Two host-side facts choose
their paths, both computing the same values: :func:`vector_loads` (16-byte
loads, else scalar loads of the same slots) and
:func:`reciprocal_is_exact` (multiply by ``1/r`` instead of dividing by
``r``, bitwise equal where it holds). :func:`kernel_takes` says which
model configurations each kernel takes; under ``use_pallas=None`` a
CUDA tensor with a configuration that a kernel does not take raises and
names ``use_pallas=False`` (``config.py::resolve_use_pallas``).

Launch counts: each wrapper's ``launches`` attribute counts its eager
launches, where it launches its kernel. A launch made while a CUDA graph
is being captured is recorded into the graph, not run: the wrapper
counts it into :data:`captured` instead, and the program keeps that
share (``serve/aot.py::GraphProgram.launches``). What a replay launches
is measured, not inferred: :func:`measured_launches` runs a function
under ``torch.profiler`` and counts the card's kernels by their device
symbols (:data:`KERNEL_SYMBOLS`), replayed ones included. A kernel's
first launch on a device builds and loads its library and, for the GRU
kernel, opts in to its shared memory; :func:`check_capturable` refuses a
capture before that first eager launch.
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
from typing import Any, Callable, Dict, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
# Candidates per query point the voxel and lookup kernels take: 16 per
# lane of the point's warp, 4 groups of 4 (kMaxPerLane, csrc/voxel_bins.cuh).
MAX_CANDIDATES = 512
MAX_KNN = 32           # the lookup's kNN: a sorted (distance, index) per lane
RESOLUTION = 3         # the voxel kernels' cube: 27 cells per level
GRU_WIDTH = 64         # the GRU kernel's hidden, context and feature width
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
    return libs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    return ctypes.CDLL(build_all()[name])


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Check device, dtype and contiguity of a kernel's float32 operands."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{what}: every operand must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: expected float32, got {t.dtype}")
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


def kernel_takes(cfg) -> Dict[str, bool]:
    """Kernel name -> whether that CUDA kernel takes ``cfg``'s shapes (a
    ``ModelConfig``): K (``truncate_k``) <= MAX_CANDIDATES and a
    resolution of RESOLUTION for the two voxel kernels, ``corr_knn`` <=
    MAX_KNN for the lookup, hidden and context widths of GRU_WIDTH for
    the GRU kernel."""
    voxel = cfg.truncate_k <= MAX_CANDIDATES and cfg.resolution == RESOLUTION
    return {"corr_lookup": voxel and cfg.corr_knn <= MAX_KNN,
            "voxel_corr": voxel,
            "gru_iter": cfg.hidden_dim == cfg.context_dim == GRU_WIDTH}


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
    from pvraft_tpu_torch.ops.cuda.corr_lookup import fused_corr_lookup
    from pvraft_tpu_torch.ops.cuda.gru_iter import fused_gru_update
    from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas

    return (fused_corr_lookup, fused_gru_update, voxel_bin_means_pallas)


def launch_counts() -> Dict[str, int]:
    """Wrapper name -> eager kernel launches since the last
    :func:`zero_launch_counts`."""
    return {f.__name__: f.launches for f in _wrappers()}


def zero_launch_counts() -> None:
    for f in _wrappers():
        f.launches = 0


# Wrapper name -> the device function it launches (csrc/*.cu), as the
# profiler names the kernel ("(anonymous namespace)::gru_kernel(float
# const*, ...)").
KERNEL_SYMBOLS = {"fused_corr_lookup": "corr_lookup_kernel",
                  "fused_gru_update": "gru_kernel",
                  "voxel_bin_means_pallas": "voxel_corr_kernel"}


def kernel_of(event_name: str):
    """The wrapper whose kernel a profiler event names, or None."""
    for wrapper, symbol in KERNEL_SYMBOLS.items():
        if re.search(rf"(^|[\s:]){symbol}[(<]", event_name):
            return wrapper
    return None


def measured_launches(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """Run ``fn()`` under ``torch.profiler`` (CUPTI) with a synchronize
    at its end; returns its result and, per wrapper, the kernels of
    :data:`KERNEL_SYMBOLS` that the card ran meanwhile: eager launches
    and those a CUDA graph's replay made alike."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            wrapper = kernel_of(e.name)
            if wrapper is not None:
                counts[wrapper] += 1
    return out, counts
