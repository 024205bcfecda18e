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
``r``, bitwise equal where it holds).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import struct
import subprocess
from typing import Dict

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
# Candidates per query point the voxel and lookup kernels take: 16 per
# lane of the point's warp, 4 groups of 4 (kMaxPerLane, csrc/voxel_bins.cuh).
MAX_CANDIDATES = 512
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
