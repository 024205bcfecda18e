"""ctypes bindings of the port's native data plane (``npy_loader.cc``).

The library is built at first use, never when a module is imported:
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` compiles ``npy_loader.cc``
into ``pvraft_tpu_torch/_build/<hash of flags and source>/
libpvraft_native.so`` (a directory ``.gitignore`` lists), as
``ops/cuda`` builds the CUDA kernels. A build failure raises
:class:`NativeBuildError`, which names ``native_loader=False``
(``--no_native_loader`` on the train CLI; the threaded numpy loader) as
the way to go without a compiler: a loader that
asked for the native path never falls back to numpy quietly, since the two
paths draw different subsamples.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "npy_loader.cc")
BUILD_ROOT = os.path.join(os.path.dirname(HERE), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIB_NAME = "libpvraft_native.so"
# How to take the threaded numpy loader instead, for every caller.
NO_NATIVE = ("pass native_loader=False (DataConfig), --no_native_loader "
             "(python -m pvraft_tpu_torch.train) or native=False "
             "(PrefetchLoader) for the threaded numpy loader")


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def _build(path: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            "the native loader needs g++ to build npy_loader.cc and none is "
            f"on PATH: {NO_NATIVE}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"building {SOURCE} failed: {NO_NATIVE}\n{proc.stderr}")
    os.replace(tmp, path)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first where it is missing."""
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(
            f"loading {path} failed: {NO_NATIVE}: {e}") from e
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.pvraft_npy_shape.restype = ctypes.c_long
    lib.pvraft_npy_shape.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_long)]
    lib.pvraft_npy_read_f32.restype = ctypes.c_long
    lib.pvraft_npy_read_f32.argtypes = [
        ctypes.c_char_p, f32, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.pvraft_load_scene_batch.restype = None
    lib.pvraft_load_scene_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        f32, f32, f32, f32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
    ]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        library()
    except NativeBuildError:
        return False
    return True


def npy_shape(path: str) -> Tuple[int, int]:
    """(rows, cols) of a float ``.npy`` without reading its payload."""
    cols = ctypes.c_long(0)
    rows = library().pvraft_npy_shape(path.encode(), ctypes.byref(cols))
    if rows < 0:
        raise IOError(f"pvraft_npy_shape({path}) failed: {rows}")
    return int(rows), int(cols.value)


def npy_read(path: str) -> np.ndarray:
    """A float ``.npy`` read as float32 by the native reader."""
    rows, cols = npy_shape(path)
    out = np.empty(rows * cols, np.float32)
    cols_out = ctypes.c_long(0)
    got = library().pvraft_npy_read_f32(path.encode(), out, out.size,
                                        ctypes.byref(cols_out))
    if got < 0:
        raise IOError(f"pvraft_npy_read_f32({path}) failed: {got}")
    return out.reshape(rows, cols) if cols > 1 else out


def load_scene_batch(pc1_paths: Sequence[str], pc2_paths: Sequence[str],
                     scene_indices: Sequence[int], n_points: int,
                     max_rows: int, seed: int, epoch: int, flip_xz: bool,
                     filter_mode: int = 0, n_threads: int = 4):
    """Threaded native batch assembly. Returns (pc1, pc2, mask, flow,
    status): status[i] is 1 for a filled row, 0 for a scene with too few
    points, < 0 for an error. filter_mode 0: none; 1: the KITTI ground
    and far filter."""
    lib = library()
    n = len(pc1_paths)
    if len(pc2_paths) != n or len(scene_indices) != n:
        raise ValueError(f"{n} pc1 paths, {len(pc2_paths)} pc2 paths and "
                         f"{len(scene_indices)} scene indices")
    out_pc1 = np.empty((n, n_points, 3), np.float32)
    out_pc2 = np.empty((n, n_points, 3), np.float32)
    out_mask = np.empty((n, n_points), np.float32)
    out_flow = np.empty((n, n_points, 3), np.float32)
    status = np.zeros((n,), np.int32)
    idx = np.asarray(scene_indices, np.int64)
    lib.pvraft_load_scene_batch(
        b"\0".join(p.encode() for p in pc1_paths) + b"\0",
        b"\0".join(p.encode() for p in pc2_paths) + b"\0",
        idx, n, n_points, max_rows, seed, epoch, int(flip_xz),
        int(filter_mode), out_pc1, out_pc2, out_mask, out_flow, status,
        n_threads)
    return out_pc1, out_pc2, out_mask, out_flow, status
