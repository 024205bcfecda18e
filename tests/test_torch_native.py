"""The port's native data plane against the JAX package's, on the CPU.

The port builds its own copy of the C++ assembler
(``pvraft_tpu_torch/native/npy_loader.cc``) into
``pvraft_tpu_torch/_build/``; its ``npy_read`` and ``load_scene_batch``
(flip, KITTI filter, rejection status, errors) give the JAX library's
bytes. A build that cannot happen raises an error naming
``native_loader=False``; nothing falls back to numpy. The tests that build
skip without ``g++``, as ``tests/test_native.py`` does.
"""

import os
import shutil

import numpy as np
import pytest

import pvraft_tpu.native as jnative
from pvraft_tpu_torch import native as tnative
from pvraft_tpu_torch.data import PrefetchLoader, SyntheticDataset


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("the native library needs g++")
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build")


def test_library_builds_under_the_ports_build_dir(gxx):
    lib = tnative.library()
    path = os.path.realpath(lib._name)
    build = os.path.realpath(os.path.join(
        os.path.dirname(tnative.__file__), "..", "_build"))
    assert path.startswith(build + os.sep), path
    assert path == os.path.realpath(tnative.library_path())
    assert os.path.basename(path) == "libpvraft_native.so"
    assert tnative.native_available()
    assert lib is tnative.library()


@pytest.mark.parametrize("dtype,shape", [(np.float32, (37, 3)),
                                         (np.float64, (5, 3)),
                                         (np.float32, (11,))])
def test_npy_read_matches_jax(gxx, tmp_path, dtype, shape):
    arr = np.random.default_rng(0).normal(size=shape).astype(dtype)
    p = str(tmp_path / "a.npy")
    np.save(p, arr)
    got, want = tnative.npy_read(p), jnative.npy_read(p)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr.astype(np.float32))
    assert tnative.npy_shape(p) == jnative.npy_shape(p)


def test_npy_read_errors_as_jax(gxx, tmp_path):
    p = str(tmp_path / "ints.npy")
    np.save(p, np.arange(6, dtype=np.int32))
    for mod in (tnative, jnative):
        with pytest.raises(IOError, match="failed: -2"):
            mod.npy_shape(p)
        with pytest.raises(IOError, match="failed: -1"):
            mod.npy_shape(str(tmp_path / "missing.npy"))


def _scenes(tmp_path, counts, seed, kitti=False):
    rng = np.random.default_rng(seed)
    p1, p2 = [], []
    for i, n in enumerate(counts):
        pc1 = rng.normal(size=(n, 3)).astype(np.float32)
        pc2 = (pc1 + rng.normal(0, 0.1, (n, 3))).astype(np.float32)
        if kitti:
            pc1[:, 2] = np.abs(pc1[:, 2]) * 20
            pc1[: n // 4, 1] = pc2[: n // 4, 1] = -2.0       # ground
            pc2[n // 4: n // 3, 2] = 40.0                     # far
        p1.append(str(tmp_path / f"s{i}_pc1.npy"))
        p2.append(str(tmp_path / f"s{i}_pc2.npy"))
        np.save(p1[-1], pc1)
        np.save(p2[-1], pc2)
    return p1, p2


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("flip,filter_mode", [(True, 0), (False, 0),
                                              (False, 1)])
def test_load_scene_batch_matches_jax(gxx, tmp_path, flip, filter_mode,
                                      threads):
    """Four scenes, one of them (12 rows) below the 32 points asked for:
    status 0 there, 1 for the larger ones, the JAX library's statuses, and
    the JAX library's bytes in every filled row."""
    p1, p2 = _scenes(tmp_path, (64, 12, 80, 200), seed=filter_mode,
                     kitti=filter_mode == 1)
    args = (p1, p2, [4, 9, 2, 7], 32, 1024)
    kw = dict(seed=5, epoch=3, flip_xz=flip, filter_mode=filter_mode,
              n_threads=threads)
    got = tnative.load_scene_batch(*args, **kw)
    want = jnative.load_scene_batch(*args, **kw)
    np.testing.assert_array_equal(got[-1], want[-1])
    status = got[-1].tolist()
    assert status[1] == 0 and status[2:] == [1, 1]
    if filter_mode == 0:
        assert status[0] == 1
    # A rejected row's slot is left unwritten: compare the filled rows.
    ok = got[-1] == 1
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a[ok], b[ok])
    np.testing.assert_array_equal(got[2][ok], 1.0)
    # Another epoch draws another subsample, in both libraries alike.
    other = tnative.load_scene_batch(*args, **{**kw, "epoch": 4})
    assert not np.array_equal(other[0][ok], got[0][ok])
    np.testing.assert_array_equal(
        other[0][ok],
        jnative.load_scene_batch(*args, **{**kw, "epoch": 4})[0][ok])


def test_load_scene_batch_errors_as_jax(gxx, tmp_path):
    """Status -1 for a missing pc1, -2 for a missing pc2, -3 for clouds
    of different lengths under the KITTI filter."""
    p1, p2 = _scenes(tmp_path, (40, 40, 40), seed=3)
    np.save(p2[2], np.zeros((39, 3), np.float32))
    paths1 = [str(tmp_path / "none.npy"), p1[1], p1[2]]
    paths2 = [p2[0], str(tmp_path / "none.npy"), p2[2]]
    for mod in (tnative, jnative):
        status = mod.load_scene_batch(paths1, paths2, [0, 1, 2], 16, 64,
                                      seed=0, epoch=0, flip_xz=False,
                                      filter_mode=1)[-1]
        assert status.tolist() == [-1, -2, -3]
    with pytest.raises(ValueError, match="scene indices"):
        tnative.load_scene_batch(p1, p2, [0], 16, 64, seed=0, epoch=0,
                                 flip_xz=False)


def test_a_build_failure_names_native_loader_false(tmp_path, monkeypatch):
    """No compiler: the library raises naming ``native_loader=False``, and
    a loader that asked for the native path raises with it; nothing falls
    back to numpy."""
    monkeypatch.setattr(tnative, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    tnative.library.cache_clear()
    try:
        with pytest.raises(tnative.NativeBuildError,
                           match="native_loader=False"):
            tnative.library()
        assert not tnative.native_available()

        class Native(SyntheticDataset):
            def native_paths(self, idx):
                return ("pc1.npy", "pc2.npy", False, 0)

        with pytest.raises(tnative.NativeBuildError,
                           match="native_loader=False"):
            PrefetchLoader(Native(size=4, nb_points=8), 2, native=True)
        loader = PrefetchLoader(Native(size=4, nb_points=8), 2, native=False)
        assert not loader.native and len(list(loader.epoch(0))) == 2
    finally:
        tnative.library.cache_clear()
