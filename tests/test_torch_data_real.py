"""The port's FT3D and KITTI readers and its loaders against the JAX
package's, on the CPU.

Tiny trees in the datasets' preprocessed layouts under ``tmp_path`` (as
``tests/test_real_data_e2e.py`` builds them): the file lists, the
train/val split, the items and every loader epoch (serial, 2 threads,
native; shuffle on and off; ``drop_last`` on and off; two epochs; shards
(0, 2) and (1, 2)) are bitwise equal to ``pvraft_tpu.data``'s for the same
arguments. The native and numpy paths draw different subsamples by
design, so each is held against the JAX package's same path. The native
cases need ``g++`` and skip without it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import pvraft_tpu.data as jdata
from pvraft_tpu.data import kitti as jkitti
from pvraft_tpu.data import flyingthings3d as jft3d
from pvraft_tpu_torch import data as tdata
from pvraft_tpu_torch.data import flyingthings3d as tft3d
from pvraft_tpu_torch.data import kitti as tkitti

N = 32


def make_ft3d_tree(root, n_train=12, n_test=3, seed=0):
    """``train/`` and ``val/`` scenes of 40-95 rows; train scenes 3 and 8
    hold 20 rows, below N, for reject-and-advance."""
    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("val", n_test)):
        for i in range(count):
            scene = root / split / f"{i:07d}"
            scene.mkdir(parents=True)
            n = 20 if split == "train" and i in (3, 8) else 40 + 5 * i
            pc1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            pc2 = pc1 + rng.normal(0, 0.05, pc1.shape).astype(np.float32)
            np.save(scene / "pc1.npy", pc1)
            np.save(scene / "pc2.npy", pc2)
    return root


def make_kitti_tree(root, indices=(0, 2, 3, 7, 8, 9, 82, 199), seed=1):
    """Scenes with ground rows (y < -1.4 in both frames) and far rows
    (z >= 35 in one frame) among near ones; scenes 0 and 82 lie outside
    the 142-scene subset, scene 9 keeps fewer than N rows."""
    rng = np.random.default_rng(seed)
    for i in indices:
        scene = root / f"{i:06d}"
        scene.mkdir(parents=True)
        n = 30 if i == 9 else 60
        pc1 = np.stack([rng.uniform(-5, 5, n), rng.uniform(-1, 1, n),
                        rng.uniform(1, 30, n)], 1).astype(np.float32)
        pc2 = pc1 + rng.normal(0, 0.05, pc1.shape).astype(np.float32)
        pc1[:6, 1] = pc2[:6, 1] = -2.0            # ground in both frames
        pc1[6:8, 1] = -2.0                        # ground in one frame: kept
        pc2[8:11, 2] = 36.0                       # far in the second frame
        pc1[11, 2] = 35.0                         # far at the boundary
        np.save(scene / "pc1.npy", pc1)
        np.save(scene / "pc2.npy", pc2)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {"ft3d": str(make_ft3d_tree(root / "ft3d")),
            "kitti": str(make_kitti_tree(root / "kitti"))}


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("the native loader needs g++")


def _items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{i} {k}")


def _batches_equal(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype == np.float32
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_ft3d_file_lists_and_items_match_jax(trees, mode):
    got = tdata.FT3D(trees["ft3d"], N, mode, strict_sizes=False, seed=4)
    want = jdata.FT3D(trees["ft3d"], N, mode, strict_sizes=False, seed=4)
    assert got.filenames == want.filenames and len(got) > 0
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        _items_equal(got, want)
    for i in range(len(got)):
        assert got.native_paths(i) == want.native_paths(i)
        assert got.native_paths(i)[2:] == (True, 0)
        for a, b in zip(got.load_sequence(i), want.load_sequence(i)):
            np.testing.assert_array_equal(a, b)


def test_ft3d_split_at_full_size_matches_jax(tmp_path, monkeypatch):
    """The strict, full-size branch of the split (``FT3D_VAL_COUNT`` val
    scenes from ``np.linspace``), at sizes shrunk in both packages."""
    make_ft3d_tree(tmp_path, n_train=23, n_test=4)
    for mod in (tft3d, jft3d):
        monkeypatch.setattr(mod, "FT3D_TRAIN_SIZE", 23)
        monkeypatch.setattr(mod, "FT3D_TEST_SIZE", 4)
        monkeypatch.setattr(mod, "FT3D_VAL_COUNT", 5)
    for mode in ("train", "val", "test"):
        got = tdata.FT3D(str(tmp_path), N, mode)
        want = jdata.FT3D(str(tmp_path), N, mode)
        assert got.filenames == want.filenames
    assert len(tdata.FT3D(str(tmp_path), N, "val")) == 5


@pytest.mark.parametrize("mode,count", [("train", 19640), ("val", 19640),
                                        ("test", 3824)])
def test_ft3d_strict_sizes_raise_as_jax(trees, mode, count):
    with pytest.raises(RuntimeError, match=f"expected {count}") as got:
        tdata.FT3D(trees["ft3d"], N, mode)
    with pytest.raises(RuntimeError) as want:
        jdata.FT3D(trees["ft3d"], N, mode)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown mode"):
        tdata.FT3D(trees["ft3d"], N, "eval")


def test_kitti_eval_indices_equal_jax():
    assert tkitti.KITTI_EVAL_INDICES == jkitti.KITTI_EVAL_INDICES
    assert len(tkitti.KITTI_EVAL_INDICES) == 142
    assert tkitti.KITTI_SCENES == jkitti.KITTI_SCENES == 200


@pytest.mark.parametrize("mapping", [False, True])
def test_kitti_file_lists_and_items_match_jax(trees, tmp_path, mapping):
    """The default subset and a mapping file; the root reached through a
    symlink resolves to the same real paths."""
    path = None
    if mapping:
        path = str(tmp_path / "mapping.txt")
        lines = ["" if i in (2, 8) else f"2011_09_26 drive {i}"
                 for i in range(200)]
        with open(path, "w") as fd:
            fd.write("\n".join(lines) + "\n")
    link = tmp_path / "link"
    os.symlink(trees["kitti"], link)
    got = tdata.KITTI(str(link), N, strict_sizes=False, mapping_path=path,
                      seed=6)
    want = jdata.KITTI(str(link), N, strict_sizes=False, mapping_path=path,
                       seed=6)
    assert got.paths == want.paths
    names = [int(os.path.basename(p)) for p in got.paths]
    assert names == ([0, 3, 7, 9, 82, 199] if mapping else [2, 3, 7, 8, 9, 199])
    assert all(p.startswith(os.path.realpath(trees["kitti"]))
               for p in got.paths)
    for i in range(len(got)):
        assert got.native_paths(i) == want.native_paths(i)
        pc1, pc2, mask, flow = got.load_sequence(i)
        for a, b in zip((pc1, pc2, mask, flow), want.load_sequence(i)):
            np.testing.assert_array_equal(a, b)
        assert len(pc1) == (30 if names[i] == 9 else 60) - 10
    _items_equal(got, want)


def test_kitti_strict_sizes_raise_as_jax(trees):
    with pytest.raises(RuntimeError, match="expected 200 KITTI scenes") as got:
        tdata.KITTI(trees["kitti"], N)
    with pytest.raises(RuntimeError) as want:
        jdata.KITTI(trees["kitti"], N)
    assert str(got.value) == str(want.value)


def _datasets(trees, name):
    if name == "kitti":
        return (tdata.KITTI(trees["kitti"], N, strict_sizes=False, seed=2),
                jdata.KITTI(trees["kitti"], N, strict_sizes=False, seed=2))
    return (tdata.FT3D(trees["ft3d"], N, "train", strict_sizes=False, seed=2),
            jdata.FT3D(trees["ft3d"], N, "train", strict_sizes=False, seed=2))


PATHS = {"serial": {"num_workers": 0}, "threads": {"num_workers": 2},
         "native": {"num_workers": 2, "native": True}}


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_loader_epochs_match_jax(trees, request, path, shuffle, drop_last,
                                 shard):
    """Two epochs of the FT3D train split (11 scenes, two of them below N)
    at batch size 2 equal the JAX loader's bitwise. Sharded with
    ``drop_last=False``, 11 scenes do not fill whole global batches: both
    loaders refuse."""
    if path == "native":
        request.getfixturevalue("gxx")
    got_ds, want_ds = _datasets(trees, "ft3d")
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=9, shard=shard,
              **PATHS[path])
    if shard[1] > 1 and not drop_last:
        with pytest.raises(ValueError, match="silently dropped"):
            tdata.PrefetchLoader(got_ds, 2, **kw)
        with pytest.raises(ValueError, match="silently dropped"):
            jdata.PrefetchLoader(want_ds, 2, **kw)
        return
    got = tdata.PrefetchLoader(got_ds, 2, **kw)
    want = jdata.PrefetchLoader(want_ds, 2, **kw)
    assert got.native == want.native == (path == "native")
    assert len(got) == len(want)
    for epoch in (0, 1):
        batches = list(got.epoch(epoch))
        assert len(batches) == len(got)
        _batches_equal(batches, list(want.epoch(epoch)))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_kitti_loader_epochs_match_jax(trees, request, path):
    """KITTI through every path (the native one applies the ground and far
    filter in C++, and walks past scene 9, which keeps 20 rows)."""
    if path == "native":
        request.getfixturevalue("gxx")
    got_ds, want_ds = _datasets(trees, "kitti")
    kw = dict(shuffle=True, drop_last=False, seed=3, **PATHS[path])
    got = tdata.PrefetchLoader(got_ds, 4, **kw)
    want = jdata.PrefetchLoader(want_ds, 4, **kw)
    for epoch in (0, 1):
        _batches_equal(list(got.epoch(epoch)), list(want.epoch(epoch)))


def test_native_loader_holds_a_full_ft3d_frame(tmp_path, gxx):
    """A scene with a row for every pixel of a 540 x 960 frame, the most
    the FT3D preprocessor writes, loads through the native path: each row
    of the batch is a row of the scene, x and z flipped, and flow is pc2 -
    pc1 of the same row."""
    from pvraft_tpu_torch.data.loader import NATIVE_MAX_ROWS

    rows = 540 * 960
    assert NATIVE_MAX_ROWS >= rows
    rng = np.random.default_rng(3)
    pc1 = rng.uniform(-30, 30, (rows, 3)).astype(np.float32)
    pc1[:, 0] = np.arange(rows, dtype=np.float32)    # the row's index
    pc2 = pc1 + rng.normal(0, 0.1, pc1.shape).astype(np.float32)
    for split in ("train", "val"):
        scene = tmp_path / split / "0000000"
        scene.mkdir(parents=True)
        np.save(scene / "pc1.npy", pc1)
        np.save(scene / "pc2.npy", pc2)
    ds = tdata.FT3D(str(tmp_path), 4096, "test", strict_sizes=False, seed=1)
    batch = tdata.first_batch(
        tdata.PrefetchLoader(ds, 1, num_workers=1, native=True))
    row = (-batch["pc1"][0, :, 0]).astype(np.int64)
    assert len(np.unique(row)) == 4096 and row.max() < rows
    flip = np.array([-1, 1, -1], np.float32)
    np.testing.assert_array_equal(batch["pc1"][0], pc1[row] * flip)
    np.testing.assert_array_equal(batch["flow"][0],
                                  pc2[row] * flip - pc1[row] * flip)


def test_serial_batches_equal_the_loaders_serial_path(trees):
    """The port's serial loader against the JAX package's ``batches``."""
    from pvraft_tpu.data.generic import batches as jbatches

    ds, want_ds = _datasets(trees, "ft3d")
    loader = tdata.PrefetchLoader(ds, 3, shuffle=True, drop_last=False,
                                  num_workers=0, seed=1)
    _batches_equal(list(loader.epoch(2)),
                   list(jbatches(want_ds, 3, shuffle=True, drop_last=False,
                                 seed=1, epoch=2)))


def test_threaded_loader_raises_a_workers_error():
    class Broken(tdata.SyntheticDataset):
        def load_sequence(self, idx):
            if idx == 5:
                raise RuntimeError("boom")
            return super().load_sequence(idx)

    loader = tdata.PrefetchLoader(Broken(size=8, nb_points=16), 2,
                                  num_workers=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(loader.epoch(0))


def test_threaded_loader_raises_a_workers_base_exception():
    """A worker killed by a BaseException that is not an Exception still
    reaches the consumer, rather than leaving its batch missing."""
    class Halt(BaseException):
        pass

    class Broken(tdata.SyntheticDataset):
        def load_sequence(self, idx):
            if idx == 3:
                raise Halt("halt")
            return super().load_sequence(idx)

    loader = tdata.PrefetchLoader(Broken(size=8, nb_points=16), 2,
                                  num_workers=2)
    with pytest.raises(Halt, match="halt"):
        list(loader.epoch(0))


def test_native_on_a_dataset_without_native_paths_is_threaded():
    ds = tdata.SyntheticDataset(size=6, nb_points=16, seed=4)
    loader = tdata.PrefetchLoader(ds, 2, shuffle=True, num_workers=2,
                                  native=True, seed=7)
    assert not loader.native
    serial = tdata.PrefetchLoader(ds, 2, shuffle=True, num_workers=0, seed=7)
    _batches_equal(list(loader.epoch(1)), list(serial.epoch(1)))


def test_first_batch_is_epoch_zeros_and_stops_the_workers(trees):
    import threading

    ds, _ = _datasets(trees, "ft3d")
    before = threading.active_count()
    loader = tdata.PrefetchLoader(ds, 2, shuffle=True, num_workers=3, seed=5)
    first = tdata.first_batch(loader)
    serial = tdata.PrefetchLoader(ds, 2, shuffle=True, num_workers=0, seed=5)
    _batches_equal([first], list(serial.epoch(0))[:1])
    assert threading.active_count() == before


def test_device_prefetch_issues_the_next_copy_before_yielding():
    events = []

    def host():
        for i in range(4):
            events.append(("host", i))
            yield {"x": np.full((2,), i, np.float32)}

    def put(b):
        events.append(("put", int(b["x"][0])))
        return tdata.to_device(b, "cpu")

    got = []
    for b in tdata.device_prefetch(host(), put):
        got.append(int(b["x"][0]))
        events.append(("step", got[-1]))
    assert got == [0, 1, 2, 3]
    # Batch n+1's copy is issued before step n runs.
    for n in range(3):
        assert events.index(("put", n + 1)) < events.index(("step", n))
    t = tdata.to_device({"x": np.ones((2, 3), np.float32)}, "cpu")["x"]
    assert isinstance(t, torch.Tensor) and t.shape == (2, 3)
