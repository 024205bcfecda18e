"""The port's Trainer, Evaluator and CLIs on FT3D and KITTI trees, on the
CPU, against the JAX package's.

Tiny trees in the preprocessed layouts under ``tmp_path``: the Trainer
trains an FT3D tree through its loaders (the native assembler where
``g++`` builds it), writes ``last_checkpoint`` and takes the first batch
of the JAX Trainer's train loader bitwise; the threaded loader trains
bitwise like the serial one over two epochs of the graphed steps; the Evaluator on a
KITTI tree gives the JAX Evaluator's means at the model bar of
``tests/test_torch_evaluator.py`` (2e-4) from the same checkpoint; both
CLIs take ``--root``, ``--num_workers`` and ``--no_strict_sizes``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import Config as JCfg
from pvraft_tpu.config import DataConfig as JDataConfig
from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.config import TrainConfig as JTrainConfig
from pvraft_tpu.data import PrefetchLoader as JPrefetchLoader
from pvraft_tpu.engine import checkpoint as jckpt
from pvraft_tpu.engine.evaluator import Evaluator as JEvaluator
from pvraft_tpu.engine.trainer import build_datasets as jbuild_datasets
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.parallel.mesh import make_mesh
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import test as test_cli
from pvraft_tpu_torch import train as train_cli
from pvraft_tpu_torch.data import first_batch
from pvraft_tpu_torch.engine.evaluator import Evaluator
from pvraft_tpu_torch.engine.trainer import Trainer, build_datasets
from torch_engines import close_engines  # noqa: F401  (autouse)

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, ITERS = 48, 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """FT3D: 7 train scenes (scene 2 too small), 2 test scenes; KITTI:
    scenes 2, 3 and 7 of the 142-scene subset with ground and far rows,
    and scene 0 outside it."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    for split, count in (("train", 7), ("val", 2)):
        for i in range(count):
            scene = root / "ft3d" / split / f"{i:07d}"
            scene.mkdir(parents=True)
            n = 30 if split == "train" and i == 2 else N + 8 * i
            pc1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            pc2 = pc1 + rng.normal(0, 0.05, pc1.shape).astype(np.float32)
            np.save(scene / "pc1.npy", pc1)
            np.save(scene / "pc2.npy", pc2)
    for i in (0, 2, 3, 7):
        scene = root / "kitti" / f"{i:06d}"
        scene.mkdir(parents=True)
        n = N + 20
        pc1 = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                        rng.uniform(1, 30, n)], 1).astype(np.float32)
        pc2 = pc1 + rng.normal(0, 0.05, pc1.shape).astype(np.float32)
        pc1[:5, 1] = pc2[:5, 1] = -2.0
        pc2[5:9, 2] = 40.0
        np.save(scene / "pc1.npy", pc1)
        np.save(scene / "pc2.npy", pc2)
    return {"ft3d": str(root / "ft3d"), "kitti": str(root / "kitti")}


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    x = np.random.default_rng(8).uniform(-1, 1, (1, N, 3)).astype(np.float32)
    params = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                     static_argnums=3)(jax.random.key(8), jnp.asarray(x),
                                       jnp.asarray(x), 1)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save_checkpoint(d, params, optax.adam(1e-3).init(params), 3,
                          checkpoint_interval=0, best=True)
    return jckpt.find_checkpoint(d, "best_checkpoint")


def _cfg(trees, tmp_path, dataset="FT3D", workers=2, native=True, epochs=1):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset=dataset,
                                root=trees[dataset.lower()], max_points=N,
                                num_workers=workers, native_loader=native,
                                strict_sizes=False),
        train=tconfig.TrainConfig(batch_size=2, num_epochs=epochs,
                                  iters=ITERS, eval_iters=ITERS,
                                  checkpoint_interval=1),
        exp_path=str(tmp_path / "exp"))


def test_trainer_trains_an_ft3d_tree(trees, tmp_path):
    native = shutil.which("g++") is not None
    cfg = _cfg(trees, tmp_path, native=native)
    jcfg = JCfg(data=JDataConfig(dataset="FT3D", root=trees["ft3d"],
                                 max_points=N, num_workers=2,
                                 native_loader=native, strict_sizes=False))
    # The JAX Trainer's train loader on one process, built with the
    # Trainer's own arguments (pvraft_tpu/engine/trainer.py:195-204).
    jloader = JPrefetchLoader(
        jbuild_datasets(jcfg)[0], 2, shuffle=True, drop_last=True,
        num_workers=jcfg.data.num_workers, seed=jcfg.train.seed,
        native=jcfg.data.native_loader, shard=(0, 1))
    assert jloader.native == native
    want = next(iter(jloader.epoch(0)))
    tr = Trainer(cfg, device="cpu")
    assert tr.train_loader.native == native
    assert [len(tr.train_ds), len(tr.val_ds), len(tr.test_ds)] == [6, 1, 2]
    assert tr.steps_per_epoch == 3
    got = first_batch(tr.train_loader)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    test = tr.fit()
    assert all(np.isfinite(v) for v in test.values())
    out = tr.training(1)
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
    assert os.path.exists(os.path.join(cfg.exp_path, "checkpoints",
                                       "last_checkpoint.msgpack"))


def test_threaded_loader_trains_bitwise_like_the_serial_one(trees, tmp_path):
    """Two epochs of the graphed steps (their CPU programs) fed by 2
    threads and by the serial loader: losses and parameters bitwise."""
    runs = {}
    for workers in (0, 2):
        tr = Trainer(_cfg(trees, tmp_path / str(workers), workers=workers,
                          native=False), device="cpu")
        losses = tr.training(0)["losses"] + tr.training(1)["losses"]
        runs[workers] = (losses, {n: p.detach().clone()
                                  for n, p in tr.model.named_parameters()})
    assert len(runs[0][0]) == 6 and runs[0][0] == runs[2][0]
    assert all(torch.equal(runs[0][1][n], runs[2][1][n]) for n in runs[0][1])


def test_evaluator_on_a_kitti_tree_matches_jax(trees, tmp_path,
                                               jax_checkpoint):
    jcfg = JCfg(model=JConfig(use_pallas=False, **TINY),
                data=JDataConfig(dataset="KITTI", root=trees["kitti"],
                                 max_points=N, num_workers=0,
                                 strict_sizes=False),
                train=JTrainConfig(eval_iters=ITERS),
                exp_path=str(tmp_path / "jax"))
    jev = JEvaluator(jcfg, mesh=make_mesh(n_data=1))
    try:
        jev.load(jax_checkpoint)
        want = jev.run()
        n_jax = len(jev.dataset)
    finally:
        jev.close()
    ev = Evaluator(_cfg(trees, tmp_path, dataset="KITTI"), device="cpu")
    assert len(ev.dataset) == n_jax == 3
    assert ev.loader.num_workers == 2 and not ev.loader.native
    ev.load(jax_checkpoint)
    got = ev.run()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4,
                                   err_msg=k)


def test_build_datasets_raises_for_kitti(trees, tmp_path):
    with pytest.raises(NotImplementedError, match="eval-only"):
        build_datasets(_cfg(trees, tmp_path, dataset="KITTI"))
    with pytest.raises(NotImplementedError, match="eval-only"):
        Trainer(_cfg(trees, tmp_path, dataset="KITTI"), device="cpu")


def test_clis_take_the_data_flags(trees, tmp_path, jax_checkpoint, capsys):
    a = train_cli.parse_args(["--root", trees["ft3d"], "--num_workers", "3",
                              "--no_strict_sizes"])
    d = train_cli.config_from_args(a).data
    assert (d.dataset, d.root, d.num_workers, d.strict_sizes,
            d.native_loader) == ("FT3D", trees["ft3d"], 3, False, True)
    train_cli.main(["--root", trees["ft3d"], "--no_strict_sizes",
                    "--num_workers", "2", "--device", "cpu",
                    "--exp_path", str(tmp_path / "exp"),
                    "--max_points", str(N), "--truncate_k", "16",
                    "--corr_knn", "8", "--iters", "1", "--eval_iters", "1",
                    "--num_epochs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["train"]["steps"] == 3
    args = ["--dataset", "KITTI", "--root", trees["kitti"],
            "--no_strict_sizes", "--num_workers", "1", "--device", "cpu",
            "--max_points", str(N), "--truncate_k", "16", "--corr_knn", "8",
            "--eval_iters", str(ITERS), "--weights", jax_checkpoint]
    test_cli.main(args)
    out = capsys.readouterr().out.strip().splitlines()
    cfg = test_cli.config_from_args(test_cli.parse_args(args))
    assert (cfg.data.root, cfg.data.num_workers, cfg.data.strict_sizes) == (
        trees["kitti"], 1, False)
    ev = Evaluator(cfg, device="cpu")
    ev.load(jax_checkpoint)
    assert len(out) == 1 and json.loads(out[0]) == ev.run()


def test_train_cli_trains_without_a_compiler(trees, tmp_path, monkeypatch,
                                             capsys):
    """Where no g++ builds the native loader, the train CLI raises naming
    ``--no_native_loader``, and with that flag it trains from the threaded
    numpy loader."""
    from pvraft_tpu_torch import native as tnative

    monkeypatch.setattr(tnative, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    tnative.library.cache_clear()
    argv = ["--root", trees["ft3d"], "--no_strict_sizes", "--num_workers",
            "2", "--device", "cpu", "--exp_path", str(tmp_path / "exp"),
            "--max_points", str(N), "--truncate_k", "16", "--corr_knn", "8",
            "--iters", "1", "--eval_iters", "1", "--num_epochs", "1"]
    try:
        with pytest.raises(tnative.NativeBuildError,
                           match="--no_native_loader"):
            train_cli.main(argv)
        a = train_cli.parse_args(argv + ["--no_native_loader"])
        assert not train_cli.config_from_args(a).data.native_loader
        train_cli.main(argv + ["--no_native_loader"])
    finally:
        tnative.library.cache_clear()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["train"]["steps"] == 3
    assert np.isfinite(json.loads(lines[1])["test"]["epe3d"])
