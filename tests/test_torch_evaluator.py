"""The port's standalone evaluator against the JAX package's, on the CPU.

Both evaluators load the same msgpack checkpoint (written by the JAX
package) and run the reference protocol (one scene per step, running
means) on the same synthetic scenes (seed 2) at 2 GRU iterations: the
means agree at the model bar (``PARITY.md:8-15``, 2e-4). The port
accepts ``eval_scan`` and changes nothing by it (a replay of the captured
eval step is one launch per scene already); ``--dump_dir`` writes the reference's
``<dataset>/<idx>/{pc1,pc2,flow}.npy`` layout; the eval CLI prints the
evaluator's means and rejects the flags of later slices.
"""

import json
import os

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
from pvraft_tpu.engine import checkpoint as jckpt
from pvraft_tpu.engine.evaluator import Evaluator as JEvaluator
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.parallel.mesh import make_mesh
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import test as tcli
from pvraft_tpu_torch.data import SyntheticDataset
from pvraft_tpu_torch.engine.evaluator import Evaluator

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, ITERS = 48, 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX-written checkpoint of seeded tiny weights."""
    x = np.random.default_rng(8).uniform(-1, 1, (1, N, 3)).astype(np.float32)
    params = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                     static_argnums=3)(jax.random.key(8), jnp.asarray(x),
                                       jnp.asarray(x), 1)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save_checkpoint(d, params, optax.adam(1e-3).init(params), 3,
                          checkpoint_interval=0, best=True)
    return jckpt.find_checkpoint(d, "best_checkpoint")


def _cfg(size=3, **train):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=size),
        train=tconfig.TrainConfig(eval_iters=ITERS, **train))


def test_evaluator_means_match_jax(jax_checkpoint, tmp_path):
    jcfg = JCfg(model=JConfig(use_pallas=False, **TINY),
                data=JDataConfig(dataset="synthetic", max_points=N,
                                 synthetic_size=3, num_workers=0),
                train=JTrainConfig(eval_iters=ITERS),
                exp_path=str(tmp_path / "jax"))
    jev = JEvaluator(jcfg, mesh=make_mesh(n_data=1))
    try:
        jev.load(jax_checkpoint)
        want = jev.run()
    finally:
        jev.close()
    ev = Evaluator(_cfg(), device="cpu")
    assert ev.load(jax_checkpoint) == 3
    got = ev.run()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4,
                                   err_msg=k)


def test_eval_scan_equals_one_scene_per_step_bitwise(jax_checkpoint):
    """``eval_scan`` is accepted (configs shared with the JAX package
    load) and leaves the program and the means as they are: 5 scenes at
    eval_scan 2 against eval_scan 1, bitwise."""
    runs = {}
    for scan in (1, 2):
        ev = Evaluator(_cfg(size=5, eval_scan=scan), device="cpu")
        ev.load(jax_checkpoint)
        runs[scan] = ev.run()
        assert [r["name"].split("[")[0] for r in ev.compile_report()] == [
            "eval_step"]
    assert runs[1] == runs[2]


def test_dump_writes_the_reference_layout(jax_checkpoint, tmp_path):
    ev = Evaluator(_cfg(eval_scan=2), device="cpu")
    ev.load(jax_checkpoint)
    means = ev.run(dump_dir=str(tmp_path))
    assert means == ev.run()
    ds = SyntheticDataset(size=3, nb_points=N, noise=0.01, seed=2)
    assert sorted(os.listdir(tmp_path / "synthetic")) == ["0", "1", "2"]
    for i in range(3):
        scene = tmp_path / "synthetic" / str(i)
        assert sorted(os.listdir(scene)) == ["flow.npy", "pc1.npy", "pc2.npy"]
        np.testing.assert_array_equal(np.load(scene / "pc1.npy"), ds[i]["pc1"])
        np.testing.assert_array_equal(np.load(scene / "pc2.npy"), ds[i]["pc2"])
        flow = np.load(scene / "flow.npy")
        assert flow.shape == (N, 3) and np.isfinite(flow).all()


def test_eval_cli_prints_the_means(jax_checkpoint, capsys, monkeypatch):
    args = ["--dataset", "synthetic", "--device", "cpu", "--max_points",
            str(N), "--synthetic_size", "3", "--truncate_k", "16",
            "--corr_knn", "8", "--eval_iters", str(ITERS), "--weights",
            jax_checkpoint]
    tcli.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    # test.py has no --graph_k: the CLI runs the default 32-NN graph.
    cfg = _cfg()
    ev = Evaluator(cfg.replace(model=tconfig.ModelConfig(truncate_k=16,
                                                         corr_knn=8)),
                   device="cpu")
    ev.load(jax_checkpoint)
    assert len(lines) == 1 and json.loads(lines[0]) == ev.run()
    # A seq axis of 2 (stage 2 included) on one process: the mesh refuses
    # it, having no ranks to cover it.
    with pytest.raises(ValueError, match=">= 1 device"):
        tcli.main(args + ["--refine", "--seq_parallel", "2"])
    # The default dataset is FT3D, which needs its tree at ``root``.
    with pytest.raises(RuntimeError, match="expected 3824 test scenes"):
        Evaluator(tconfig.Config(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(_cfg())
