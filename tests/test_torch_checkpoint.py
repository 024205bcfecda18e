"""The port's checkpoints against the JAX package's, on the CPU.

The port writes and reads the JAX package's msgpack checkpoints with a
codec of its own (``pvraft_tpu_torch/engine/msgpack.py``): its bytes
equal ``msgpack``'s and ``flax.serialization``'s on random payloads, and
it reads what they write. A checkpoint crosses between the packages
bitwise in both directions: the port's, read by the JAX Trainer with its
own templates (parameters, Adam's moments, both optax counts, the epoch),
and a JAX checkpoint after two optax Adam steps, read by the port's
Trainer; one more step on each side then agrees at the bar of
``tests/test_torch_train.py`` (parameters at atol 1e-6). A reference
``.params`` file is read as the JAX package reads it. A resumed run
equals the uninterrupted one bitwise, through ``Trainer`` and through the
train CLI's ``--resume``.
"""

import json
import os
import shutil

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import Config as JCfg
from pvraft_tpu.config import DataConfig as JDataConfig
from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.config import TrainConfig as JTrainConfig
from pvraft_tpu.engine import checkpoint as jckpt
from pvraft_tpu.engine.schedule import make_lr_schedule as jschedule
from pvraft_tpu.engine.trainer import Trainer as JTrainer
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.parallel.mesh import make_mesh
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import train as tcli
from pvraft_tpu_torch.engine import checkpoint as tckpt
from pvraft_tpu_torch.engine import msgpack as tmsgpack
from pvraft_tpu_torch.engine.steps import scheduled_step
from pvraft_tpu_torch.engine.trainer import Trainer
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
from pvraft_tpu_torch.weights import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_state_dict,
)

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, ITERS, LR_SCHEDULE = 48, 2, "cosine"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(exp_path, epochs=2, size=4, **train):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=size),
        train=tconfig.TrainConfig(num_epochs=epochs, iters=ITERS,
                                  eval_iters=ITERS, lr_schedule=LR_SCHEDULE,
                                  **train),
        exp_path=str(exp_path))


def _jcfg(exp_path, epochs=2, size=4):
    return JCfg(
        model=JConfig(use_pallas=False, **TINY),
        data=JDataConfig(dataset="synthetic", max_points=N,
                         synthetic_size=size, num_workers=0),
        train=JTrainConfig(num_epochs=epochs, iters=ITERS, eval_iters=ITERS,
                           lr_schedule=LR_SCHEDULE),
        exp_path=str(exp_path))


def _leaves(tree, prefix=""):
    """(path, numpy leaf) of a nested mapping, sorted by path."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _assert_trees_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


# --- the codec ---------------------------------------------------------------


def _random_payload(rng, depth=0):
    """A flax-serializable tree: str-keyed maps (sorted, as flax writes
    them) of arrays of several dtypes and shapes (0-d and empty
    included), numpy scalars, ints across every width, floats, strings,
    bytes, bools, None and lists."""
    out = {}
    for i in range(int(rng.integers(3, 7))):
        kind = int(rng.integers(0, 9 if depth < 2 else 8))
        key = f"k{i}_" + "x" * int(rng.integers(0, 40))
        if kind == 0:
            dtype = rng.choice(["float32", "float64", "int32", "uint8",
                                "bool", "int64"])
            shape = tuple(int(s) for s in rng.integers(0, 4, rng.integers(0, 3)))
            out[key] = (rng.normal(size=shape) * 50).astype(dtype)
        elif kind == 1:
            out[key] = np.float32(rng.normal())
        elif kind == 2:
            out[key] = int(rng.choice([0, 5, 127, 128, 255, 256, 65535, 65536,
                                       2**32, 2**63 - 1, -1, -32, -33, -129,
                                       -40000, -2**31 - 1, -2**63]))
        elif kind == 3:
            out[key] = float(rng.normal() * 1e10)
        elif kind == 4:
            out[key] = "é" * int(rng.integers(0, 300))
        elif kind == 5:
            out[key] = bytes(rng.integers(0, 256, int(rng.integers(0, 70000)),
                                          dtype=np.uint8))
        elif kind == 6:
            out[key] = [None, True, False, int(rng.integers(-99, 99))] * int(
                rng.integers(0, 6))
        elif kind == 7:
            out[key] = np.asarray(rng.integers(-5, 5), np.int32)
        else:
            out[key] = _random_payload(rng, depth + 1)
    return {k: out[k] for k in sorted(out)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_matches_msgpack_and_flax(seed):
    payload = _random_payload(np.random.default_rng(seed))
    want = serialization.msgpack_serialize(payload)
    assert tmsgpack.packb(payload) == want
    got = tmsgpack.unpackb(want)
    _assert_trees_bitwise(got, serialization.msgpack_restore(want))
    plain = {k: v for k, v in payload.items()
             if not isinstance(v, (np.ndarray, np.generic, dict))}
    assert tmsgpack.packb(plain) == msgpack.packb(plain, use_bin_type=True)
    assert tmsgpack.unpackb(msgpack.packb(plain, use_bin_type=True)) == plain


def test_codec_refuses_what_it_does_not_cover():
    chunked = {"a": {"__msgpack_chunked_array__": True, "shape": {}}}
    with pytest.raises(ValueError, match="chunked"):
        tmsgpack.unpackb(msgpack.packb(chunked))
    with pytest.raises(ValueError, match="ext type 2"):
        tmsgpack.unpackb(msgpack.packb(msgpack.ExtType(2, b"xy")))
    with pytest.raises(TypeError, match="set"):
        tmsgpack.packb({"a": {1, 2}})


# --- crossing between the packages -------------------------------------------


def test_port_checkpoint_loads_in_the_jax_trainer(tmp_path):
    """A port run's last_checkpoint (epoch 0, two Adam steps) read by the
    JAX Trainer with its own templates: parameters, Adam's moments, both
    optax counts and the epoch, bitwise."""
    port = Trainer(_cfg(tmp_path / "port"), device="cpu")
    port.training(0)
    port.save(0, port.cfg.train.checkpoint_interval)
    path = tckpt.latest_checkpoint(port.ckpt_dir)
    assert path.endswith("last_checkpoint.msgpack")
    jt = JTrainer(_jcfg(tmp_path / "jax"), mesh=make_mesh(n_data=1))
    try:
        jt.load_weights(path, resume=True)
        assert jt.begin_epoch == 1
        _assert_trees_bitwise(jax.tree_util.tree_map(np.asarray, jt.params),
                              params_to_jax(port.model.state_dict()))
        adam, sched = jt.opt_state
        assert int(adam.count) == int(sched.count) == 2
        want = opt_state_to_jax(port.optimizer, port.model)
        for name in ("mu", "nu"):
            _assert_trees_bitwise(
                jax.tree_util.tree_map(np.asarray, getattr(adam, name)),
                want["0"][name])
    finally:
        jt.close()


def test_jax_checkpoint_loads_in_the_port_and_steps_on(tmp_path):
    """A JAX checkpoint written by ``save_checkpoint`` after two optax Adam
    steps, loaded into the port's Trainer: parameters, moments, Adam's
    step, the schedule's position and the epoch bitwise; then one more
    step on the same gradient on each side, parameters at atol 1e-6."""
    cfg = _cfg(tmp_path / "port", epochs=3)
    port = Trainer(cfg, device="cpu")
    sched_args = (LR_SCHEDULE, cfg.train.lr, cfg.train.num_epochs,
                  port.steps_per_epoch, len(port.train_ds))
    tx = optax.adam(jschedule(*sched_args))
    x = np.random.default_rng(2).uniform(-1, 1, (1, N, 3)).astype(np.float32)
    jp = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                 static_argnums=3)(jax.random.key(1), jnp.asarray(x),
                                   jnp.asarray(x), 1)
    js = tx.init(jp)

    def grads_like(seed):
        rng = np.random.default_rng(seed)
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
            jp)

    @jax.jit
    def jstep(grads, js, jp):
        updates, js = tx.update(grads, js, jp)
        return optax.apply_updates(jp, updates), js

    for step in range(2):
        jp, js = jstep(grads_like(step), js, jp)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, js, 1,
                          checkpoint_interval=0)
    path = jckpt.latest_checkpoint(str(tmp_path / "jax"))
    assert port.load_weights(path, resume=True) == 1
    assert port.begin_epoch == 2 and port.train_step.count[0] == 2
    _assert_trees_bitwise(params_to_jax(port.model.state_dict()),
                          jax.tree_util.tree_map(np.asarray, jp))
    got = opt_state_to_jax(port.optimizer, port.model,
                           port.train_step.count[0])
    _assert_trees_bitwise(got, jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(js)))
    grads = grads_like(2)
    jp, js = jstep(grads, js, jp)
    g = params_from_jax(grads)
    for name, p in port.model.named_parameters():
        p.grad = g[name].clone()
    scheduled_step(port.optimizer, port.schedule)
    want = params_from_jax(jp)
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """A reference ``.params`` file (``export_torch_state_dict`` of a JAX
    tree, ``module.``-prefixed keys) read by the port as the JAX package
    reads it, bitwise, and loaded into the port model strictly."""
    x = np.random.default_rng(3).uniform(-1, 1, (1, N, 3)).astype(np.float32)
    tree = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                   static_argnums=3)(jax.random.key(4), jnp.asarray(x),
                                     jnp.asarray(x), 1)["params"]
    sd = jckpt.export_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                              tree))
    path = str(tmp_path / "best_checkpoint.params")
    torch.save({"epoch": 7, "state_dict": {
        "module." + k: torch.from_numpy(np.array(v))
        for k, v in sd.items()}}, path)
    got, epoch = tckpt.load_torch_checkpoint(path)
    jtree, jepoch = jckpt.load_torch_checkpoint(path)
    assert epoch == jepoch == 7
    want = params_from_jax(jtree)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    TRaft(tconfig.ModelConfig(**TINY)).load_state_dict(got, strict=True)


def test_checkpoint_names_and_backends(tmp_path):
    """last every epoch, NNN every checkpoint_interval epochs, best on
    request; the JAX package finds the same files; Orbax raises."""
    model = TRaft(tconfig.ModelConfig(**TINY))
    params = params_to_jax(model.state_dict())
    opt = opt_state_to_jax(torch.optim.Adam(model.parameters()), model)
    d = str(tmp_path)
    written = [tckpt.save_checkpoint(d, params, opt, e, 2, best=e == 1)
               for e in range(4)]
    assert [[os.path.basename(p) for p in w] for w in written] == [
        ["last_checkpoint.msgpack"],
        ["last_checkpoint.msgpack", "001.msgpack", "best_checkpoint.msgpack"],
        ["last_checkpoint.msgpack"],
        ["last_checkpoint.msgpack", "003.msgpack"]]
    assert sorted(os.listdir(d)) == ["001.msgpack", "003.msgpack",
                                     "best_checkpoint.msgpack",
                                     "last_checkpoint.msgpack"]
    for name, epoch in (("last_checkpoint", 3), ("best_checkpoint", 1),
                        ("001", 1)):
        path = tckpt.find_checkpoint(d, name)
        assert path == jckpt.find_checkpoint(d, name)
        assert tckpt.load_params(path)[1] == jckpt.load_params(path)[1] \
            == epoch
    assert tckpt.find_checkpoint(d, "002") is None
    with pytest.raises(NotImplementedError, match="Orbax"):
        tckpt.save_checkpoint(d, params, opt, 0, backend="orbax")
    os.makedirs(tmp_path / "o" / "last_checkpoint.orbax")
    with pytest.raises(NotImplementedError, match="Orbax"):
        tckpt.latest_checkpoint(str(tmp_path / "o"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        tconfig.TrainConfig(ckpt_backend="orbax")


# --- resume ------------------------------------------------------------------


def _fit_kept(trainer):
    """fit(), keeping each epoch's train record (without its wall time)
    and, after its training, every parameter and Adam's state."""
    kept = {}

    def report(epoch, train, val):
        kept[epoch] = (
            {k: v for k, v in train.items() if k != "step_ms"}, val,
            {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            opt_state_to_jax(trainer.optimizer, trainer.model,
                             trainer.train_step.count[0]))

    return trainer.fit(report), kept


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Epoch 1 run from epoch 0's last_checkpoint by a fresh Trainer equals
    epoch 1 of the uninterrupted run: losses, validation, parameters and
    Adam's state, bitwise."""
    weights = seeded_state_dict(tconfig.ModelConfig(**TINY), 5)
    _, whole = _fit_kept(Trainer(_cfg(tmp_path / "whole"), device="cpu",
                                 weights=weights))
    first = Trainer(_cfg(tmp_path / "cut"), device="cpu", weights=weights)
    first.training(0)
    first.save(0, first.cfg.train.checkpoint_interval)
    first.val_test(0)
    resumed = Trainer(_cfg(tmp_path / "cut"), device="cpu")
    resumed.load_weights(tckpt.latest_checkpoint(resumed.ckpt_dir),
                         resume=True)
    assert resumed.begin_epoch == 1
    _, tail = _fit_kept(resumed)
    assert list(tail) == [1]
    (tr, va, params, opt), (wtr, wva, wparams, wopt) = tail[1], whole[1]
    assert tr == wtr and va == wva
    for n in wparams:
        assert torch.equal(params[n], wparams[n]), n
    _assert_trees_bitwise(opt, wopt)


def test_train_cli_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """Epoch 1 resumed from the uninterrupted run's epoch-0 checkpoint
    (``000``, by ``--checkpoint_interval 1``), as ``last_checkpoint`` of
    another ``--exp_path`` under ``--resume`` and by ``--weights``: each
    prints epoch 1 as the uninterrupted run does and leaves the same
    last_checkpoint, byte for byte."""
    base = ["--dataset", "synthetic", "--device", "cpu", "--max_points",
            str(N), "--synthetic_size", "4", "--truncate_k", "16",
            "--corr_knn", "8", "--iters", str(ITERS), "--eval_iters",
            str(ITERS), "--lr_schedule", LR_SCHEDULE, "--num_epochs", "2",
            "--checkpoint_interval", "1"]

    def run(exp, *extra):
        tcli.main(base + ["--exp_path", str(tmp_path / exp), *extra])
        lines = [json.loads(x) for x in
                 capsys.readouterr().out.strip().splitlines()]
        for line in lines:
            line.get("train", {}).pop("step_ms", None)
        return lines

    whole = run("whole")
    epoch0 = str(tmp_path / "whole" / "checkpoints" / "000.msgpack")
    os.makedirs(tmp_path / "cut" / "checkpoints")
    shutil.copy(epoch0, tmp_path / "cut" / "checkpoints" /
                "last_checkpoint.msgpack")
    resumed = run("cut", "--resume")
    weights = run("weights", "--weights", epoch0)
    assert len(resumed) == len(weights) == 2 and resumed[0]["epoch"] == 1
    assert resumed[0] == weights[0] == whole[1]
    last = [open(tmp_path / exp / "checkpoints" / "last_checkpoint.msgpack",
                 "rb").read() for exp in ("whole", "cut", "weights")]
    assert last[0] == last[1] == last[2]
    with pytest.raises(NotImplementedError, match="Orbax"):
        tcli.main(base + ["--exp_path", str(tmp_path / "o"), "--ckpt_backend",
                          "orbax"])


def test_serve_engine_from_a_checkpoint(tmp_path):
    """``InferenceEngine.from_checkpoint`` serves the checkpoint's weights
    and keeps its path and epoch."""
    model_cfg = tconfig.ModelConfig(**{**TINY, "graph_k": 4})
    state = seeded_state_dict(model_cfg, 6)
    model = TRaft(model_cfg)
    model.load_state_dict(state)
    opt = opt_state_to_jax(torch.optim.Adam(model.parameters()), model)
    path = tckpt.save_checkpoint(str(tmp_path), params_to_jax(state), opt, 4,
                                 0)[0]
    cfg = ServeConfig(model=model_cfg, buckets=(32,), batch_sizes=(1,),
                      num_iters=2, dtype="float32")
    engine = InferenceEngine.from_checkpoint(path, cfg, device="cpu")
    assert (engine.checkpoint_path, engine.checkpoint_epoch) == (path, 4)
    rng = np.random.default_rng(7)
    pc1 = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    pc2 = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    want = InferenceEngine(state, cfg, device="cpu").predict(pc1, pc2)
    np.testing.assert_array_equal(engine.predict(pc1, pc2), want)
