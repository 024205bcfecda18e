"""Stage 2 of the port (``PVRaftRefine``) against the JAX package's, on the
CPU.

The same inputs, made with numpy from a seed, go through ``pvraft_tpu``
(its XLA path, ``use_pallas=False``) and ``pvraft_tpu_torch``: the refine
model's flow at 2e-4 (the JAX-vs-torch bar of ``PARITY.md``) with the
parameter counts pinned; three refine train steps against
``make_refine_train_step`` with ``optax.masked(optax.adam(schedule))``,
head parameters at 1e-6 and the backbone bitwise unchanged; the refine
eval step; ``optax.masked``'s state and refine checkpoints across the two
packages bitwise, both ways; the stage-1 import; a reference
``RSF_refine`` file; the refine serve engine on padded buckets; resume
bitwise; both CLIs; and a 10-step lock-stepped trajectory.
"""

import json

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.engine import checkpoint as jckpt
from pvraft_tpu.engine.schedule import make_lr_schedule as jschedule
from pvraft_tpu.engine.steps import make_eval_step as jmake_eval_step
from pvraft_tpu.engine.steps import make_refine_train_step as jrefine_step
from pvraft_tpu.engine.trainer import _refine_mask
from pvraft_tpu.models import PVRaftRefine as JRefine
from pvraft_tpu.serve import InferenceEngine as JEngine
from pvraft_tpu.serve import ServeConfig as JServeConfig
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import test as ttest_cli
from pvraft_tpu_torch import train as ttrain_cli
from pvraft_tpu_torch.data import PrefetchLoader, SyntheticDataset, to_device
from pvraft_tpu_torch.engine import checkpoint as tckpt
from pvraft_tpu_torch.engine.evaluator import Evaluator
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import (
    make_eval_step,
    make_graphed_refine_train_step,
    make_refine_train_step,
    scheduled_step,
)
from pvraft_tpu_torch.engine.trainer import Trainer
from pvraft_tpu_torch.models import PVRaftRefine
from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
from pvraft_tpu_torch.weights import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_state_dict,
    trained_parameters,
)
from torch_engines import close_engines  # noqa: F401  (autouse)

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, LR_SCHEDULE = 2, 48, 2, "cosine"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scene(seed, b=B, n=N):
    """Two clouds with no exact distance ties, masks with padding rows."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.1, (b, n, 3))).astype(np.float32)
    v1 = np.ones((b, n), bool)
    v1[-1, n - 8:] = False
    v2 = np.ones((b, n), bool)
    v2[0, n - 4:] = False
    return x1, x2, v1, v2


@pytest.fixture(scope="module")
def jrefine():
    """The JAX refine model and seeded weights as its variables (the
    port's ``seeded_state_dict`` through ``params_to_jax``: no JAX init
    to compile), checked against ``PVRaftRefine.init``'s tree."""
    x1, x2, _, _ = _scene(0)
    model = JRefine(JConfig(use_pallas=False, **TINY))
    shapes = jax.eval_shape(lambda key, a, b: model.init(key, a, b, 1),
                            jax.random.key(0), x1, x2)
    state = seeded_state_dict(tconfig.ModelConfig(**TINY), 0, refine=True)
    variables = jax.tree_util.tree_map(jnp.asarray, params_to_jax(state))
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(shapes)
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree_util.tree_leaves(variables),
        jax.tree_util.tree_leaves(shapes)))
    return model, variables, shapes


def _port(variables, cfg=None):
    model = PVRaftRefine(cfg or tconfig.ModelConfig(**TINY))
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested mapping, sorted by path; an empty mapping
    (optax's MaskedNode) is a leaf of its own."""
    if isinstance(tree, dict) and tree:
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, {} if isinstance(tree, dict) else np.asarray(tree))]


def _assert_trees_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, dict):
            assert a == {}, path
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- (a) the model -------------------------------------------------------------


def test_refine_model_matches_jax(jrefine):
    """The refined flow with padding masks on both clouds at 2e-4; 124
    leaves and 239,221 parameters on both sides (JAX's from
    ``PVRaftRefine.init``), 29 and 47,187 of them the head's."""
    model, variables, shapes = jrefine
    leaves = jax.tree_util.tree_leaves(shapes)
    assert (len(leaves), sum(x.size for x in leaves)) == (124, 239_221)
    port = _port(variables)
    params = list(port.parameters())
    assert (len(params), sum(p.numel() for p in params)) == (124, 239_221)
    head = trained_parameters(port)
    assert (len(head), sum(p.numel() for _, p in head)) == (29, 47_187)
    assert [port.ref_conv1.fc1.out_features, port.ref_conv2.fc1.out_features,
            port.ref_conv3.fc1.out_features] == [16, 48, 96]
    x1, x2, v1, v2 = _scene(1)
    want = jax.jit(model.apply, static_argnums=3)(
        variables, *map(jnp.asarray, (x1, x2)), ITERS,
        *map(jnp.asarray, (v1, v2)))
    got = port(*map(torch.from_numpy, (x1, x2)), ITERS,
               *map(torch.from_numpy, (v1, v2)))
    assert got.shape == (B, N, 3) and got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-4)


def test_refine_head_alone_gets_a_gradient(jrefine):
    """The backbone runs without autograd: after a backward through the
    refined flow, every head leaf has a finite non-zero gradient and no
    backbone leaf has one."""
    _, variables, _ = jrefine
    port = _port(variables)
    x1, x2, _, _ = _scene(2)
    port(torch.from_numpy(x1), torch.from_numpy(x2), ITERS).square().sum(
        ).backward()
    for name, p in port.named_parameters():
        if name.startswith("backbone."):
            assert p.grad is None, name
        else:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all())
            assert float(p.grad.abs().max()) > 0, name


def test_seeded_refine_weights_follow_the_flax_init_rules():
    cfg = tconfig.ModelConfig(**TINY)
    state = seeded_state_dict(cfg, 3, refine=True)
    assert set(state) == set(PVRaftRefine(cfg).state_dict())
    assert torch.equal(state["fc.bias"], torch.zeros(3))
    assert torch.equal(state["ref_conv2.gn1.weight"], torch.ones(48))
    w = state["fc.weight"]
    std = (1.0 / 128) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and float(w.std()) > 0.5 * std
    # The backbone's keys sort first, so it takes stage 1's draws.
    stage1 = seeded_state_dict(cfg, 3)
    assert all(torch.equal(state["backbone." + k], v)
               for k, v in stage1.items())
    assert torch.equal(seeded_state_dict(cfg, 3, refine=True)["fc.weight"],
                       w)


# --- (b) train steps and optax.masked -----------------------------------------


def _batch(seed, b=B):
    x1, x2, _, _ = _scene(seed, b)
    rng = np.random.default_rng(seed + 100)
    gt = (x2 - x1 + rng.normal(0, 0.02, x1.shape)).astype(np.float32)
    mask = (rng.uniform(size=(b, N)) > 0.2).astype(np.float32)
    return {"pc1": x1, "pc2": x2, "mask": mask, "flow": gt}


SCHED_ARGS = (LR_SCHEDULE, 1e-3, 1, 4, 4)     # the lr moves every step


def _grad_probe() -> optax.GradientTransformation:
    """A transformation that applies nothing and keeps the gradient as its
    state: ``make_refine_train_step`` through it returns JAX's own
    gradients of the refine loss (and its loss and EPE)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def jstep(jrefine):
    """(the JAX Trainer's refine tx, ``step(params, batch) -> (grads,
    metrics)`` through ``make_refine_train_step``, ``update(grads, state,
    params) -> (params, state)`` of the tx)."""
    model, variables, _ = jrefine
    tx = optax.masked(optax.adam(jschedule(*SCHED_ARGS)),
                      _refine_mask(variables))
    probe = jrefine_step(model, _grad_probe(), ITERS, donate=False)

    def step(params, batch):
        _, grads, metrics = probe(params, params, {
            k: jnp.asarray(v) for k, v in batch.items()})
        return grads, metrics

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    return tx, step, update


def _leaf_stats(got, want):
    a = got.double().flatten()
    b = torch.from_numpy(np.asarray(want, np.float64)).flatten()
    na, nb = a.norm(), b.norm()
    return float(a @ b / (na * nb)), float((a - b).norm() / nb)


def test_refine_train_steps_match_masked_optax(jrefine, jstep):
    """Three coupled refine steps. Each step the port's refine step runs
    its forward, backward and Adam; its loss and EPE are held against
    JAX's ``make_refine_train_step`` (atol 1e-5) and each head gradient
    against that step's gradient (cosine >= 0.9999, relative error <=
    1e-3: the bars of ``tests/test_torch_grad.py``); JAX's gradient of
    every backbone leaf is 0 and the port's None. Then the port's
    gradients go through ``optax.masked(optax.adam(schedule))`` (coupled,
    as ``tests/test_torch_train.py`` couples Adam), and the head's
    parameters agree at 1e-6 after every step, the backbone's bitwise
    unchanged on both sides. The port's Adam holds state for the 29 head
    leaves only."""
    _, variables, _ = jrefine
    tx, step, update = jstep
    jp, js = variables, tx.init(variables)
    port = _port(variables)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = torch.optim.Adam([p for _, p in trained_parameters(port)], lr=1.0)
    tstep = make_refine_train_step(port, opt, make_lr_schedule(*SCHED_ARGS),
                                   ITERS)
    for i in range(3):
        batch = _batch(10 + i)
        jgrads, jm = step(jp, batch)
        tm = tstep(to_device(batch, "cpu"))
        for k in ("loss", "epe"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, (i, k)
        want = params_from_jax(jgrads)
        grads = {}
        for name, p in port.named_parameters():
            if name.startswith("backbone."):
                assert p.grad is None and not want[name].any(), name
                grads[name] = torch.zeros_like(p)
            else:
                cos, rel = _leaf_stats(p.grad, want[name])
                assert cos >= 0.9999 and rel <= 1e-3, (i, name, cos, rel)
                grads[name] = p.grad
        jp, js = update(jax.tree_util.tree_map(
            jnp.asarray, params_to_jax(grads)), js, jp)
        want = params_from_jax(jp)
        for name, p in port.named_parameters():
            if name.startswith("backbone."):
                assert torch.equal(p, before[name]), name
                assert torch.equal(want[name], before[name]), name
            else:
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=0,
                    atol=1e-6, err_msg=f"step {i}: {name}")
    assert len(opt.state) == 29 and tstep.count == [3]
    _assert_trees_bitwise(
        _np(serialization.to_state_dict(js))["inner_state"]["1"],
        opt_state_to_jax(opt, port)["inner_state"]["1"])


def _head_grads(params, rng):
    """Random gradients on the head, zeros on the backbone (JAX's
    stop_gradient gives it zeros; optax.masked passes a masked leaf's
    gradient through as its update)."""
    return {"params": {
        k: jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p) if k == "backbone" else jnp.asarray(
                rng.normal(size=p.shape).astype(np.float32)), v)
        for k, v in params["params"].items()}}


def _set_grads(model, jgrads):
    g = params_from_jax(jgrads)
    for name, p in trained_parameters(model):
        p.grad = g[name].clone()


def test_masked_opt_state_crosses_both_ways(jrefine, jstep):
    """``opt_state_to_jax`` of a port Adam over the head is optax.masked's
    state dict (fresh: bitwise; after two steps on the same gradients:
    the same tree, both counts, moments at float32 rounding), and
    ``opt_state_from_jax`` reads it back, from the dict and from the live
    ``MaskedState``; ``flax.serialization`` restores the port's dict into
    a ``MaskedState``."""
    _, variables, _ = jrefine
    tx, _, update = jstep
    js = tx.init(variables)
    port = _port(variables)
    opt = torch.optim.Adam([p for _, p in trained_parameters(port)], lr=1e-3)
    _assert_trees_bitwise(opt_state_to_jax(opt, port),
                          _np(serialization.to_state_dict(js)))
    rng = np.random.default_rng(4)
    jp = variables
    for _ in range(2):
        grads = _head_grads(variables, rng)
        jp, js = update(grads, js, jp)
        _set_grads(port, grads)
        opt.step()
    js_dict = _np(serialization.to_state_dict(js))
    got = opt_state_to_jax(opt, port)
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(js_dict)]
    assert got["inner_state"]["0"]["mu"]["params"]["backbone"][
        "feature_extractor"]["conv1"]["fc1"] == {"kernel": {}}
    _assert_trees_bitwise(got["inner_state"]["1"], js_dict["inner_state"]["1"])
    assert int(got["inner_state"]["0"]["count"]) == 2
    for moment in ("mu", "nu"):
        a = params_from_jax(got["inner_state"]["0"][moment])
        b = params_from_jax(js_dict["inner_state"]["0"][moment])
        assert set(a) == set(b) and len(a) == 29
        for name in a:
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    back = serialization.from_state_dict(js, got)
    assert type(back).__name__ == "MaskedState"
    mu = params_from_jax(js_dict["inner_state"]["0"]["mu"])
    for source in (js, js_dict):
        sd = opt_state_from_jax(source, port, opt)
        assert len(sd["state"]) == 29
        for i, (name, _) in enumerate(trained_parameters(port)):
            assert torch.equal(sd["state"][i]["exp_avg"], mu[name])
            assert float(sd["state"][i]["step"]) == 2.0


# --- (c) the eval step -------------------------------------------------------


def test_refine_eval_step_matches_jax(jrefine):
    """``make_eval_step(refine=True, per_scene=True)``, the step of the
    Trainer and the Evaluator: the refined flow at 2e-4, each scene's
    masked L1 and metrics at 1e-4; the pooled step's means are the
    per-scene values' means (equal-size scenes)."""
    model, variables, _ = jrefine
    batch = _batch(20)
    want, jflow = jmake_eval_step(model, ITERS, 0.8, refine=True,
                                  per_scene=True)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(variables)
    got, tflow = make_eval_step(port, ITERS, 0.8, per_scene=True,
                                refine=True)(to_device(batch, "cpu"))
    np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), rtol=0,
                               atol=2e-4)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (B,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    one = {k: v[:1] for k, v in to_device(batch, "cpu").items()}
    pooled, _ = make_eval_step(port, ITERS, 0.8, refine=True)(one)
    per, _ = make_eval_step(port, ITERS, 0.8, per_scene=True,
                            refine=True)(one)
    for k in pooled:
        assert pooled[k].shape == () and torch.equal(pooled[k], per[k][0])


# --- Trainer, checkpoints ------------------------------------------------------


def _cfg(exp_path, epochs=2, size=4, **train):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=size),
        train=tconfig.TrainConfig(num_epochs=epochs, iters=ITERS,
                                  eval_iters=ITERS + 1, refine=True,
                                  lr_schedule=LR_SCHEDULE, **train),
        exp_path=str(exp_path))


def test_refine_trainer_freezes_the_backbone(tmp_path):
    """An epoch of the refine Trainer (graphed steps on the CPU path):
    the backbone bitwise unchanged and without gradients, every head leaf
    moved; validation runs at ``train.iters`` (3 would be eval_iters)."""
    trainer = Trainer(_cfg(tmp_path, epochs=1), device="cpu")
    assert trainer.eval_iters == ITERS
    assert [r["name"].split("[")[0] for r in trainer.compile_report()] == [
        "refine_train_step", "eval_step"]
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    out = trainer.training(0)
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    for name, p in trainer.model.named_parameters():
        if name.startswith("backbone."):
            assert torch.equal(p, before[name]) and p.grad is None, name
        else:
            assert not torch.equal(p, before[name]), name
    assert len(trainer.optimizer.state) == 29
    val = trainer.val_test(0, "val")
    assert all(np.isfinite(v) for v in val.values())


def test_graphed_refine_step_equals_eager_on_the_cpu():
    """The graphed refine step's program on the CPU path (the captured
    function on static buffers) against the eager step: losses, EPEs and
    parameters bitwise over three steps."""
    weights = seeded_state_dict(tconfig.ModelConfig(**TINY), 2, refine=True)
    schedule = make_lr_schedule(*SCHED_ARGS)
    steps, models = {}, {}
    for name in ("graphed", "eager"):
        model = PVRaftRefine(tconfig.ModelConfig(**TINY))
        model.load_state_dict(weights)
        opt = torch.optim.Adam([p for _, p in trained_parameters(model)],
                               lr=torch.tensor(1e-3))
        steps[name] = (make_graphed_refine_train_step(
            model, opt, schedule, ITERS, torch.device("cpu"))
            if name == "graphed" else
            make_refine_train_step(model, opt, schedule, ITERS))
        models[name] = model
    for i in range(3):
        batch = to_device(_batch(30 + i), "cpu")
        g, e = steps["graphed"](batch), steps["eager"](batch)
        assert torch.equal(g["loss"], e["loss"]) and \
            torch.equal(g["epe"], e["epe"]), i
    for (n, p), q in zip(models["graphed"].named_parameters(),
                         models["eager"].parameters()):
        assert torch.equal(p, q), n
    assert steps["graphed"].graphs.report()[0]["name"].startswith(
        "refine_train_step")


def test_jax_refine_checkpoint_resumes_in_the_port(jrefine, tmp_path):
    """A refine checkpoint as the JAX Trainer writes it (its
    ``save_checkpoint`` of the params and the state of its tx,
    ``optax.masked(optax.adam(schedule), _refine_mask)``, after two steps)
    resumes in the port's refine Trainer: parameters, the masked Adam
    state, both counts and the epoch bitwise; then one more step on the
    same gradients on each side, every parameter at 1e-6."""
    _, variables, _ = jrefine
    cfg = _cfg(tmp_path / "port", epochs=3)
    port = Trainer(cfg, device="cpu")
    tx = optax.masked(optax.adam(jschedule(
        LR_SCHEDULE, cfg.train.lr, cfg.train.num_epochs,
        port.steps_per_epoch, len(port.train_ds))), _refine_mask(variables))

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    rng = np.random.default_rng(5)
    jp, js = variables, tx.init(variables)
    for _ in range(2):
        jp, js = update(_head_grads(variables, rng), js, jp)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, js, 1,
                          checkpoint_interval=0)
    path = jckpt.latest_checkpoint(str(tmp_path / "jax"))
    assert port.load_weights(path, resume=True) == 1
    assert port.begin_epoch == 2 and port.train_step.count[0] == 2
    _assert_trees_bitwise(params_to_jax(port.model.state_dict()), _np(jp))
    _assert_trees_bitwise(
        opt_state_to_jax(port.optimizer, port.model,
                         port.train_step.count[0]),
        _np(serialization.to_state_dict(js)))
    grads = _head_grads(variables, rng)
    want = params_from_jax(update(grads, js, jp)[0])
    _set_grads(port.model, grads)
    scheduled_step(port.optimizer, port.schedule)
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_port_refine_checkpoint_loads_in_jax(jrefine, tmp_path):
    """A port refine run's last_checkpoint (epoch 0, two steps) read by the
    JAX ``load_checkpoint`` with the JAX refine Trainer's templates (its
    params, and ``optax.masked(optax.adam(schedule),
    _refine_mask).init``): parameters, the masked Adam state (every
    backbone leaf a MaskedNode) and both counts bitwise."""
    _, variables, _ = jrefine
    port = Trainer(_cfg(tmp_path / "port"), device="cpu")
    port.training(0)
    path = port.save(0, 0)[0]
    tx = optax.masked(optax.adam(jschedule(*SCHED_ARGS)),
                      _refine_mask(variables))
    params, opt_state, epoch = jckpt.load_checkpoint(
        path, _np(variables), _np(tx.init(variables)))
    assert epoch == 0
    _assert_trees_bitwise(_np(params), params_to_jax(port.model.state_dict()))
    adam, sched = opt_state.inner_state
    assert int(adam.count) == int(sched.count) == 2
    assert type(adam.mu["params"]["backbone"]["update_iter"][
        "update_block"]["gru"]["convz"]["kernel"]).__name__ == "MaskedNode"
    _assert_trees_bitwise(_np(serialization.to_state_dict(opt_state)),
                          opt_state_to_jax(port.optimizer, port.model, 2))


def test_load_stage1_weights_from_a_jax_checkpoint(tmp_path):
    """A JAX stage-1 checkpoint imported into the refine Trainer's backbone
    (strictly, into the tensors the captured steps read); the head keeps
    its weights; a refine model refuses none of it, a stage-1 Trainer
    refuses the call."""
    s1 = jax.tree_util.tree_map(jnp.asarray, params_to_jax(
        seeded_state_dict(tconfig.ModelConfig(**TINY), 6)))
    d = str(tmp_path / "s1")
    jckpt.save_checkpoint(d, s1, optax.adam(1e-3).init(s1), 4,
                          checkpoint_interval=0, best=True)
    trainer = Trainer(_cfg(tmp_path / "r", epochs=1), device="cpu")
    head = {n: p.detach().clone()
            for n, p in trained_parameters(trainer.model)}
    ptrs = {n: p.data_ptr() for n, p in trainer.model.named_parameters()}
    assert trainer.load_stage1_weights(
        jckpt.find_checkpoint(d, "best_checkpoint")) == 4
    want = params_from_jax(s1)
    for name, p in trainer.model.named_parameters():
        assert p.data_ptr() == ptrs[name], name
        if name.startswith("backbone."):
            assert torch.equal(p, want[name[len("backbone."):]]), name
        else:
            assert torch.equal(p, head[name]), name
    stage1 = Trainer(_cfg(tmp_path / "s", epochs=1).replace(
        train=tconfig.TrainConfig(num_epochs=1, iters=ITERS,
                                  eval_iters=ITERS)), device="cpu")
    with pytest.raises(ValueError, match="train.refine"):
        stage1.load_stage1_weights(jckpt.find_checkpoint(d,
                                                         "best_checkpoint"))


def test_load_refine_torch_checkpoint_matches_jax(jrefine, tmp_path):
    """A reference-layout ``RSF_refine`` ``.params`` file (the JAX
    package's ``export_torch_state_dict(refine=True)``, ``module.``
    prefixes) read by the port as the JAX package reads it, bitwise, and
    evaluated by the refine Evaluator through ``load_torch``."""
    _, variables, _ = jrefine
    sd = jckpt.export_torch_state_dict(_np(variables)["params"], refine=True)
    assert any(k.startswith("refine_block.ref_conv3.") for k in sd)
    path = str(tmp_path / "RSF_refine.params")
    torch.save({"epoch": 9, "state_dict": {
        "module." + k: torch.from_numpy(np.array(v))
        for k, v in sd.items()}}, path)
    got, epoch = tckpt.load_torch_checkpoint(path, refine=True)
    jtree, jepoch = jckpt.load_torch_checkpoint(path, refine=True)
    assert epoch == jepoch == 9
    want = params_from_jax(jtree)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _port({"params": jtree})
    ev = Evaluator(_cfg(tmp_path, size=2), device="cpu")
    assert ev.load_torch(path) == 9
    assert all(torch.equal(p, want[n])
               for n, p in ev.model.named_parameters())
    assert all(np.isfinite(v) for v in ev.run().values())
    with pytest.raises(ValueError, match="unknown refine_block child"):
        tckpt.import_torch_state_dict({"refine_block.head.weight":
                                       np.zeros((3, 3), np.float32)})


# --- (g) serving -------------------------------------------------------------

SERVE_TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 4}
SERVE = {"batch_sizes": (2,), "num_iters": ITERS, "dtype": "float32",
         "replicas": 1}


def test_refine_engine_matches_jax_on_padded_buckets(tmp_path):
    """``ServeConfig(refine=True)``: padded single requests and a batch of
    two against the JAX engine's ``build_predict_fn(refine=True)`` at 2e-4,
    a request's refined flow independent of its padding and batch mate
    (the head's GroupNorms masked), and ``from_checkpoint`` on a refine
    checkpoint."""
    rng = np.random.default_rng(7)
    state = seeded_state_dict(tconfig.ModelConfig(**SERVE_TINY), 7,
                              refine=True)
    variables = params_to_jax(state)
    jeng = JEngine(variables, JServeConfig(model=JConfig(**SERVE_TINY),
                                           refine=True, buckets=(64,),
                                           **SERVE))
    cfg = ServeConfig(model=tconfig.ModelConfig(**SERVE_TINY), refine=True,
                      buckets=(32, 64), **SERVE)
    teng = InferenceEngine(variables, cfg, device="cpu")

    def cloud(n):
        return rng.uniform(-1, 1, (n, 3)).astype(np.float32)

    single = (cloud(40), cloud(44))
    pair = [(cloud(40), cloud(52)), (cloud(60), cloud(33))]
    want, got = jeng.predict(*single), teng.predict(*single)
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    want = jeng.predict_batch(pair, 64)
    got = teng.predict_batch(pair, 64)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    alone = teng.predict_batch(pair[:1], 64)[0]
    np.testing.assert_allclose(alone, got[0], rtol=0, atol=1e-5)
    # The same request in a larger bucket: padding changes nothing.
    exact = (cloud(32), cloud(30))
    in32 = teng.predict_batch([exact], 32)[0]
    in64 = teng.predict_batch([exact], 64)[0]
    np.testing.assert_allclose(in64, in32, rtol=0, atol=1e-5)
    model = PVRaftRefine(cfg.model)
    model.load_state_dict(state)
    path = tckpt.save_checkpoint(
        str(tmp_path), params_to_jax(state),
        opt_state_to_jax(torch.optim.Adam(
            [p for _, p in trained_parameters(model)]), model), 5, 0)[0]
    served = InferenceEngine.from_checkpoint(path, cfg, device="cpu")
    assert served.checkpoint_epoch == 5
    np.testing.assert_array_equal(served.predict(*single),
                                  teng.predict(*single))


# --- (h) resume -------------------------------------------------------------


def test_refine_resume_equals_the_uninterrupted_run(tmp_path):
    """Epoch 1 of a refine run resumed from epoch 0's last_checkpoint by a
    fresh Trainer equals the uninterrupted run's: losses, validation,
    parameters and the masked Adam state, bitwise."""
    weights = seeded_state_dict(tconfig.ModelConfig(**TINY), 5, refine=True)
    kept = {}

    def fit(trainer, tag):
        def report(epoch, train, val):
            kept[(tag, epoch)] = (
                train["losses"], val,
                {n: p.detach().clone()
                 for n, p in trainer.model.named_parameters()},
                opt_state_to_jax(trainer.optimizer, trainer.model,
                                 trainer.train_step.count[0]))
        return trainer.fit(report)

    whole = fit(Trainer(_cfg(tmp_path / "whole"), device="cpu",
                        weights=weights), "whole")
    first = Trainer(_cfg(tmp_path / "cut"), device="cpu", weights=weights)
    first.training(0)
    first.save(0, 0)
    first.val_test(0)
    resumed = Trainer(_cfg(tmp_path / "cut"), device="cpu")
    resumed.load_weights(tckpt.latest_checkpoint(resumed.ckpt_dir),
                         resume=True)
    assert resumed.begin_epoch == 1
    tail = fit(resumed, "cut")
    (tr, va, params, opt), (wtr, wva, wparams, wopt) = (
        kept[("cut", 1)], kept[("whole", 1)])
    assert ("cut", 0) not in kept
    assert tr == wtr and va == wva and tail == whole
    for n in wparams:
        assert torch.equal(params[n], wparams[n]), n
    _assert_trees_bitwise(opt, wopt)


# --- (i) the CLIs -----------------------------------------------------------


def test_train_and_test_clis_run_stage_2(tmp_path, capsys):
    """``train --refine --stage1_weights`` after a stage-1 run, then
    ``test --refine --weights`` on its best checkpoint: the test CLI prints
    the means the train run's test pass printed, bitwise (both evaluate
    at iters there)."""
    base = ["--dataset", "synthetic", "--device", "cpu", "--max_points",
            str(N), "--synthetic_size", "2", "--truncate_k", "16",
            "--corr_knn", "8", "--num_epochs", "1"]
    ttrain_cli.main(base + ["--exp_path", str(tmp_path / "s1"), "--iters",
                            "1", "--eval_iters", "1"])
    capsys.readouterr()
    s1 = str(tmp_path / "s1" / "checkpoints" / "best_checkpoint.msgpack")
    ttrain_cli.main(base + ["--exp_path", str(tmp_path / "s2"), "--iters",
                            str(ITERS), "--refine", "--stage1_weights", s1])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2 and "test" in lines[-1]
    best = str(tmp_path / "s2" / "checkpoints" / "best_checkpoint.msgpack")
    ttest_cli.main(base[:-2] + ["--refine", "--eval_iters", str(ITERS),
                                "--weights", best])
    means = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # test.py has no --graph_k: both CLIs run the default 32-NN graph on
    # the synthetic test scenes (seed 2).
    assert means == lines[-1]["test"]
    with pytest.raises(SystemExit):
        ttrain_cli.main(base + ["--stage1_weights", s1])
    assert "needs --refine" in capsys.readouterr().err
    # Stage 2 takes a seq axis; on one process a seq axis of 2 has no
    # ranks to cover it, and the mesh refuses it.
    for cli, args in ((ttrain_cli, base), (ttest_cli, base[:-2])):
        with pytest.raises(ValueError, match=">= 1 device"):
            cli.main(args + ["--refine", "--seq_parallel", "2"])


# --- (j) a trajectory ---------------------------------------------------------

TRAJECTORY_STEPS = 10


def test_refine_trajectory_tracks_jax(jrefine, jstep):
    """Ten refine steps lock-stepped with JAX on synthetic scenes, each
    side its own forward, backward and masked Adam from the same weights,
    on the same batches (JAX: ``make_refine_train_step``'s gradients
    through its Trainer's tx): every step's loss within 1e-4 relative, and
    no head leaf farther from JAX's than 1.2 x steps x lr, the most two
    Adam runs whose near-zero gradient elements take opposite signs can
    part (``scripts/trajectory_parity.py``); the head's mean gap below 1%
    of its mean motion; the backbone bitwise unchanged on both sides."""
    _, variables, _ = jrefine
    tx, step, update = jstep
    jp, js = variables, tx.init(variables)
    port = _port(variables)
    start = {n: p.detach().clone() for n, p in trained_parameters(port)}
    opt = torch.optim.Adam([p for _, p in trained_parameters(port)], lr=1.0)
    schedule = make_lr_schedule(*SCHED_ARGS)
    tstep = make_refine_train_step(port, opt, schedule, ITERS)
    ds = SyntheticDataset(size=2 * TRAJECTORY_STEPS, nb_points=N,
                          noise=0.01, seed=8, n_objects=3)
    batches = list(PrefetchLoader(ds, B, shuffle=True, num_workers=0,
                                  seed=8).epoch(0))
    assert len(batches) == TRAJECTORY_STEPS
    jl, tl = [], []
    for batch in batches:
        grads, jm = step(jp, batch)
        jp, js = update(grads, js, jp)
        tl.append(float(tstep(to_device(batch, "cpu"))["loss"]))
        jl.append(float(jm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    want = params_from_jax(jp)
    cap = 1.2 * TRAJECTORY_STEPS * SCHED_ARGS[1]
    gaps, motions = [], []
    for name, p in port.named_parameters():
        if name.startswith("backbone."):
            assert torch.equal(want[name], p), name
            continue
        gap = (p.detach() - want[name]).abs()
        assert float(gap.max()) <= cap, name
        gaps.append(float(gap.mean()))
        motions.append(float((want[name] - start[name]).abs().mean()))
    assert np.mean(gaps) < 0.01 * np.mean(motions), (gaps, motions)
