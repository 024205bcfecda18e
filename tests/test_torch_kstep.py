"""The K-step train levers of the port against the JAX package's, on the CPU.

``ParallelConfig`` (its errors case for case with the JAX one's), the
packed state (``engine/steps.py::PackedState``): the packed step bitwise
equal to the unpacked one and ``host_roundtrip`` bitwise equal to the
packed one, in both stages, eager and graphed (on the CPU the graphed
program runs its function on the same static buffers); the K-step step
(K = 3) bitwise equal to 3 single steps; the ``Trainer`` loop with its
K-step calls and its tail, its programs' names, its prefetch depth and
its repack; and a stage-1 trajectory lock-stepped with JAX's
``make_multistep_train_step`` and ``make_packed_train_step`` (7 steps:
two 3-step dispatches and one tail), at the bars of
``tests/test_torch_refine.py::test_refine_trajectory_tracks_jax``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.config import ParallelConfig as JParallel
from pvraft_tpu.engine.schedule import make_lr_schedule as jschedule
from pvraft_tpu.engine.steps import make_multistep_train_step as jmultistep
from pvraft_tpu.engine.steps import make_packed_train_step as jpacked
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch.data import PrefetchLoader, SyntheticDataset, collate
from pvraft_tpu_torch.data import to_device
from pvraft_tpu_torch.engine import steps as tsteps
from pvraft_tpu_torch.engine import trainer as ttrainer
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.models import PVRaft, PVRaftRefine
from pvraft_tpu_torch.weights import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_state_dict,
    trained_parameters,
)
from torch_engines import close_engines  # noqa: F401  (autouse)

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, GAMMA = 2, 48, 2, 0.8
SCHED_ARGS = ("cosine", 1e-3, 2, 7, 14)       # the lr moves every step
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- ParallelConfig -----------------------------------------------------------


@pytest.mark.parametrize("kw,ok", [
    ({"host_roundtrip": True}, False),
    ({"steps_per_dispatch": 0, "packed_state": True}, False),
    ({"steps_per_dispatch": 2}, False),
    ({"steps_per_dispatch": 2, "packed_state": True, "host_roundtrip": True},
     False),
    ({"steps_per_dispatch": 4, "packed_state": True}, True),
    ({"packed_state": True, "host_roundtrip": True}, True),
    ({"donate": False, "device_prefetch": 1}, True),
    ({"data_axis": 1, "seq_axis": 1}, True),
])
def test_parallel_config_errors_match_jax(kw, ok):
    """The JAX ``ParallelConfig`` errors case for case
    (``tests/test_packed_step.py``); the same fields and defaults."""
    assert [(f.name, f.default) for f in dataclasses.fields(JParallel)] == \
        [(f.name, f.default) for f in dataclasses.fields(
            tconfig.ParallelConfig)]
    if ok:
        assert dataclasses.asdict(JParallel(**kw)) == dataclasses.asdict(
            tconfig.ParallelConfig(**kw))
        return
    with pytest.raises(ValueError):
        JParallel(**kw)
    with pytest.raises(ValueError):
        tconfig.ParallelConfig(**kw)


@pytest.mark.parametrize("kw", [{"data_axis": 2}, {"seq_axis": 2}])
def test_parallel_config_refuses_layouts_beyond_one_card(kw):
    """(Named for the refusals it held before the parallel slices.) A data
    axis and a sequence axis of several ranks are taken as JAX takes them
    (the world size checks them, ``parallel/mesh.py::make_mesh``)."""
    assert dataclasses.asdict(tconfig.ParallelConfig(**kw)) == \
        dataclasses.asdict(JParallel(**kw))
    assert isinstance(tconfig.Config().parallel, tconfig.ParallelConfig)


# --- packed state and K-step steps --------------------------------------------


def _batch(seed):
    ds = SyntheticDataset(size=B, nb_points=N, noise=0.01, seed=seed,
                          n_objects=2)
    return to_device(collate([ds[i] for i in range(B)]), "cpu")


def _model(refine):
    cfg = tconfig.ModelConfig(**TINY)
    model = (PVRaftRefine if refine else PVRaft)(cfg)
    model.load_state_dict(seeded_state_dict(cfg, 0, refine=refine))
    opt = torch.optim.Adam([p for _, p in trained_parameters(model)],
                           lr=torch.tensor(1e-3), betas=(0.9, 0.999),
                           eps=1e-8)
    return model, opt


def _state(model, opt):
    """Parameters and Adam's state, cloned, in a comparable order."""
    params = [p.detach().clone() for p in model.parameters()]
    adam = [opt.state[p][k].clone() for g in opt.param_groups
            for p in g["params"] for k in tsteps.ADAM_KEYS]
    return params + adam


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _single(way, refine, graphed, model, opt, schedule, packed=None):
    """The train step of one way: "unpacked", "packed" or
    "host_roundtrip"."""
    if way == "unpacked":
        if refine:
            make = (tsteps.make_graphed_refine_train_step if graphed
                    else tsteps.make_refine_train_step)
            args = (model, opt, schedule, ITERS)
        else:
            make = (tsteps.make_graphed_train_step if graphed
                    else tsteps.make_train_step)
            args = (model, opt, schedule, GAMMA, ITERS)
        return make(*args, *((CPU,) if graphed else ()))
    make = (tsteps.make_graphed_packed_train_step if graphed
            else tsteps.make_packed_train_step)
    args = (model, opt, schedule, GAMMA, ITERS) + ((CPU,) if graphed else ())
    step, flat, _ = make(*args, refine=refine,
                         host_roundtrip=way == "host_roundtrip",
                         packed=packed)
    assert flat.dtype == torch.float32 and flat.dim() == 1
    return step


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("refine", [False, True])
def test_packed_and_round_trip_steps_are_bitwise_unpacked(refine, graphed):
    """Three steps each way from the same weights on the same batches:
    losses, EPEs, parameters and Adam's state bitwise equal."""
    schedule = make_lr_schedule(*SCHED_ARGS)
    batches = [_batch(10 + i) for i in range(3)]
    runs = {}
    for way in ("unpacked", "packed", "host_roundtrip"):
        model, opt = _model(refine)
        step = _single(way, refine, graphed, model, opt, schedule)
        metrics = [(float(m["loss"]), float(m["epe"]))
                   for m in (step(b) for b in batches)]
        runs[way] = (metrics, _state(model, opt))
        assert step.count[0] == 3
    for way in ("packed", "host_roundtrip"):
        assert runs[way][0] == runs["unpacked"][0], way
        assert _equal(runs[way][1], runs["unpacked"][1]), way


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("refine", [False, True])
def test_k_step_is_bitwise_k_single_steps(refine, graphed):
    """Six batches as two K = 3 calls against six packed single steps:
    per-step losses and EPEs of shape (K,), the whole state bitwise; the
    K-step step and the packed single step share one flat buffer and
    one schedule position."""
    schedule = make_lr_schedule(*SCHED_ARGS)
    batches = [_batch(20 + i) for i in range(6)]
    model, opt = _model(refine)
    single = _single("packed", refine, graphed, model, opt, schedule)
    want = [(float(m["loss"]), float(m["epe"]))
            for m in (single(b) for b in batches)]
    want_state = _state(model, opt)

    model, opt = _model(refine)
    packed = tsteps.PackedState(model, opt)
    single = _single("packed", refine, graphed, model, opt, schedule,
                     packed)
    make = (tsteps.make_graphed_multistep_train_step if graphed
            else tsteps.make_multistep_train_step)
    multi, flat, unravel = make(model, opt, schedule, GAMMA, ITERS, 3,
                                *((CPU,) if graphed else ()), refine=refine,
                                packed=packed)
    assert flat is packed.flat
    got = []
    for i in (0, 3):
        m = multi(tsteps.stack_batches(batches[i:i + 3]))
        assert m["loss"].shape == m["epe"].shape == (3,)
        got += list(zip(m["loss"].tolist(), m["epe"].tolist()))
    assert got == want
    assert _equal(_state(model, opt), want_state)
    assert multi.count is single.count and multi.count[0] == 6
    if graphed:
        assert list(multi.graphs.programs)[0].startswith(
            "float32[3], float32[3,2,48,3]")
    params, adam = unravel(flat)
    named = dict(trained_parameters(model))
    assert set(params) == set(named)
    for name, p in params.items():
        assert p.data_ptr() == named[name].data_ptr()
    assert [float(s["step"]) for s in adam] == [6.0] * len(adam)


def test_packed_state_is_views_of_one_aligned_buffer_and_repacks():
    """Every trained parameter and Adam's three state tensors are views
    of the flat buffer, each on a 512-byte boundary;
    ``optimizer.load_state_dict`` replaces the state tensors, and
    ``repack`` makes them views of the same buffer again, with their
    values."""
    model, opt = _model(False)
    packed = tsteps.PackedState(model, opt)
    step, flat, _ = tsteps.make_packed_train_step(
        model, opt, make_lr_schedule(*SCHED_ARGS), GAMMA, ITERS,
        packed=packed)
    step(_batch(1))
    assert packed.flat is flat and packed.count[0] == 1

    def inside(t):
        o = (t.data_ptr() - flat.data_ptr()) // 4
        return 0 <= o < flat.numel() and o % tsteps.SLOT_ALIGN == 0

    assert all(inside(t) for t in packed.tensors())
    saved = copy.deepcopy(opt.state_dict())
    before = _state(model, opt)
    opt.load_state_dict(saved)
    assert not all(inside(t) for t in packed.tensors())
    packed.repack()
    assert all(inside(t) for t in packed.tensors())
    assert _equal(_state(model, opt), before)


# --- the Trainer loop -----------------------------------------------------------


def _cfg(scenes=14, epochs=1, **par):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=scenes, num_workers=0),
        train=tconfig.TrainConfig(iters=ITERS, eval_iters=ITERS,
                                  num_epochs=epochs),
        parallel=tconfig.ParallelConfig(**par))


@pytest.mark.parametrize("par", [
    {"packed_state": True},
    {"packed_state": True, "host_roundtrip": True},
    {"packed_state": True, "steps_per_dispatch": 3},
    {"packed_state": True, "steps_per_dispatch": 7},
])
def test_trainer_loop_is_bitwise_the_plain_loop(par, tmp_path):
    """An epoch of 7 steps (K = 3: two K-step calls and one tail step; K =
    7: one call, no tail): per-step losses and EPEs and the final
    parameters bitwise equal to the unpacked trainer's; the programs are
    named as JAX's retrace watch names them, the single step captured
    only where it runs."""
    want = ttrainer.Trainer(_cfg(), device="cpu")
    plain = want.training(0)
    trainer = ttrainer.Trainer(_cfg(**par), device="cpu")
    got = trainer.training(0)
    assert got["steps"] == 7
    assert got["losses"] == plain["losses"] and got["epes"] == plain["epes"]
    assert _equal(list(trainer.model.parameters()),
                  list(want.model.parameters()))
    names = [r["name"].split("[")[0] for r in trainer.compile_report()]
    k = par.get("steps_per_dispatch", 1)
    expect = (["packed_train_step"] if k == 1 or 7 % k else []) + (
        ["multistep_train_step"] if k > 1 else []) + ["eval_step"]
    assert names == expect
    assert trainer.train_step.count[0] == 7


def test_trainer_prefetch_depth_comes_from_the_config(monkeypatch):
    depths = []
    real = ttrainer.device_prefetch

    def spy(batches, put, depth=2):
        depths.append(depth)
        return real(batches, put, depth)

    monkeypatch.setattr(ttrainer, "device_prefetch", spy)
    trainer = ttrainer.Trainer(_cfg(scenes=4, device_prefetch=1),
                               device="cpu")
    trainer.training(0)
    assert depths == [1]


def test_packed_trainer_resumes_bitwise_and_writes_the_same_checkpoints(
        tmp_path):
    """A packed K-step trainer's checkpoint holds what an unpacked one's
    holds; resumed from its epoch-0 checkpoint (``load_weights`` copies
    into the packed tensors, then repacks), a second packed trainer runs
    epoch 1 bitwise like the uninterrupted one."""
    par = {"packed_state": True, "steps_per_dispatch": 2}
    base = _cfg(scenes=6, epochs=2)
    full = ttrainer.Trainer(dataclasses.replace(
        base, parallel=tconfig.ParallelConfig(**par),
        exp_path=str(tmp_path / "a")), device="cpu")
    plain = ttrainer.Trainer(dataclasses.replace(
        base, exp_path=str(tmp_path / "b")), device="cpu")
    first = full.training(0)
    plain.training(0)
    path = full.save(0, 1)[0]
    ours = opt_state_to_jax(full.optimizer, full.model,
                            full.train_step.count[0])
    theirs = opt_state_to_jax(plain.optimizer, plain.model,
                              plain.train_step.count[0])
    jax.tree_util.tree_map(np.testing.assert_array_equal, ours, theirs)
    second = full.training(1)
    resumed = ttrainer.Trainer(dataclasses.replace(
        base, parallel=tconfig.ParallelConfig(**par),
        exp_path=str(tmp_path / "c")), device="cpu")
    assert resumed.load_weights(path, resume=True) == 0
    assert resumed.train_step.count[0] == first["steps"]
    again = resumed.training(1)
    assert again["losses"] == second["losses"]
    assert torch.equal(resumed.flat, full.flat)


# --- a stage-1 trajectory against JAX ------------------------------------------


TRAJECTORY_STEPS, K = 7, 3


def test_k_step_trajectory_tracks_jax():
    """Seven stage-1 steps lock-stepped with JAX from the same weights on
    the same batches, K = 3: two calls of the port's K-step step and one
    tail step of its packed step, against JAX's
    ``make_multistep_train_step`` (two dispatches) and
    ``make_packed_train_step`` (the tail) on one flat state. No leaf is
    farther from JAX's than 1.2 x steps x lr (two Adam runs whose
    near-zero gradient elements take opposite signs part by up to lr a
    step; ``scripts/trajectory_parity.py``), and both losses fall.

    The losses are held to 1e-4 relative where that bar is above the
    computation's own floor: the first K-step dispatch against JAX's,
    from the same state, and at every step the port's loss at the
    parameters JAX's steps reached (JAX's packed single steps, which
    give them between steps) against JAX's loss there. Uncoupled, stage-1
    losses part faster than any bar of that size: the port against
    itself, its start perturbed by one float32 ulp, parts by 2.6e-5 at
    step 4, 3.8e-4 at step 5 and 2.8e-3 at step 6 (the correlation
    top-k and the kNN selections flip on near-ties as the weights part),
    and the port against JAX by as much, while every leaf stays within
    a quarter of the bar above."""
    state = seeded_state_dict(tconfig.ModelConfig(**TINY), 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(state))
    jmodel = JRaft(JConfig(use_pallas=False, **TINY))
    tx = optax.adam(jschedule(*SCHED_ARGS))
    opt_state = tx.init(params)
    jmulti, flat, unravel = jmultistep(jmodel, tx, GAMMA, ITERS, params,
                                       opt_state, K, donate=False)
    jsingle, flat1, _ = jpacked(jmodel, tx, GAMMA, ITERS, params, opt_state,
                                donate=False)
    ds = SyntheticDataset(size=2 * TRAJECTORY_STEPS, nb_points=N,
                          noise=0.01, seed=8, n_objects=3)
    batches = list(PrefetchLoader(ds, B, shuffle=True, num_workers=0,
                                  seed=8).epoch(0))
    assert len(batches) == TRAJECTORY_STEPS
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jl = []
    for i in (0, K):
        stacked = {k: jnp.stack([b[k] for b in jbatches[i:i + K]])
                   for k in jbatches[0]}
        flat, m = jmulti(flat, stacked)
        jl += np.asarray(m["loss"]).tolist()
    flat, m = jsingle(flat, jbatches[-1])
    jl.append(float(m["loss"]))

    model = PVRaft(tconfig.ModelConfig(**TINY))
    model.load_state_dict(state)
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(1e-3),
                           betas=(0.9, 0.999), eps=1e-8)
    schedule = make_lr_schedule(*SCHED_ARGS)
    packed = tsteps.PackedState(model, opt)
    multi, _, _ = tsteps.make_graphed_multistep_train_step(
        model, opt, schedule, GAMMA, ITERS, K, CPU, packed=packed)
    single, _, _ = tsteps.make_graphed_packed_train_step(
        model, opt, schedule, GAMMA, ITERS, CPU, packed=packed)
    tl = []
    dev = [to_device(b, "cpu") for b in batches]
    for i in (0, K):
        tl += multi(tsteps.stack_batches(dev[i:i + K]))["loss"].tolist()
    tl.append(float(single(dev[-1])["loss"]))
    # The first dispatch starts from the same state on both sides.
    np.testing.assert_allclose(tl[:K], jl[:K], rtol=1e-4, atol=0)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    want = params_from_jax(unravel(flat)[0])
    cap = 1.2 * TRAJECTORY_STEPS * SCHED_ARGS[1]
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= cap, name

    probe = PVRaft(tconfig.ModelConfig(**TINY))
    coupled, jcoupled = [], []
    for b, jb in zip(dev, jbatches):
        probe.load_state_dict(params_from_jax(unravel(flat1)[0]))
        with torch.no_grad():
            flows, _ = probe(b["pc1"], b["pc2"], ITERS)
            coupled.append(float(tsteps.sequence_loss(
                flows, b["mask"], b["flow"], GAMMA)))
        flat1, m = jsingle(flat1, jb)
        jcoupled.append(float(m["loss"]))
    np.testing.assert_allclose(coupled, jcoupled, rtol=1e-4, atol=0)
    # JAX's fused and single steps run the same trajectory.
    np.testing.assert_allclose(jcoupled, jl, rtol=1e-5, atol=0)
