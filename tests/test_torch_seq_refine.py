"""Stage 2 (``PVRaftRefine``) under sequence parallelism, on the CPU.

Gloo process groups of 2 and 4 ranks (``tests/test_torch_parallel.py``'s
spawner: each rank a process with its own timeout), each rank holding a
contiguous slice of each cloud's points, at tiny sizes (64 points,
truncate_k 16, corr_knn 8, graph_k 8, 2 iterations), on masks with
holes. The weights are seeded once and pass through
``weights.params_to_jax`` / ``params_from_jax`` on both sides:

* the joined refined flow within 5e-5 of JAX
  ``PVRaftRefine(seq_shard=True)`` on a 1 x P mesh of the 8 virtual CPU
  devices (``tests/conftest.py``) and of the one-rank port. The bar sits
  above stage 1's 1e-5 (``tests/test_torch_seq_parallel.py``): the head
  adds three SetConvs of group-wide GroupNorms on the backbone's last
  flow, and JAX's own sharded refined flow parts from its unsharded one
  by 1.6e-5 at P = 2 and 1.9e-5 at P = 4 on these sizes;
* a refine train step against the one-rank step on the same batch: loss
  within 1e-6 relative, head gradients within 1e-4, every backbone
  gradient None, the ranks bitwise equal, no ring shift in the backward;
* the refine eval step's per-scene shares summed over the group against
  one rank;
* the refine Trainer (with ``load_stage1_weights`` into the sharded
  backbone) and Evaluator at 1 x 2 against one process.

Each world size's ranks run once per module (:func:`_sharded`). The JAX
package is imported inside the tests: the spawned ranks import this
module and need only torch.
"""

import os

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from test_torch_parallel import _spawn

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, B, ITERS, GAMMA, LR = 64, 2, 2, 0.8, 1e-3
SEED = 7
FLOW_ATOL = 5e-5


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clouds(batch=B):
    """pc1, pc2 (batch, N, 3) float32, a 0/1 mask with holes and a flow."""
    rng = np.random.default_rng(SEED)
    pc1 = rng.uniform(-1, 1, (batch, N, 3)).astype(np.float32)
    flow = rng.normal(0, 0.05, (batch, N, 3)).astype(np.float32)
    pc2 = (pc1 + flow + rng.normal(0, 0.01, pc1.shape)).astype(np.float32)
    mask = (rng.uniform(size=(batch, N)) > 0.2).astype(np.float32)
    return {"pc1": pc1, "pc2": pc2, "mask": mask, "flow": flow}


def _params():
    """The refine model's seeded weights as a flax tree (what JAX
    applies; the port loads it through ``params_from_jax``)."""
    from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

    return params_to_jax(seeded_state_dict(ModelConfig(**TINY), 11,
                                           refine=True))


def _refine_model(mesh=None):
    from pvraft_tpu_torch.models import PVRaftRefine
    from pvraft_tpu_torch.weights import params_from_jax

    model = PVRaftRefine(ModelConfig(seq_shard=mesh is not None, **TINY),
                         mesh)
    model.load_state_dict(params_from_jax(_params()), strict=True)
    return model


def _step(model):
    """The refine train step on an Adam over the head."""
    from pvraft_tpu_torch.engine.steps import make_refine_train_step
    from pvraft_tpu_torch.weights import trained_parameters

    opt = torch.optim.Adam([p for _, p in trained_parameters(model)], lr=LR)
    return make_refine_train_step(model, opt, lambda _: LR, ITERS)


def _grads(model):
    return {n: None if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


# --- the ranks ----------------------------------------------------------------


def _refine_worker(rank, tmp):
    """One rank of a 1 x P group: its rows' refined flow, its per-scene
    shares of the refine eval step, and a refine train step's reduced
    loss and gradients with the collectives it issued."""
    from pvraft_tpu_torch.engine.steps import make_eval_step
    from pvraft_tpu_torch.parallel import collectives, make_mesh, seq_rows

    mesh = make_mesh(1, torch.distributed.get_world_size())
    rows = seq_rows(N, mesh)
    local = {k: torch.from_numpy(v)[:, rows] for k, v in _clouds().items()}
    model = _refine_model(mesh)
    out = {"index": (mesh.data_index, mesh.seq_index),
           "sharded": model.seq_group is not None
           and model.ref_conv3.gn3.seq_group is model.seq_group}
    with torch.no_grad():
        out["flow"] = model(local["pc1"], local["pc2"], ITERS)
    out["eval"] = make_eval_step(model, ITERS, GAMMA, per_scene=True,
                                 refine=True)(local)[0]
    step = _step(model)
    collectives.CALLS.clear()
    m = step(local)
    out["calls"] = dict(collectives.CALLS)
    out["loss"], out["epe"] = float(m["loss"]), float(m["epe"])
    out["n_seq"] = step.reduce.n_seq
    out["grads"] = _grads(model)
    return out


_RESULTS = {}


def _sharded(world, tmp_path_factory):
    """The ranks' results of :func:`_refine_worker` in a group of
    ``world``, once per module."""
    if world not in _RESULTS:
        _RESULTS[world] = _spawn(_refine_worker,
                                 tmp_path_factory.mktemp(f"refine{world}"),
                                 world=world)
    return _RESULTS[world]


def _local_batch():
    return {k: torch.from_numpy(v) for k, v in _clouds().items()}


# --- the model ----------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_refined_flow_matches_jax_seq_shard_and_one_rank(world,
                                                         tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from pvraft_tpu.config import ModelConfig as JConfig
    from pvraft_tpu.models import PVRaftRefine as JRefine
    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    ranks = _sharded(world, tmp_path_factory)
    assert [r["index"] for r in ranks] == [(0, s) for s in range(world)]
    assert all(r["sharded"] for r in ranks)
    got = torch.cat([r["flow"] for r in ranks], dim=1).numpy()
    clouds = _clouds()
    with torch.no_grad():
        one = _refine_model()(torch.from_numpy(clouds["pc1"]),
                              torch.from_numpy(clouds["pc2"]),
                              ITERS).numpy()
    jmodel = JRefine(JConfig(use_pallas=False, seq_shard=True, **TINY),
                     mesh=jmake_mesh(n_data=1, n_seq=world))
    want = jax.jit(lambda p, a, b: jmodel.apply(p, a, b, ITERS))(
        _params(), jnp.asarray(clouds["pc1"]), jnp.asarray(clouds["pc2"]))
    assert got.shape == (B, N, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=FLOW_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, one, atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_refine_train_step_sums_to_the_one_rank_step(world,
                                                     tmp_path_factory):
    """The reduced loss, EPE and head gradients are the one-rank refine
    step's, every rank's bitwise the same; every backbone leaf's gradient
    is None. The backbone runs without autograd, so its rings shift only
    forward: two kNN rings and the correlation ring, P - 1 shifts
    each."""
    ranks = _sharded(world, tmp_path_factory)
    model = _refine_model()
    m = _step(model)(_local_batch())
    want = _grads(model)
    for r in ranks:
        assert r["n_seq"] == world
        assert (r["loss"], r["epe"]) == (ranks[0]["loss"], ranks[0]["epe"])
        assert abs(r["loss"] - float(m["loss"])) <= 1e-6 * abs(
            float(m["loss"]))
        assert abs(r["epe"] - float(m["epe"])) <= 1e-6 * abs(float(m["epe"]))
        for n, g in want.items():
            if n.startswith("backbone."):
                assert g is None and r["grads"][n] is None, n
                continue
            assert torch.equal(r["grads"][n], ranks[0]["grads"][n]), n
            torch.testing.assert_close(r["grads"][n], g, atol=1e-4,
                                       rtol=1e-4, msg=n)
    calls = ranks[0]["calls"]
    assert calls["shift"] == 3 * (world - 1)
    assert calls["all_gather"] > 0 and calls["all_reduce"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_refine_eval_shares_sum_to_the_one_rank_metrics(world,
                                                        tmp_path_factory):
    """Each rank's per-scene loss and metrics are its share of the
    scene's: summed over the group they are one rank's, within 1e-5."""
    from pvraft_tpu_torch.engine.steps import make_eval_step

    ranks = _sharded(world, tmp_path_factory)
    want = make_eval_step(_refine_model(), ITERS, GAMMA, per_scene=True,
                          refine=True)(_local_batch())[0]
    for k, v in want.items():
        got = sum(r["eval"][k] for r in ranks)
        assert got.shape == (B,)
        torch.testing.assert_close(got, v, atol=1e-5, rtol=1e-5, msg=k)


# --- the Trainer and the Evaluator at 1 x 2 -----------------------------------


def _cfg(exp, seq=1) -> Config:
    return Config(model=ModelConfig(seq_shard=seq > 1, **TINY),
                  data=DataConfig(dataset="synthetic", max_points=N,
                                  synthetic_size=4, num_workers=0),
                  train=TrainConfig(batch_size=2, num_epochs=1, iters=ITERS,
                                    eval_iters=ITERS, refine=True),
                  parallel=ParallelConfig(seq_axis=seq),
                  exp_path=str(exp))


def _stage1_weights():
    from pvraft_tpu_torch.weights import seeded_state_dict

    return seeded_state_dict(ModelConfig(**TINY), 3)


def _engine_worker(rank, tmp, stage1):
    """The refine Trainer (the stage-1 checkpoint imported into its
    backbone, one epoch) and the refine Evaluator, on a 1 x 2 mesh
    (``rank`` >= 0) or one process."""
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import make_mesh

    seq = torch.distributed.get_world_size() if rank >= 0 else 1
    trainer = Trainer(_cfg(os.path.join(tmp, "exp"), seq), device="cpu")
    try:
        epoch = trainer.load_stage1_weights(stage1)
        imported = all(torch.equal(p, _stage1_weights()[n]) for n, p in
                       trainer.model.backbone.named_parameters())
        out = trainer.training(0)
    finally:
        trainer.close()
    ev = Evaluator(_cfg(os.path.join(tmp, "eval"), seq), device="cpu",
                   mesh=make_mesh(n_seq=seq))
    try:
        # Its seeded head on the stage-1 backbone, the same on both sides.
        ev.model.backbone.load_state_dict(_stage1_weights())
        means = ev.run()
    finally:
        ev.close()
    return {"epoch": epoch, "imported": imported, "losses": out["losses"],
            "sharded": trainer.model.seq_group is not None,
            "reduce": trainer.train_step.reduce.n_seq
            if trainer.train_step.reduce is not None else None,
            "means": means,
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}


def test_refine_trainer_and_evaluator_at_1x2_match_one_rank(tmp_path):
    """A 1 x 2 refine Trainer imports the same stage-1 checkpoint on both
    ranks and trains its head one epoch against one process: step 1's
    loss within 1e-6 relative, the next within 1e-4, the head's
    parameters within 1.2 x steps x lr (Adam's first updates are ~lr x
    sign(g), the repo's bar for lock-stepped trajectories), the backbone
    bitwise the checkpoint's; the refine Evaluator on the stage-1
    backbone within 1e-5; the ranks bitwise equal."""
    from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.weights import opt_state_to_jax, params_to_jax

    stage1 = _stage1_weights()
    s1 = PVRaft(ModelConfig(**TINY))
    s1.load_state_dict(stage1)
    path = save_checkpoint(
        str(tmp_path / "stage1"), params_to_jax(stage1),
        opt_state_to_jax(torch.optim.Adam(s1.parameters()), s1), 4, 0)[0]
    ranks = _spawn(_engine_worker, tmp_path / "ranks", path)
    one_dir = tmp_path / "one"
    one_dir.mkdir()
    one = _engine_worker(-1, str(one_dir), path)
    assert (one["sharded"], one["reduce"]) == (False, None)
    for r in ranks:
        assert (r["epoch"], r["imported"], r["sharded"], r["reduce"]) == \
            (4, True, True, 2)
        assert r["losses"] == ranks[0]["losses"]
        assert r["means"] == ranks[0]["means"]
        for n, p in r["params"].items():
            assert torch.equal(p, ranks[0]["params"][n]), n
    first, *rest = zip(ranks[0]["losses"], one["losses"])
    assert len(one["losses"]) == 2
    assert abs(first[0] - first[1]) <= 1e-6 * abs(first[1])
    for a, b in rest:
        assert abs(a - b) <= 1e-4 * abs(b)
    bar = 1.2 * len(one["losses"]) * TrainConfig().lr
    for n, p in one["params"].items():
        if n.startswith("backbone."):
            assert torch.equal(ranks[0]["params"][n], p)
            assert torch.equal(p, stage1[n[len("backbone."):]]), n
            continue
        np.testing.assert_allclose(ranks[0]["params"][n].numpy(), p.numpy(),
                                   atol=bar, rtol=0, err_msg=n)
    for k, v in one["means"].items():
        assert abs(ranks[0]["means"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
