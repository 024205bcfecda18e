"""The port's sequence parallelism against the JAX package's, on the CPU.

Gloo process groups of 2 and 4 ranks (``tests/test_torch_parallel.py``'s
spawner: each rank a process with its own timeout), each rank holding a
contiguous slice of each cloud's points, at tiny sizes (64 points,
truncate_k 16, corr_knn 8, graph_k 8, 2 iterations). The JAX side runs
``seq_shard`` on a 1 x P mesh of the 8 virtual CPU devices
(``tests/conftest.py``):

* ``ring_knn_indices``/``seq_sharded_graph`` at 2 and 4 ranks: the
  indices equal JAX's ring and the port's dense graph;
* ``ring_corr_init``: corr within 1e-5 of JAX's ring, the candidates'
  xyz equal;
* the sharded model's flows within 1e-5 of JAX ``PVRaft(seq_shard=True)``
  and of the one-rank port (the JAX bar, ``tests/test_parallel.py``);
* a 2 x 2 (data x seq) train step against one process at the global
  batch, on masks with holes: loss within 1e-6 relative, gradients within
  1e-4, the four ranks bitwise equal; the collectives a step issues.

The Trainer, the Evaluator and the CLIs on a seq axis:
``tests/test_torch_seq_engine.py``.

Each world size's ranks run once per module (:func:`_sharded`), and the
tests read their results. The JAX package is imported inside the tests:
the spawned ranks import this module and need only torch.
"""

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.config import ModelConfig
from test_torch_parallel import _spawn

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, B, ITERS, GAMMA, LR = 64, 2, 2, 0.8, 1e-3
SEED = 7


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


def _state():
    from pvraft_tpu_torch.weights import seeded_state_dict

    return seeded_state_dict(ModelConfig(**TINY), 11)


def _one_rank_model():
    from pvraft_tpu_torch.models import PVRaft

    model = PVRaft(ModelConfig(**TINY))
    model.load_state_dict(_state(), strict=True)
    return model


# --- the ranks ----------------------------------------------------------------


def _ring_worker(rank, tmp):
    """One rank of a 1 x P group: its rows' ring graph, ring correlation
    cache and sharded flows, and its share of a train step's loss and
    gradients."""
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.parallel import collectives, make_mesh, seq_rows
    from pvraft_tpu_torch.parallel.ring import (
        ring_corr_init,
        seq_sharded_graph,
    )

    world = torch.distributed.get_world_size()
    mesh = make_mesh(1, world)
    batch = {k: torch.from_numpy(v) for k, v in _clouds().items()}
    rows = seq_rows(N, mesh)
    local = {k: v[:, rows] for k, v in batch.items()}
    out = {"index": (mesh.data_index, mesh.seq_index)}
    graph = seq_sharded_graph(local["pc1"], TINY["graph_k"], mesh.seq_group)
    out["neighbors"], out["rel_pos"] = graph.neighbors, graph.rel_pos
    rng = np.random.default_rng(SEED + 1)
    f1 = torch.from_numpy(rng.normal(size=(B, N, 32)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(B, N, 32)).astype(np.float32))
    state = ring_corr_init(f1[:, rows], f2[:, rows], local["pc2"],
                           TINY["truncate_k"], mesh.seq_group)
    out["corr"], out["xyz"] = state.corr, state.xyz
    model = PVRaft(ModelConfig(seq_shard=True, **TINY), mesh)
    model.load_state_dict(_state(), strict=True)
    with torch.no_grad():
        out["flows"] = model(local["pc1"], local["pc2"], ITERS)[0]
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_train_step(model, opt, lambda _: LR, GAMMA, ITERS)
    collectives.CALLS.clear()
    m = step(local)
    out["calls"] = dict(collectives.CALLS)
    out["loss"], out["epe"] = float(m["loss"]), float(m["epe"])
    out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out


_RESULTS = {}


def _sharded(world, tmp_path_factory):
    """The ranks' results of :func:`_ring_worker` in a group of
    ``world``, once per module."""
    if world not in _RESULTS:
        _RESULTS[world] = _spawn(_ring_worker,
                                 tmp_path_factory.mktemp(f"seq{world}"),
                                 world=world)
    return _RESULTS[world]


def _joined(ranks, key, axis):
    return torch.cat([r[key] for r in ranks], dim=axis)


def _jmesh(world):
    from pvraft_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=1, n_seq=world)


# --- the rings ----------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_ring_knn_matches_jax_and_the_dense_graph(world, tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from pvraft_tpu.parallel.ring import seq_sharded_graph as jgraph
    from pvraft_tpu_torch.ops.geometry import build_graph

    ranks = _sharded(world, tmp_path_factory)
    assert [r["index"] for r in ranks] == [(0, s) for s in range(world)]
    got = _joined(ranks, "neighbors", 1)
    pc1 = _clouds()["pc1"]
    want = jax.jit(lambda pc: jgraph(pc, TINY["graph_k"], _jmesh(world)))(
        jnp.asarray(pc1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.neighbors))
    dense = build_graph(torch.from_numpy(pc1), TINY["graph_k"])
    assert torch.equal(got, dense.neighbors)
    np.testing.assert_allclose(_joined(ranks, "rel_pos", 1).numpy(),
                               np.asarray(want.rel_pos), atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_corr_init_matches_jax(world, tmp_path_factory):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pvraft_tpu.compat import shard_map
    from pvraft_tpu.ops.corr import CorrState
    from pvraft_tpu.parallel.ring import ring_corr_init as jring

    ranks = _sharded(world, tmp_path_factory)
    rng = np.random.default_rng(SEED + 1)
    f1 = rng.normal(size=(B, N, 32)).astype(np.float32)
    f2 = rng.normal(size=(B, N, 32)).astype(np.float32)
    spec = P(None, "seq", None)
    want = shard_map(
        lambda a, b, c: jring(a, b, c, TINY["truncate_k"], "seq"),
        mesh=_jmesh(world), in_specs=(spec, spec, spec),
        out_specs=CorrState(corr=spec, xyz=P(None, "seq", None, None)),
        check_vma=False)(jnp.asarray(f1), jnp.asarray(f2),
                         jnp.asarray(_clouds()["pc2"]))
    corr, xyz = _joined(ranks, "corr", 1), _joined(ranks, "xyz", 1)
    np.testing.assert_allclose(corr.numpy(), np.asarray(want.corr),
                               atol=1e-5)
    # The same candidates, in the same order (no near-ties here).
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(want.xyz))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_flows_match_jax_seq_shard_and_one_rank(world,
                                                        tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from pvraft_tpu.config import ModelConfig as JConfig
    from pvraft_tpu.models import PVRaft as JRaft
    from pvraft_tpu_torch.weights import params_to_jax

    ranks = _sharded(world, tmp_path_factory)
    got = _joined(ranks, "flows", 2).numpy()
    clouds = _clouds()
    with torch.no_grad():
        one = _one_rank_model()(torch.from_numpy(clouds["pc1"]),
                                torch.from_numpy(clouds["pc2"]),
                                ITERS)[0].numpy()
    jmodel = JRaft(JConfig(use_pallas=False, seq_shard=True, **TINY),
                   mesh=_jmesh(world))
    want, _ = jax.jit(lambda p, a, b: jmodel.apply(p, a, b, ITERS))(
        params_to_jax(_state()), jnp.asarray(clouds["pc1"]),
        jnp.asarray(clouds["pc2"]))
    assert got.shape == (ITERS, B, N, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got, one, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_group_train_step_sums_to_the_one_rank_step(world,
                                                        tmp_path_factory):
    """Within one seq group the reduced loss, EPE and gradients are the
    one-rank step's, every rank's the same; the step issues its
    collectives (shifts only in the forward rings and fmap2's way
    back)."""
    from pvraft_tpu_torch.engine.steps import make_train_step

    ranks = _sharded(world, tmp_path_factory)
    model = _one_rank_model()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    m = make_train_step(model, opt, lambda _: LR, GAMMA, ITERS)(
        {k: torch.from_numpy(v) for k, v in _clouds().items()})
    for r in ranks:
        assert (r["loss"], r["epe"]) == (ranks[0]["loss"], ranks[0]["epe"])
        assert abs(r["loss"] - float(m["loss"])) <= 1e-6 * abs(
            float(m["loss"]))
        assert abs(r["epe"] - float(m["epe"])) <= 1e-6 * abs(float(m["epe"]))
        for n, p in model.named_parameters():
            assert torch.equal(r["grads"][n], ranks[0]["grads"][n]), n
            torch.testing.assert_close(r["grads"][n], p.grad, atol=1e-4,
                                       rtol=1e-4, msg=n)
    calls = ranks[0]["calls"]
    # Forward: two kNN rings and the correlation ring, P - 1 shifts each;
    # backward: fmap2's P - 1 shifts back round the ring.
    assert calls["shift"] == 4 * (world - 1)
    assert calls["all_gather"] > 0 and calls["all_reduce"] > 0


# --- data x seq ---------------------------------------------------------------


def _dp_sp_worker(rank, tmp):
    """One rank of a 2 x 2 (data x seq) mesh: a train step on its data
    index's block of the global batch and its seq index's rows."""
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.parallel import make_mesh, seq_shard_batch

    mesh = make_mesh(2, 2)
    batch = {k: torch.from_numpy(v) for k, v in _clouds(4).items()}
    block = {k: v[2 * mesh.data_index:2 * mesh.data_index + 2]
             for k, v in batch.items()}
    model = PVRaft(ModelConfig(seq_shard=True, **TINY), mesh)
    model.load_state_dict(_state(), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_train_step(model, opt, lambda _: LR, GAMMA, ITERS)
    m = step(seq_shard_batch(block, mesh))
    return {"index": (mesh.data_index, mesh.seq_index),
            "loss": float(m["loss"]), "epe": float(m["epe"]),
            "n_seq": step.reduce.n_seq, "world": step.reduce.world,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


def test_data_seq_2x2_train_step_matches_one_process(tmp_path):
    """Two data indices of two seq ranks each, at per-device batch 2,
    against one process at the global batch 4 in which each data block's
    loss is taken alone and the two are averaged (the data axis's rule):
    loss within 1e-6 relative, gradients within 1e-4; the four ranks
    bitwise equal."""
    from pvraft_tpu_torch.engine.steps import sequence_loss_of

    ranks = _spawn(_dp_sp_worker, tmp_path, world=4)
    assert [r["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {(r["n_seq"], r["world"]) for r in ranks} == {(2, 4)}
    for r in ranks[1:]:
        assert (r["loss"], r["epe"]) == (ranks[0]["loss"], ranks[0]["epe"])
        for n in r["params"]:
            assert torch.equal(r["params"][n], ranks[0]["params"][n]), n
    model = _one_rank_model()
    batch = {k: torch.from_numpy(v) for k, v in _clouds(4).items()}
    loss = 0.0
    for d in range(2):
        block = {k: v[2 * d:2 * d + 2] for k, v in batch.items()}
        loss = loss + sequence_loss_of(model, block, GAMMA, ITERS)[0] / 2
    loss.backward()
    loss = float(loss.detach())
    assert abs(ranks[0]["loss"] - loss) <= 1e-6 * abs(loss)
    for n, p in model.named_parameters():
        torch.testing.assert_close(ranks[0]["grads"][n], p.grad, atol=1e-4,
                                   rtol=1e-4, msg=n)
