"""The port's data parallelism against the JAX package's, on the CPU.

Gloo process groups of two ranks, each rank a process spawned by the
test with its own timeout (a hung peer is killed and fails that test
alone), at tiny sizes (64 points, truncate_k 16, corr_knn 8, graph_k 8,
2 iterations):

* the contract arithmetic (``make_mesh``, ``batch_contract``,
  ``eval_scene_shard``) against the JAX functions with JAX's process count monkeypatched, on the cases of
  ``tests/test_parallel.py``; the partitioning rules over the port's 95
  leaves as flax paths;
* ``initialize`` from ``torchrun``'s environment, idempotent; the mesh's
  groups;
* the gradients of two ranks at per-device batch 2, all-reduced in the
  train step, against ``jax.value_and_grad`` of ``sequence_loss`` at
  batch 4 on the same weights (1e-4) and the port's one-process batch-4
  step (1e-5); the ranks bitwise equal after every step;
* a two-rank ``Trainer.fit`` (one writer, one event stream, the ranks
  bitwise equal, within 5e-4 of one process at the global batch, the
  JAX bar of ``tests/test_parallel.py``);
* the Evaluator sharded over two ranks against one process at batch 1,
  and ``eval_batch`` 4 on scenes of unequal point and mask counts
  against batch 1 per scene;
* every refusal of a multi-process run.

The JAX package is imported inside the tests that use it: the spawned
ranks import this module and need only torch.
"""

import multiprocessing
import os
import socket
import time

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
from pvraft_tpu_torch.data import SceneFlowDataset, SyntheticDataset, collate
from pvraft_tpu_torch.parallel import distributed as tdist
from pvraft_tpu_torch.parallel import mesh as tmesh

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
N, ITERS, GAMMA, LR = 64, 2, 0.8, 1e-3
GROUP_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(exp, batch_size=2, **train) -> Config:
    return Config(model=ModelConfig(**TINY),
                  data=DataConfig(dataset="synthetic", max_points=N,
                                  synthetic_size=4, num_workers=0),
                  train=TrainConfig(batch_size=batch_size, num_epochs=1,
                                    iters=ITERS, eval_iters=ITERS,
                                    checkpoint_interval=1, **train),
                  exp_path=str(exp))


# --- spawned groups -----------------------------------------------------------


def _held_store():
    """A store server on a port the kernel picks, held by this process
    until the group is done, as torchrun's agent holds its store: the
    ranks join it as clients (``TORCHELASTIC_USE_AGENT_STORE``). A port
    found free, released and bound again by rank 0 seconds later can be
    taken in between by any connection on the host; a held one cannot.
    Returns (store, port); drop the store when the group has left."""
    store = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True,
                                       wait_for_workers=False)
    return store, store.port


def _rank_entry(fn, rank, world, port, tmp, args):
    """A rank: joins the gloo group through torchrun's environment (the
    spawner's store, as torchrun's agent's), runs ``fn(rank, tmp,
    *args)``, saves its result, leaves the group."""
    torch.set_num_threads(2)
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "TORCHELASTIC_USE_AGENT_STORE": "True"})
    assert tdist.initialize() is True
    try:
        out = fn(rank, tmp, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        tdist.shutdown()


def _spawn(fn, tmp_path, *args, world=2, timeout=GROUP_TIMEOUT_S):
    """Run ``fn`` on ``world`` gloo ranks; their results, by rank. A rank
    alive after ``timeout`` seconds is killed, and the test fails."""
    ctx = multiprocessing.get_context("spawn")
    store, port = _held_store()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, port, str(tmp_path), args))
             for r in range(world)]
    started = time.monotonic()
    for p in procs:
        p.start()
    deadline = started + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join(10)
        del store
    seconds = time.monotonic() - started
    assert not hung, f"{len(hung)} rank(s) still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world, \
        f"rank exit codes {[p.exitcode for p in procs]} after {seconds:.1f} s"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_the_rendezvous_port_stays_held_until_the_group_is_done():
    """No other socket can bind the spawner's store port while the store
    lives, and a rank joins through it as torchrun's workers join their
    agent's store."""
    store, port = _held_store()
    with socket.socket() as s, pytest.raises(OSError):
        s.bind(("127.0.0.1", port))
    client = torch.distributed.TCPStore("127.0.0.1", port, world_size=2,
                                        is_master=False)
    client.set("rank1", "up")
    assert store.get("rank1") == b"up"
    del client, store


# --- the contract arithmetic against JAX --------------------------------------


@pytest.mark.parametrize("n_data,n_seq", [
    (None, 1), (4, 2), (8, 1), (5, 2), (3, 2), (1, 1), (0, 1)])
def test_make_mesh_matches_jax_exact_cover(n_data, n_seq):
    """JAX with an explicit device list (every one of the 8) must cover it
    exactly, as the port's ranks must cover the world: the same layouts
    are built and the same ones refused, a sequence axis included
    (``make_mesh(4, 2, world=8)`` is JAX's 4 x 2)."""
    import jax

    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    try:
        want = dict(jmake_mesh(n_data, n_seq, devices=jax.devices()).shape)
    except ValueError:
        with pytest.raises(ValueError, match="does not cover|>= 1 device"):
            tmesh.make_mesh(n_data, n_seq, world=8)
        return
    if n_seq > 1:
        assert want == {"data": n_data, "seq": n_seq}
    assert tmesh.make_mesh(n_data, n_seq, world=8).shape == want


@pytest.mark.parametrize("n_seq", [2, 4, 8])
@pytest.mark.parametrize("build", ["make_mesh", "Mesh"])
def test_a_sequence_axis_is_refused_naming_item_8b(build, n_seq):
    """(Named for the refusal it held before the ring was ported.) Both
    ``make_mesh`` and a hand-built ``Mesh`` lay out a sequence axis of
    more than one rank as JAX's ``reshape(devices, (n_data, n_seq))``
    places the devices: rank r at data index r // n_seq and seq index
    r % n_seq; the data axis's shares count data indices. A layout of
    arithmetic holds no groups; a hand-built one holds the groups it is
    given."""
    import jax

    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    n_data = 8 // n_seq
    grid = np.asarray(jmake_mesh(n_data, n_seq, devices=jax.devices())
                      .devices)
    ids = [d.id for d in jax.devices()]
    groups = (object(), object(), object())
    for r in range(8):
        mesh = (tmesh.make_mesh(n_data, n_seq, world=8) if build ==
                "make_mesh" else tmesh.Mesh(n_data, n_seq, r, 8, *groups))
        if build == "make_mesh":
            assert (mesh.group, mesh.data_group, mesh.seq_group) == \
                (None, None, None)
            mesh = tmesh.Mesh(n_data, n_seq, r, 8)
        else:
            assert (mesh.data_group, mesh.seq_group, mesh.group) == groups
        d, s = mesh.data_index, mesh.seq_index
        assert grid[d, s].id == ids[r]
        assert mesh.data_shares == n_data
        assert tmesh.seq_rows(64, mesh) == slice(s * 64 // n_seq,
                                                 (s + 1) * 64 // n_seq)


def test_make_mesh_refuses_a_partial_layout_where_jax_takes_a_prefix():
    """JAX lays a smaller mesh over the first devices of the host; a rank
    cannot sit out of its own run, so the port refuses (and one process
    with no group is a world of 1)."""
    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    assert dict(jmake_mesh(n_data=1).shape) == {"data": 1, "seq": 1}
    with pytest.raises(ValueError, match="does not cover 8"):
        tmesh.make_mesh(n_data=1, world=8)
    assert tmesh.make_mesh() == tmesh.Mesh(1, 1, 0, 1)


def _jax_outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("procs", [1, 2, 3, 4])
@pytest.mark.parametrize("n_data", [1, 8])
@pytest.mark.parametrize("per_device", [1, 2, 3])
def test_batch_contract_matches_jax(monkeypatch, procs, n_data, per_device):
    import jax

    from pvraft_tpu.parallel.mesh import batch_contract as jcontract
    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    monkeypatch.setattr(jax, "process_count", lambda: procs)
    want = _jax_outcome(lambda: jcontract(per_device,
                                          jmake_mesh(n_data=n_data)))
    got = _jax_outcome(lambda: tmesh.batch_contract(
        per_device, tmesh.Mesh(n_data, 1, 0, procs)))
    assert got == want


@pytest.mark.parametrize("procs,index,scenes,eval_batch", [
    (1, 0, 400, 8), (2, 1, 400, 8), (2, 1, 402, 8), (2, 1, 400, 2),
    (2, 0, 142, 1), (4, 3, 400, 2)])
def test_eval_scene_shard_matches_jax(monkeypatch, procs, index, scenes,
                                      eval_batch):
    """The gates of ``tests/test_parallel.py::test_eval_scene_shard_gates``
    and more, on an 8-device data axis."""
    import jax

    from pvraft_tpu.parallel.mesh import eval_scene_shard as jshard
    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    monkeypatch.setattr(jax, "process_count", lambda: procs)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    want = jshard(scenes, eval_batch, jmake_mesh(n_data=8))
    got = tmesh.eval_scene_shard(scenes, eval_batch,
                                 tmesh.Mesh(8, 1, index, procs))
    assert got == want


def test_partition_rules_cover_the_ports_leaves_as_jax_does():
    """The rules are the JAX package's, the port's 95 leaves (flax paths)
    are the committed params tree's, each matches exactly one rule, and
    every spec replicates; a ladder that shards or overlaps raises."""
    from pvraft_tpu.programs import partitioning as jpart
    from pvraft_tpu_torch.models import PVRaft, PVRaftRefine
    from pvraft_tpu_torch.programs import partitioning as tpart

    assert tpart.PARTITION_RULES == jpart.PARTITION_RULES
    assert (tpart.MESH_AXES, tpart.BATCH_PARTITION) == (
        jpart.MESH_AXES, jpart.BATCH_PARTITION)
    model = PVRaft(ModelConfig())
    paths = tpart.flax_leaf_paths(model.state_dict())
    tree = jpart.load_params_tree(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "params_tree.json"))
    assert paths == [leaf["path"] for leaf in tree["leaves"]]
    assert len(paths) == 95
    assert tpart.match_partition_rules(tpart.PARTITION_RULES, paths) == \
        jpart.match_partition_rules(jpart.PARTITION_RULES, paths)
    assert set(tpart.check_replicated(model).values()) == {()}
    assert set(tpart.check_replicated(
        PVRaftRefine(ModelConfig()).backbone).values()) == {()}
    sharding = ((r"^params/(feature|context)_extractor/", ("data",)),
                *tpart.PARTITION_RULES[1:])
    with pytest.raises(NotImplementedError,
                       match="places no parameter shard"):
        tpart.check_replicated(model, sharding)
    overlap = (*tpart.PARTITION_RULES, (r"gru", ()))
    for side in (tpart, jpart):
        with pytest.raises(ValueError, match="exactly-once"):
            side.match_partition_rules(overlap, paths)
        assert side.match_report(overlap, paths)[3] == []


# --- initialize and the mesh's groups ----------------------------------------


def test_initialize_without_a_multiprocess_environment(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert tdist.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.initialize() is False
    assert not tdist.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.default_backend() == "gloo"
    with pytest.raises(ValueError, match="num_processes and process_id"):
        tdist.initialize(coordinator_address="127.0.0.1:1")


def _init_worker(rank, tmp):
    import torch.distributed as dist

    out = {"again": tdist.initialize(), "index": tdist.process_index(),
           "count": tdist.process_count(),
           "backend": dist.get_backend()}
    mesh = tmesh.make_mesh()
    out["mesh"] = (mesh.n_data, mesh.n_seq, mesh.process_index,
                   mesh.process_count)
    try:
        tmesh.make_mesh(1)
    except ValueError as e:
        out["partial"] = str(e)
    out["data_group"] = dist.get_world_size(mesh.data_group)
    seq = tmesh.make_mesh(1, 2)
    out["seq"] = (seq.shape, seq.data_index, seq.seq_index,
                  dist.get_world_size(seq.seq_group),
                  dist.get_world_size(seq.data_group),
                  dist.get_world_size(seq.group))
    flag = tmesh.all_true(rank == 0, mesh, torch.device("cpu"))
    out["all_true"] = (flag, tmesh.all_true(True, mesh, torch.device("cpu")))
    return out


def test_initialize_reads_torchruns_environment(tmp_path):
    outs = _spawn(_init_worker, tmp_path)
    for rank, out in enumerate(outs):
        assert out["again"] is True and out["backend"] == "gloo"
        assert (out["index"], out["count"]) == (rank, 2)
        assert out["mesh"] == (2, 1, rank, 2)
        assert "does not cover 2" in out["partial"]
        assert out["data_group"] == 2
        assert out["seq"] == ({"data": 1, "seq": 2}, 0, rank, 2, 1, 2)
        assert out["all_true"] == (False, True)


# --- every train step factory reduces in a group of one rank ----------------


def _factory_steps(kind, graphed):
    """Two train steps of one factory (``kind``: "single", "refine",
    "packed" or "multistep", the last one call of K = 2) from seeded
    weights: the losses, the parameters and Adam's state after them, and
    the step's reduction."""
    from pvraft_tpu_torch.engine import steps as tsteps
    from pvraft_tpu_torch.models import PVRaft, PVRaftRefine
    from pvraft_tpu_torch.weights import seeded_state_dict, trained_parameters

    refine = kind == "refine"
    cfg = ModelConfig(**TINY)
    model = (PVRaftRefine if refine else PVRaft)(cfg)
    model.load_state_dict(seeded_state_dict(cfg, 0, refine=refine))
    opt = torch.optim.Adam([p for _, p in trained_parameters(model)],
                           lr=torch.tensor(LR), betas=(0.9, 0.999), eps=1e-8)
    schedule = lambda _: LR  # noqa: E731
    dev = (torch.device("cpu"),) if graphed else ()
    batches = [{k: torch.from_numpy(v[rows]) for k, v in _batch4().items()}
               for rows in (slice(0, 2), slice(2, 4))]
    if kind in ("single", "refine"):
        make = {("single", False): tsteps.make_train_step,
                ("single", True): tsteps.make_graphed_train_step,
                ("refine", False): tsteps.make_refine_train_step,
                ("refine", True): tsteps.make_graphed_refine_train_step}[
                    kind, graphed]
        args = (model, opt, schedule) + ((ITERS,) if refine
                                         else (GAMMA, ITERS))
        step = make(*args, *dev)
    elif kind == "packed":
        make = (tsteps.make_graphed_packed_train_step if graphed
                else tsteps.make_packed_train_step)
        step = make(model, opt, schedule, GAMMA, ITERS, *dev)[0]
    else:
        make = (tsteps.make_graphed_multistep_train_step if graphed
                else tsteps.make_multistep_train_step)
        step = make(model, opt, schedule, GAMMA, ITERS, 2, *dev)[0]
        batches = [tsteps.stack_batches(batches)]
    losses = [step(b)["loss"].reshape(-1).tolist() for b in batches]
    state = [p.detach().clone() for p in model.parameters()] + [
        opt.state[p][k].clone() for g in opt.param_groups
        for p in g["params"] for k in tsteps.ADAM_KEYS]
    return losses, state, step.reduce


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("kind", ["single", "refine", "packed", "multistep"])
def test_every_train_step_factory_reduces_in_a_group_of_one(kind, graphed,
                                                           monkeypatch):
    """In a gloo group of one rank (this process) every factory's step
    runs its collective, not short-circuited at world 1, and stays
    bitwise the step without a group: a sum over one rank scaled by 1.
    Without a group there is no reduction."""
    want, want_state, none = _factory_steps(kind, graphed)
    assert none is None
    store, port = _held_store()
    monkeypatch.setenv("TORCHELASTIC_USE_AGENT_STORE", "True")
    assert tdist.initialize(f"127.0.0.1:{port}", num_processes=1,
                            process_id=0, backend="gloo") is True
    try:
        got, state, reduce = _factory_steps(kind, graphed)
    finally:
        tdist.shutdown()
        del store
    assert reduce is not None and reduce.world == 1 and not reduce.average
    assert reduce.calls >= 2
    assert got == want
    assert len(state) == len(want_state) and all(
        torch.equal(a, b) for a, b in zip(state, want_state))


# --- gradients: two ranks at batch 2 against one process at batch 4 -----------


def _batch4():
    ds = SyntheticDataset(size=4, nb_points=N, noise=0.01, seed=5)
    return collate([ds[i] for i in range(4)])


def _state():
    from pvraft_tpu_torch.weights import seeded_state_dict

    return seeded_state_dict(ModelConfig(**TINY), 11)


def _steps(rows, steps):
    """``steps`` eager train steps on ``rows`` of the 4-scene batch:
    each step's loss, EPE, gradients (after the step's reduction) and
    parameters."""
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.models import PVRaft

    model = PVRaft(ModelConfig(**TINY))
    model.load_state_dict(_state(), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = make_train_step(model, opt, lambda _: LR, GAMMA, ITERS)
    batch = {k: torch.from_numpy(v[rows]) for k, v in _batch4().items()}
    out = []
    for _ in range(steps):
        m = step(batch)
        out.append({
            "loss": float(m["loss"]), "epe": float(m["epe"]),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}})
    return {"steps": out,
            "reduces": step.reduce.calls if step.reduce else None}


def _grad_worker(rank, tmp):
    return _steps(slice(2 * rank, 2 * rank + 2), 3)


def test_two_ranks_match_jax_and_one_process_at_the_global_batch(tmp_path):
    import jax
    import jax.numpy as jnp

    from pvraft_tpu.config import ModelConfig as JConfig
    from pvraft_tpu.engine.loss import sequence_loss as jsequence_loss
    from pvraft_tpu.models import PVRaft as JRaft
    from pvraft_tpu_torch.weights import params_from_jax, params_to_jax

    ranks = _spawn(_grad_worker, tmp_path)
    one = _steps(slice(0, 4), 3)
    assert one["reduces"] is None and [r["reduces"] for r in ranks] == [3, 3]
    for i in range(3):
        a, b = ranks[0]["steps"][i], ranks[1]["steps"][i]
        # The ranks hold the same gradients, loss and parameters, bitwise.
        assert (a["loss"], a["epe"]) == (b["loss"], b["epe"])
        for key in ("grads", "params"):
            for n in a[key]:
                assert torch.equal(a[key][n], b[key][n]), (i, key, n)
        w = one["steps"][i]
        assert abs(a["loss"] - w["loss"]) <= 1e-5 * max(1.0, abs(w["loss"]))
        assert abs(a["epe"] - w["epe"]) <= 1e-5 * max(1.0, abs(w["epe"]))
        if i == 0:
            for n in w["grads"]:
                torch.testing.assert_close(a["grads"][n], w["grads"][n],
                                           atol=1e-5, rtol=1e-5, msg=n)
        # Adam's first steps are ~lr x sign(g): where a gradient is ~1e-10
        # (0 on one side, summation noise on the other) the updates part
        # by ~1e-5, so parameters are held to the JAX package's bar for
        # data-parallel against one device (tests/test_parallel.py).
        for n in w["params"]:
            torch.testing.assert_close(a["params"][n], w["params"][n],
                                       atol=5e-4, rtol=0, msg=n)

    batch = _batch4()
    params = params_to_jax(_state())
    model = JRaft(JConfig(use_pallas=False, **TINY))

    def loss_fn(p):
        flows, _ = model.apply(p, jnp.asarray(batch["pc1"]),
                               jnp.asarray(batch["pc2"]), ITERS)
        return jsequence_loss(flows, jnp.asarray(batch["mask"]),
                              jnp.asarray(batch["flow"]), GAMMA)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    first = ranks[0]["steps"][0]
    assert abs(first["loss"] - float(jloss)) <= 1e-4
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for n, g in want.items():
        np.testing.assert_allclose(first["grads"][n].numpy(), g.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


# --- the Trainer --------------------------------------------------------------


def _trainer_worker(rank, tmp, one_process):
    from pvraft_tpu_torch.engine import trainer as ttrainer

    writes = []
    real = ttrainer.save_checkpoint

    def counted(*a, **kw):
        writes.append(a[3])
        return real(*a, **kw)

    ttrainer.save_checkpoint = counted
    try:
        cfg = _cfg(os.path.join(tmp, "exp"),
                   batch_size=4 if one_process else 2, telemetry=True)
        trainer = ttrainer.Trainer(cfg, device="cpu")
        assert (trainer.global_batch, trainer.train_loader.batch_size) == \
            ((4, 4) if one_process else (4, 2))
        shards = dict(trainer.eval_shards)
        test = trainer.fit()
    finally:
        ttrainer.save_checkpoint = real
    return {"params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()},
            "test": test, "writes": writes, "shards": shards,
            "snap_capable": trainer._snap_capable,
            "steps": trainer.step_count}


def test_two_rank_trainer_fit(tmp_path):
    from pvraft_tpu_torch.obs.events import read_events, validate_events_file

    ranks = _spawn(_trainer_worker, tmp_path, False)
    exp = tmp_path / "exp"
    one_dir = tmp_path / "one"
    one_dir.mkdir()
    one = _trainer_worker(0, str(one_dir), True)
    # One writer; the other rank read the same best checkpoint back.
    assert ranks[0]["writes"] and ranks[1]["writes"] == []
    assert sorted(os.listdir(exp / "checkpoints")) == [
        "000.msgpack", "best_checkpoint.msgpack", "last_checkpoint.msgpack"]
    # One event stream (rank 0's), valid, and one log.
    streams = sorted(p for p in os.listdir(exp) if p.endswith(".jsonl"))
    assert streams == ["train.events.jsonl"]
    assert validate_events_file(str(exp / "train.events.jsonl")) == []
    header = read_events(str(exp / "train.events.jsonl"))[0]
    assert (header["devices"]["process_index"],
            header["devices"]["process_count"]) == (0, 2)
    assert [f for f in os.listdir(exp / "logs") if f.endswith(".log")] == [
        "Train_synthetic.log"]
    assert not (exp / "snapshots").exists()
    for r, out in enumerate(ranks):
        assert out["snap_capable"] is False and out["steps"] == 1
        assert out["shards"] == {"val": (r, 2), "test": (r, 2)}
    assert one["snap_capable"] is True
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
        np.testing.assert_allclose(p.numpy(), one["params"][n].numpy(),
                                   atol=5e-4, err_msg=n)
    assert ranks[0]["test"] == ranks[1]["test"]
    for k, v in one["test"].items():
        assert abs(ranks[0]["test"][k] - v) <= 1e-4 * max(1.0, abs(v)), k


# --- the Evaluator ------------------------------------------------------------


def _evaluator_worker(rank, tmp):
    from pvraft_tpu_torch.engine.evaluator import Evaluator

    ev = Evaluator(_cfg(os.path.join(tmp, "eval")), device="cpu")
    out = {"shard": ev.shard, "eval_batch": ev.eval_batch,
           "means": ev.run()}
    try:
        ev.run(dump_dir=os.path.join(tmp, "dump"))
    except ValueError as e:
        out["dump"] = str(e)
    ev.close()
    return out


def test_sharded_evaluator_matches_one_process(tmp_path):
    from pvraft_tpu_torch.engine.evaluator import Evaluator

    ranks = _spawn(_evaluator_worker, tmp_path)
    ev = Evaluator(_cfg(tmp_path / "one", eval_batch=1), device="cpu")
    want = ev.run()
    ev.close()
    for r, out in enumerate(ranks):
        assert out["shard"] == (r, 2) and out["eval_batch"] == 2
        assert out["means"] == ranks[0]["means"]
        assert "single-host only" in out["dump"]
        for k, v in want.items():
            assert abs(out["means"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    assert sorted(p for p in os.listdir(tmp_path / "eval")
                  if p.endswith(".jsonl")) == ["testalone.events.jsonl"]


class _Ragged(SceneFlowDataset):
    """Six scenes of 64 to 249 raw points, each with its own share of
    masked points: per-scene metrics differ from a batch's pooled ones."""

    def __init__(self):
        super().__init__(N, seed=3)

    def __len__(self):
        return 6

    def load_sequence(self, idx):
        rng = np.random.default_rng(100 + idx)
        n = N + 37 * idx
        pc1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        flow = rng.normal(0, 0.1 * (idx + 1), (n, 3)).astype(np.float32)
        mask = (rng.uniform(size=n) > 0.1 * idx).astype(np.float32)
        return pc1, pc1 + flow, mask, flow


def test_eval_batch_4_matches_batch_1_per_scene(tmp_path, monkeypatch):
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
    from pvraft_tpu_torch.engine import evaluator as tevaluator
    from pvraft_tpu_torch.engine.steps import make_eval_step

    monkeypatch.setattr(tevaluator, "build_eval_dataset",
                        lambda cfg: _Ragged())
    runs = {}
    for eb in (1, 4):
        ev = tevaluator.Evaluator(_cfg(tmp_path / f"eb{eb}", eval_batch=eb),
                                  device="cpu")
        # The captured shapes: 4 scenes and the 2-scene tail.
        assert len(ev.compile_report()) == (1 if eb == 1 else 2)
        runs[eb] = (ev, ev.run())
    (ev1, m1), (ev4, m4) = runs[1], runs[4]
    for k, v in m1.items():
        assert abs(m4[k] - v) <= 1e-5 * max(1.0, abs(v)), k
    step = make_eval_step(ev4.model, ITERS, GAMMA, per_scene=True)
    batch = to_device(first_batch(PrefetchLoader(_Ragged(), 4,
                                                 num_workers=0)), "cpu")
    per4, _ = step(batch)
    pooled, _ = make_eval_step(ev4.model, ITERS, GAMMA)(batch)
    for b in range(4):
        one = {k: v[b:b + 1] for k, v in batch.items()}
        per1, _ = ev1.eval_step(one)
        for k in per4:
            assert abs(float(per4[k][b]) - float(per1[k][0])) <= 1e-5 * max(
                1.0, abs(float(per1[k][0]))), (b, k)
    # The masks part the scenes: a pooled batch mean is another number.
    assert abs(float(pooled["epe3d"]) - float(per4["epe3d"].mean())) > 1e-4
    for ev, _ in runs.values():
        ev.close()


# --- refusals -----------------------------------------------------------------


@pytest.mark.parametrize("parallel,mesh,error,match", [
    ({"packed_state": True, "steps_per_dispatch": 2},
     tmesh.Mesh(2, 1, 0, 2), ValueError, "single-process only"),
    ({"packed_state": True, "host_roundtrip": True},
     tmesh.Mesh(2, 1, 0, 2), ValueError, "single-host only"),
    ({"data_axis": 2}, None, ValueError, "does not cover 1"),
    ({}, tmesh.Mesh(1, 1, 0, 3), ValueError,
     "multiple of the process count"),
])
def test_trainer_refuses_what_a_multiprocess_run_cannot_do(
        tmp_path, parallel, mesh, error, match):
    from pvraft_tpu_torch.engine.trainer import Trainer

    cfg = _cfg(tmp_path).replace(parallel=ParallelConfig(**parallel))
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu", mesh=mesh)


def test_trainer_rejects_indivisible_global_batch_as_jax_does(
        tmp_path, monkeypatch):
    """The JAX twin of the last refusal above
    (``tests/test_parallel.py``)."""
    import jax

    from pvraft_tpu.config import Config as JC
    from pvraft_tpu.config import DataConfig as JD
    from pvraft_tpu.config import ModelConfig as JM
    from pvraft_tpu.config import TrainConfig as JT
    from pvraft_tpu.engine.trainer import Trainer as JTrainer
    from pvraft_tpu.parallel.mesh import make_mesh as jmake_mesh

    monkeypatch.setattr(jax, "process_count", lambda: 3)
    cfg = JC(model=JM(**TINY), data=JD(dataset="synthetic", max_points=N,
                                       synthetic_size=4, num_workers=0),
             train=JT(batch_size=2, num_epochs=1, iters=ITERS,
                      eval_iters=ITERS), exp_path=str(tmp_path))
    with pytest.raises(ValueError, match="multiple of .* process count"):
        JTrainer(cfg, mesh=jmake_mesh(n_data=1))


def test_graphs_need_nccl_on_the_card(monkeypatch):
    """gloo collectives cannot be captured: graphed steps with gloo on a
    card raise (never a quiet fall back to eager); eager steps, or the
    CPU, are fine."""
    import torch.distributed as dist

    from pvraft_tpu_torch.engine.trainer import _check_parallel

    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    mesh = tmesh.Mesh(2, 1, 0, 2, data_group=object())
    cfg = _cfg("unused")
    with pytest.raises(ValueError, match="need NCCL"):
        _check_parallel(cfg, mesh, torch.device("cuda"), graphs=True)
    _check_parallel(cfg, mesh, torch.device("cuda"), graphs=False)
    _check_parallel(cfg, mesh, torch.device("cpu"), graphs=True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    _check_parallel(cfg, mesh, torch.device("cuda"), graphs=True)


def test_seq_parallel_stays_refused_naming_item_8b(capsys):
    """(Named for the refusal it held before the ring was ported.)
    ``seq_shard`` and ``seq_axis`` are taken, and both CLIs' ``--seq_parallel
    2`` parses into them, with ``--refine`` too (stage 2 on a seq axis)."""
    from pvraft_tpu_torch import test as ttest_cli
    from pvraft_tpu_torch import train as ttrain_cli

    assert ModelConfig(seq_shard=True).seq_shard is True
    assert ParallelConfig(seq_axis=2).seq_axis == 2
    for cli in (ttrain_cli, ttest_cli):
        cfg = cli.config_from_args(cli.parse_args(["--seq_parallel", "2"]))
        assert (cfg.model.seq_shard, cfg.parallel.seq_axis) == (True, 2)
        cfg = cli.config_from_args(cli.parse_args(
            ["--refine", "--seq_parallel", "2"]))
        assert (cfg.train.refine, cfg.model.seq_shard,
                cfg.parallel.seq_axis) == (True, True, 2)
        assert capsys.readouterr().err == ""
    args = ttrain_cli.parse_args(["--data_parallel", "2"])
    assert ttrain_cli.config_from_args(args).parallel.data_axis == 2
    assert TrainConfig(eval_batch=4).eval_batch == 4
    assert ttest_cli.config_from_args(ttest_cli.parse_args(
        ["--eval_batch", "4"])).train.eval_batch == 4


def test_run_header_names_the_process_group(monkeypatch):
    from pvraft_tpu_torch.obs import events as tevents

    monkeypatch.setattr(tevents, "process_index", lambda: 1)
    monkeypatch.setattr(tevents, "process_count", lambda: 2)
    devices = tevents.run_metadata({})["devices"]
    assert (devices["process_index"], devices["process_count"]) == (1, 2)
