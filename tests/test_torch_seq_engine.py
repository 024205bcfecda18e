"""The Trainer, the Evaluator and the CLIs on a sequence axis, on the CPU.

Gloo groups of two ranks (``tests/test_torch_parallel.py``'s spawner) as
one seq group (a 1 x 2 mesh), each rank on its rows of every scene, at
tiny sizes (64 points, truncate_k 16, corr_knn 8, graph_k 8, 2
iterations), against one process; both CLIs at stage 2 too; the
refusals of a seq axis; the catalog's ``dp_sp_2x2_train_step`` on 4
ranks. Stage 2's model, steps, Trainer and Evaluator on a seq axis:
``tests/test_torch_seq_refine.py``. The rings
and the model against the JAX package: ``tests/test_torch_seq_parallel.py``.
"""

import json
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
N, ITERS = 64, 2


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --- the Trainer, the Evaluator and the CLIs at 1 x 2 -------------------------


def _cfg(exp, seq=1, **train) -> Config:
    return Config(model=ModelConfig(seq_shard=seq > 1, **TINY),
                  data=DataConfig(dataset="synthetic", max_points=N,
                                  synthetic_size=4, num_workers=0),
                  train=TrainConfig(batch_size=2, num_epochs=1, iters=ITERS,
                                    eval_iters=ITERS, checkpoint_interval=1,
                                    **train),
                  parallel=ParallelConfig(seq_axis=seq),
                  exp_path=str(exp))


def _fit_worker(rank, tmp):
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import make_mesh

    seq = torch.distributed.get_world_size() if rank >= 0 else 1
    trainer = Trainer(_cfg(os.path.join(tmp, "exp"), seq), device="cpu")
    losses = trainer.training(0)["losses"]
    trainer.close()
    ev = Evaluator(_cfg(os.path.join(tmp, "eval"), seq), device="cpu",
                   mesh=make_mesh(n_seq=seq))
    means = ev.run()
    ev.close()
    return {"losses": losses, "means": means, "shard": ev.shard,
            "loader": trainer.train_loader.shard,
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}


def test_trainer_and_evaluator_at_1x2_match_one_rank(tmp_path):
    """A 1 x 2 Trainer's epoch (both ranks load the same batches and take
    their rows) against one process: step 1's loss within 1e-6 relative;
    the parameters after the epoch's steps within 1.2 x steps x lr, since
    Adam's first updates are ~lr x sign(g) and a gradient of ~0 takes
    either sign (the repo's bar for lock-stepped trajectories; the
    gradients themselves are held to 1e-4 in
    ``tests/test_torch_seq_parallel.py``); the Evaluator's means within
    1e-5, the ranks bitwise equal."""
    ranks = _spawn(_fit_worker, tmp_path / "ranks")
    one_dir = tmp_path / "one"
    one_dir.mkdir()
    one = _fit_worker(-1, str(one_dir))
    for r in ranks:
        assert r["loader"] == (0, 1) and r["shard"] == (0, 1)
        assert r["losses"] == ranks[0]["losses"]
        assert r["means"] == ranks[0]["means"]
        for n, p in r["params"].items():
            assert torch.equal(p, ranks[0]["params"][n]), n
    # Step 1's loss to 1e-6; Adam's first updates (~lr x sign(g)) part
    # where a gradient is ~0, and the next losses follow within 1e-4.
    first, *rest = zip(ranks[0]["losses"], one["losses"])
    assert abs(first[0] - first[1]) <= 1e-6 * abs(first[1])
    for a, b in rest:
        assert abs(a - b) <= 1e-4 * abs(b)
    bar = 1.2 * len(one["losses"]) * TrainConfig().lr
    for n, p in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][n].numpy(), p.numpy(),
                                   atol=bar, rtol=0, err_msg=n)
    for k, v in one["means"].items():
        assert abs(ranks[0]["means"][k] - v) <= 1e-5 * max(1.0, abs(v)), k


def _cli_worker(rank, tmp):
    from pvraft_tpu_torch import test as test_cli
    from pvraft_tpu_torch import train as train_cli

    exp = os.path.join(tmp, "exp")
    flags = ["--dataset", "synthetic", "--device", "cpu", "--max_points",
             str(N), "--synthetic_size", "2", "--truncate_k", "16",
             "--corr_knn", "8", "--num_workers", "0", "--seq_parallel", "2"]
    train_cli.main(flags + ["--exp_path", exp, "--iters", "1",
                            "--eval_iters", "1", "--num_epochs", "1"])
    test_cli.main(flags + ["--exp_path", os.path.join(tmp, "test"),
                           "--eval_iters", "1", "--weights", os.path.join(
                               exp, "checkpoints", "best_checkpoint.msgpack")])
    return sorted(os.listdir(os.path.join(exp, "checkpoints")))


def test_clis_train_and_evaluate_at_seq_parallel_2(tmp_path, capfd):
    """``train --seq_parallel 2`` in a group of two ranks (torchrun's
    environment) writes one checkpoint set, and ``test --seq_parallel 2``
    evaluates it; rank 0 alone prints."""
    ranks = _spawn(_cli_worker, tmp_path)
    assert ranks[0] == ranks[1] == ["best_checkpoint.msgpack",
                                    "last_checkpoint.msgpack"]
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [sorted(x) for x in lines] == [
        ["epoch", "train", "val"], ["device", "test"],
        ["acc3d_relax", "acc3d_strict", "epe3d", "loss", "outlier"]]
    assert all(np.isfinite(v) for v in lines[-1].values())


def _refine_cli_worker(rank, tmp, stage1):
    from pvraft_tpu_torch import test as test_cli
    from pvraft_tpu_torch import train as train_cli

    exp = os.path.join(tmp, "exp")
    flags = ["--dataset", "synthetic", "--device", "cpu", "--max_points",
             str(N), "--synthetic_size", "2", "--truncate_k", "16",
             "--corr_knn", "8", "--num_workers", "0", "--seq_parallel", "2",
             "--refine"]
    train_cli.main(flags + ["--exp_path", exp, "--iters", "1",
                            "--eval_iters", "1", "--num_epochs", "1",
                            "--stage1_weights", stage1])
    test_cli.main(flags + ["--exp_path", os.path.join(tmp, "test"),
                           "--eval_iters", "1", "--weights", os.path.join(
                               exp, "checkpoints", "best_checkpoint.msgpack")])
    return sorted(os.listdir(os.path.join(exp, "checkpoints")))


def test_refine_clis_train_and_evaluate_at_seq_parallel_2(tmp_path, capfd):
    """``train --refine --seq_parallel 2 --stage1_weights CKPT`` in a group
    of two ranks imports the stage-1 checkpoint on both and writes one
    checkpoint set, and ``test --refine --seq_parallel 2`` evaluates it;
    rank 0 alone prints."""
    from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.weights import (
        opt_state_to_jax, params_to_jax, seeded_state_dict)

    cfg = ModelConfig(truncate_k=16, corr_knn=8)
    stage1 = seeded_state_dict(cfg, 3)
    model = PVRaft(cfg)
    model.load_state_dict(stage1)
    path = save_checkpoint(
        str(tmp_path / "stage1"), params_to_jax(stage1),
        opt_state_to_jax(torch.optim.Adam(model.parameters()), model),
        0, 0)[0]
    ranks = _spawn(_refine_cli_worker, tmp_path / "ranks", path)
    assert ranks[0] == ranks[1] == ["best_checkpoint.msgpack",
                                    "last_checkpoint.msgpack"]
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [sorted(x) for x in lines] == [
        ["epoch", "train", "val"], ["device", "test"],
        ["acc3d_relax", "acc3d_strict", "epe3d", "loss", "outlier"]]
    assert all(np.isfinite(v) for v in lines[-1].values())


def test_sequence_axis_refusals():
    """A seq axis without ``seq_shard`` and a seq layout without groups
    raise, for stage 2 as for stage 1; stage 2 on a seq axis (item 8c,
    since ported) passes the Trainer's checks and builds;
    ``seq_rows`` refuses a point count the axis does not divide."""
    from pvraft_tpu_torch.engine.trainer import _check_parallel
    from pvraft_tpu_torch.models import PVRaft, PVRaftRefine
    from pvraft_tpu_torch.parallel import Mesh, seq_rows

    mesh = Mesh(1, 2, 0, 2)
    with pytest.raises(ValueError, match="needs ModelConfig.seq_shard"):
        _check_parallel(_cfg("unused"), mesh, torch.device("cpu"), False)
    with pytest.raises(ValueError, match="needs ModelConfig.seq_shard"):
        _check_parallel(_cfg("unused", refine=True), mesh,
                        torch.device("cpu"), False)
    _check_parallel(_cfg("unused", 2, refine=True), mesh,
                    torch.device("cpu"), False)
    for cls in (PVRaft, PVRaftRefine):
        with pytest.raises(ValueError, match="process group"):
            cls(ModelConfig(seq_shard=True, **TINY), mesh)
    # Without a mesh, or on a seq axis of one, stage 2 is the one-rank
    # model (the sharded build on real groups: test_torch_seq_refine.py).
    for m in (None, Mesh(1, 1, 0, 1)):
        refine = PVRaftRefine(ModelConfig(seq_shard=True, **TINY), m)
        assert refine.seq_group is None
        assert refine.ref_conv1.seq_group is None
    assert seq_rows(64, Mesh(1, 2, 1, 2)) == slice(32, 64)
    with pytest.raises(ValueError, match="must divide the point count"):
        seq_rows(63, mesh)
    # seq_shard without a seq axis is the one-rank model.
    model = PVRaft(ModelConfig(seq_shard=True, **TINY), Mesh(1, 1, 0, 1))
    assert model.seq_group is None


def _dp_sp_spec_worker(rank, tmp):
    from pvraft_tpu_torch.programs import get, load_catalog

    load_catalog()
    fn, inputs = get("dp_sp_2x2_train_step").build("cpu", "tiny")
    mesh = fn.module.mesh
    loss, epe = fn(*inputs)
    return {"index": (mesh.data_index, mesh.seq_index),
            "shapes": [list(t.shape) for t in inputs],
            "sharded": fn.module.seq_group is not None,
            "loss": float(loss), "epe": float(epe)}


def test_dp_sp_spec_runs_on_four_ranks(tmp_path):
    """The catalog's ``dp_sp_2x2_train_step`` on 4 ranks: each rank's
    program on its scene of the flagship batch of 2 and its 32 of the 64
    tiny points, sequence-parallel, the reduced loss and EPE the same on
    every rank."""
    ranks = _spawn(_dp_sp_spec_worker, tmp_path, world=4)
    assert [r["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["sharded"]
        assert r["shapes"] == [[1, N // 2, 3], [1, N // 2, 3], [1, N // 2],
                               [1, N // 2, 3]]
        assert (r["loss"], r["epe"]) == (ranks[0]["loss"], ranks[0]["epe"])
        assert np.isfinite(r["loss"])
