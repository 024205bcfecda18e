"""The port's training slice against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through ``pvraft_tpu`` and
``pvraft_tpu_torch``: losses and metrics at atol 1e-6, the learning-rate
schedules at every step, synthetic scenes and epoch batches bitwise,
Adam on identical gradients against ``optax.adam(schedule)`` at atol
1e-6 (also resumed from an optax state through ``opt_state_from_jax``),
the eval step's metrics (pooled and per scene), and a CPU ``Trainer``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu import rng as jrng
from pvraft_tpu.config import DataConfig as JDataConfig
from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.config import ParallelConfig as JParallelConfig
from pvraft_tpu.config import TrainConfig as JTrainConfig
from pvraft_tpu.data.generic import batches as jbatches
from pvraft_tpu.data.synthetic import SyntheticDataset as JSynthetic
from pvraft_tpu.engine import loss as jloss
from pvraft_tpu.engine import metrics as jmetrics
from pvraft_tpu.engine.schedule import make_lr_schedule as jschedule
from pvraft_tpu.engine.steps import make_eval_step as jmake_eval_step
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import rng as trng
from pvraft_tpu_torch.data import (
    PrefetchLoader,
    SyntheticDataset,
    first_batch,
    to_device,
)
from pvraft_tpu_torch.engine import loss as tloss
from pvraft_tpu_torch.engine import metrics as tmetrics
from pvraft_tpu_torch.engine import trainer as ttrainer
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import make_eval_step, scheduled_step
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.weights import opt_state_from_jax, params_from_jax
from torch_engines import close_engines  # noqa: F401  (autouse)

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, GAMMA = 2, 48, 2, 0.8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flows(seed, t=3):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 0.3, (B, N, 3)).astype(np.float32)
    flows = (gt + rng.normal(0, 0.08, (t, B, N, 3))).astype(np.float32)
    mask = (rng.uniform(size=(B, N)) > 0.3).astype(np.float32)
    return flows, mask, gt


# --- loss and metrics --------------------------------------------------------


@pytest.mark.parametrize("mask3", [False, True])
def test_losses_match_jax(mask3):
    flows, mask, gt = _flows(0)
    if mask3:
        mask = mask[..., None]
    for name, args in (("compute_loss", (flows[0], mask, gt)),
                       ("sequence_loss", (flows, mask, gt, GAMMA))):
        want = getattr(jloss, name)(*(jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in args))
        got = getattr(tloss, name)(*(torch.from_numpy(a) if isinstance(
            a, np.ndarray) else a for a in args))
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mask3", [False, True])
def test_metrics_match_jax(mask3):
    flows, mask, gt = _flows(1)
    if mask3:
        mask = mask[..., None]
    jargs = (jnp.asarray(flows[-1]), jnp.asarray(mask), jnp.asarray(gt))
    targs = (torch.from_numpy(flows[-1]), torch.from_numpy(mask),
             torch.from_numpy(gt))
    want = jmetrics.flow_metrics(*jargs)
    got = tmetrics.flow_metrics(*targs)
    assert set(got) == set(want) == {"epe3d", "acc3d_strict", "acc3d_relax",
                                     "outlier"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6)
    assert 0 < float(got["acc3d_relax"]) < 1         # thresholds exercised
    np.testing.assert_allclose(float(tmetrics.epe_train(*targs)),
                               float(jmetrics.epe_train(*jargs)), atol=1e-6)


# --- schedules ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["parity", "cosine", "constant"])
def test_schedules_match_jax_at_every_step(kind):
    args = (kind, 1e-3, 3, 4, 8)
    want, got = jschedule(*args), make_lr_schedule(*args)
    # JAX evaluates in float32 (as optax does), the port in float64: 1e-6
    # of the base rate covers float32 rounding of cos near -1.
    for step in range(14):        # past the end: cosine clamps
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0,
                                   atol=1e-9)
    with pytest.raises(ValueError):
        make_lr_schedule("bogus", 1e-3, 1, 1, 1)


# --- data ---------------------------------------------------------------------


def test_rng_streams_match_jax():
    for name in trng.STREAM_NAMES:
        assert trng.stream_tag(name) == jrng.stream_tag(name)
        assert trng.host_entropy(3, name, 7) == jrng.host_entropy(3, name, 7)
    with pytest.raises(ValueError):
        trng.stream_tag("serve.undeclared")


@pytest.mark.parametrize("n_objects", [1, 3])
def test_synthetic_scenes_and_batches_are_bitwise_jax(n_objects):
    kw = dict(size=5, nb_points=40, extra_points=8, noise=0.01, seed=4,
              n_objects=n_objects)
    jds, tds = JSynthetic(**kw), SyntheticDataset(**kw)
    for i in range(len(tds)):
        for a, b in zip(jds.load_sequence(i), tds.load_sequence(i)):
            np.testing.assert_array_equal(a, b)
    for epoch in (0, 1):
        jb = list(jbatches(jds, 2, shuffle=True, seed=9, epoch=epoch))
        tb = list(PrefetchLoader(tds, 2, shuffle=True, num_workers=0,
                                 seed=9).epoch(epoch))
        assert len(jb) == len(tb) == 2
        for x, y in zip(jb, tb):
            assert set(x) == set(y) == {"pc1", "pc2", "mask", "flow"}
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    tail = list(PrefetchLoader(tds, 2, drop_last=False,
                               num_workers=0).epoch(0))
    assert [t["pc1"].shape[0] for t in tail] == [2, 2, 1]
    dev = to_device(tail[0], "cpu")
    assert dev["pc1"].dtype == torch.float32 and dev["pc1"].shape == (2, 40, 3)


# --- config ------------------------------------------------------------------


def test_train_and_data_config_defaults_match_jax():
    for jc, tc in ((JDataConfig, tconfig.DataConfig),
                   (JTrainConfig, tconfig.TrainConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jc)}
        tf = {f.name: f.default for f in dataclasses.fields(tc)}
        assert jf == tf


@pytest.mark.parametrize("cls,kw,refused", [
    (tconfig.TrainConfig, {"ckpt_backend": "orbax"}, True),
    (tconfig.ParallelConfig, {"seq_axis": 4}, False),
])
def test_train_config_rejects_later_slices(cls, kw, refused):
    """A field whose feature is not ported raises; ``seq_axis``, ported
    with the sequence-parallel ring, is taken as JAX takes it."""
    if refused:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            cls(**kw)
        return
    jcls = {tconfig.ParallelConfig: JParallelConfig}[cls]
    assert dataclasses.asdict(cls(**kw)) == dataclasses.asdict(jcls(**kw))


@pytest.mark.parametrize("kw,error", [
    ({"divergence_zscore": 3.0}, None),
    ({"telemetry": True}, None),
    ({"halt_on_divergence": True}, None),
    ({"max_snapshots": 5}, None),
    ({"profile_dir": "profiles"}, None),
    ({"divergence_window": 1}, "divergence_window must be >= 2"),
    ({"divergence_zscore": -1.0}, "divergence_zscore must be >= 0"),
])
def test_train_config_observability_knobs_match_jax(kw, error):
    """The observability knobs are the JAX TrainConfig's: the same
    values accepted, the same ValueErrors."""
    if error is None:
        assert (dataclasses.asdict(tconfig.TrainConfig(**kw))
                == dataclasses.asdict(JTrainConfig(**kw)))
        return
    for cls in (tconfig.TrainConfig, JTrainConfig):
        with pytest.raises(ValueError, match=error):
            cls(**kw)


def test_make_train_step_rejects_later_levers():
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.obs.monitors import TELEMETRY_LEAVES

    with pytest.raises(ValueError, match="grad_dtype"):
        make_train_step(None, None, None, GAMMA, 1, grad_dtype="float16")
    # telemetry is ported: the step returns JAX's leaves.
    model = TRaft(tconfig.ModelConfig(**TINY))
    step = make_train_step(model, torch.optim.Adam(model.parameters()),
                           lambda _: 1e-3, GAMMA, 1, telemetry=True)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (B, N, 3)).astype(
        np.float32)) for k in ("pc1", "pc2", "flow")}
    batch["mask"] = torch.ones(B, N)
    tel = step(batch)["telemetry"]
    assert tuple(tel) == TELEMETRY_LEAVES
    assert set(tel["grad_norm_by_group"]) == {
        "context_extractor", "feature_extractor", "update_iter"}
    assert tel["delta_flow_norm"].shape == (1,) and int(tel["nonfinite"]) == 0


# --- Adam and the optax state ------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    x = np.random.default_rng(2).uniform(-1, 1, (1, N, 3)).astype(np.float32)
    return jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                   static_argnums=3)(jax.random.key(1), jnp.asarray(x),
                                     jnp.asarray(x), 1)


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
        params)


def _torch_model(params):
    model = TRaft(tconfig.ModelConfig(**TINY))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _set_grads(model, jgrads):
    g = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        p.grad = g[name].clone()


def _assert_params(model, jp, atol):
    want = params_from_jax(jp)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def test_adam_matches_optax_and_resumes_from_its_state(jparams):
    sched_args = ("cosine", 1e-3, 1, 4, 4)      # lr moves every step
    tx = optax.adam(jschedule(*sched_args))
    schedule = make_lr_schedule(*sched_args)
    jp, js = jparams, tx.init(jparams)
    model = _torch_model(jparams)
    opt = torch.optim.Adam(model.parameters(), lr=1.0, betas=(0.9, 0.999),
                           eps=1e-8)
    @jax.jit
    def jstep(grads, js, jp):
        updates, js = tx.update(grads, js, jp)
        return optax.apply_updates(jp, updates), js

    for step in range(3):
        grads = _grads_like(jparams, step)
        jp, js = jstep(grads, js, jp)
        _set_grads(model, grads)
        scheduled_step(opt, schedule)
        _assert_params(model, jp, 1e-6)
    # Resume: a fresh port model and optimizer from the JAX params and
    # optax state continue with the same fourth step.
    resumed = _torch_model(jp)
    opt2 = torch.optim.Adam(resumed.parameters())
    opt2.load_state_dict(opt_state_from_jax(js, resumed))
    grads = _grads_like(jparams, 3)
    jp, js = jstep(grads, js, jp)
    _set_grads(resumed, grads)
    scheduled_step(opt2, schedule)
    _assert_params(resumed, jp, 1e-6)
    assert all(int(s["step"]) == 4 for s in opt2.state.values())


def test_opt_state_from_jax_rejects_a_foreign_state(jparams):
    model = _torch_model(jparams)
    with pytest.raises(KeyError, match="no Adam state"):
        opt_state_from_jax({"count": 1}, model)
    moments = jax.tree_util.tree_map(np.zeros_like, jparams)
    moments["params"]["update_iter"]["update_block"]["gru"]["convz"][
        "bias"] = np.zeros(3, np.float32)
    foreign = {"0": {"count": 1, "mu": moments, "nu": moments}, "1": {}}
    with pytest.raises(ValueError, match="shape"):
        opt_state_from_jax(foreign, model)


# --- eval step and trainer ---------------------------------------------------


@pytest.mark.parametrize("per_scene", [False, True])
def test_eval_step_matches_jax(jparams, per_scene):
    ds = SyntheticDataset(size=B, nb_points=N, noise=0.01, seed=3)
    batch = first_batch(PrefetchLoader(ds, B, num_workers=0))
    jm = JRaft(JConfig(use_pallas=False, **TINY))
    want, jflow = jmake_eval_step(jm, ITERS, GAMMA, per_scene=per_scene)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, tflow = make_eval_step(_torch_model(jparams), ITERS, GAMMA,
                                per_scene=per_scene)(to_device(batch, "cpu"))
    np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), atol=2e-4)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == ((B,) if per_scene else ())
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def _tiny_cfg(exp_path="experiments/default", **train):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=4),
        train=tconfig.TrainConfig(num_epochs=1, iters=ITERS,
                                  eval_iters=ITERS, **train),
        exp_path=str(exp_path))


def test_trainer_runs_an_epoch_on_the_cpu(jparams, tmp_path):
    trainer = ttrainer.Trainer(_tiny_cfg(tmp_path), device="cpu",
                               weights=jparams)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    out = trainer.training(0)
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["loss"]) and np.isfinite(out["epe"])
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert len(moved) == 95                       # every leaf trained
    val = trainer.val_test(0, "val")
    assert set(val) == {"loss", "epe3d", "acc3d_strict", "acc3d_relax",
                        "outlier"}
    assert all(np.isfinite(v) for v in val.values())
    seen = []
    test = trainer.fit(lambda epoch, tr, va: seen.append(epoch))
    assert seen == [0] and set(test) == set(val)


def test_trainer_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(_tiny_cfg())
    # The default dataset is FT3D, which needs its tree at ``root``.
    with pytest.raises(RuntimeError, match="expected 19640 train scenes"):
        ttrainer.Trainer(tconfig.Config(), device="cpu")


def test_train_cli_runs_on_the_cpu_and_rejects_later_flags(capsys,
                                                           tmp_path):
    from pvraft_tpu_torch import train

    train.main(["--dataset", "synthetic", "--device", "cpu",
                "--exp_path", str(tmp_path),
                "--max_points", str(N), "--synthetic_size", "2",
                "--truncate_k", "16", "--corr_knn", "8", "--iters", "1",
                "--eval_iters", "1", "--num_epochs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and '"test"' in lines[-1]
    with pytest.raises(SystemExit):
        train.main(["--dataset", "synthetic", "--refine", "--seq_parallel",
                    "2"])
    assert "not ported yet" in capsys.readouterr().err


def test_kernel_bench_runs_on_the_cpu_and_needs_cuda_otherwise(
        capsys, monkeypatch):
    from pvraft_tpu_torch import kernel_bench

    kernel_bench.main(["--device", "cpu", "--points", str(N), "--k", "16",
                       "--batch", "1"])
    out = capsys.readouterr().out.splitlines()
    rows = [ln[:20].strip() for ln in out if "ms  (host clock)" in ln]
    assert rows == [
        "lookup plain", "lookup voxel-kernel", "lookup fused",
        "corr_init dense", "corr_init chunked", "corr_init approx",
        "knn graph dense", "knn graph chunked", "gru fused"]
    assert "dtype=float32" in out[0] and out[9].endswith("float32")
    assert not any("not ported" in ln for ln in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.main([])
