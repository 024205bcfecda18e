"""The port's compiled-program layer on the CPU: captured serve programs,
graphed train and eval steps, the retrace guard, and the routing of
``use_pallas=None`` by what each CUDA kernel takes (the tuned kernel,
else the general one; the plain version only under ``use_pallas=False``).

On the CPU a captured program runs its function on the same static
buffers that the card replays (``serve/aot.py``), so these tests hold
the static-buffer plumbing: every request and step equals a fresh eager
run bitwise, and the JAX package at the bars of
``tests/test_torch_serve.py`` (flows 2e-4) and
``tests/test_torch_grad.py`` (two coupled Adam steps: loss and EPE 1e-4,
parameters 2 * lr). The card's twins are in ``tests/test_torch_cuda.py``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.engine.schedule import make_lr_schedule as jschedule
from pvraft_tpu.engine.steps import make_train_step as jmake_train_step
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.programs.geometries import predict_program_name as jname
from pvraft_tpu.serve import InferenceEngine as JEngine
from pvraft_tpu.serve import ServeConfig as JServeConfig
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch import train as tcli
from pvraft_tpu_torch.data import (
    PrefetchLoader,
    SyntheticDataset,
    collate,
    first_batch,
    to_device,
)
from pvraft_tpu_torch.engine import trainer as ttrainer
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import (
    make_eval_step,
    make_graphed_eval_step,
    make_graphed_train_step,
    make_train_step,
    optimizer_steps,
)
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.obs.retrace import RetraceError
from pvraft_tpu_torch.ops.cuda import kernel_of, kernel_takes
from pvraft_tpu_torch.serve import InferenceEngine as TEngine
from pvraft_tpu_torch.serve import ServeConfig as TServeConfig
from pvraft_tpu_torch.serve.aot import (
    capture,
    first_difference,
    predict_program_name,
)
from pvraft_tpu_torch.weights import (
    opt_state_from_jax,
    params_from_jax,
    seeded_state_dict,
)
from torch_engines import close_engines  # noqa: F401  (autouse)

CPU = torch.device("cpu")
TINY_SERVE = {"truncate_k": 16, "corr_knn": 8, "graph_k": 4}
SERVE = {"buckets": (32, 64), "batch_sizes": (1, 2), "num_iters": 2,
         "dtype": "float32", "replicas": 1}
TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, GAMMA, LR = 2, 48, 2, 0.8, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cloud(rng, n):
    return rng.uniform(-1, 1, (n, 3)).astype(np.float32)


# --- routing by what each kernel takes ---------------------------------------


@pytest.mark.parametrize("kw,takes", [
    ({}, ("tuned", "tuned", "tuned")),
    ({"resolution": 2}, ("general", "general", "tuned")),
    ({"corr_knn": 48, "truncate_k": 64}, ("general", "tuned", "tuned")),
    ({"truncate_k": 1024}, ("general", "general", "tuned")),
    ({"hidden_dim": 32}, ("tuned", "tuned", "general")),
    ({"context_dim": 128}, ("tuned", "tuned", "general")),
])
def test_kernel_takes_table_and_routing(kw, takes):
    cfg = tconfig.ModelConfig(**kw)
    kernels = ("corr_lookup", "voxel_corr", "gru_iter")
    assert kernel_takes(cfg) == dict(zip(kernels, takes))
    card, host = SimpleNamespace(is_cuda=True), SimpleNamespace(is_cuda=False)
    for kernel in kernels:
        # A CUDA kernel on the card, tuned or general; never the plain
        # version unless the caller asks for it.
        assert tconfig.resolve_use_pallas(cfg, card, kernel) is True
        assert tconfig.resolve_use_pallas(cfg, host, kernel) is False
        for forced in (True, False):
            explicit = dataclasses.replace(cfg, use_pallas=forced)
            assert tconfig.resolve_use_pallas(explicit, card, kernel) is forced


@pytest.mark.parametrize("event,wrapper", [
    ("(anonymous namespace)::gru_kernel(float const*, float const*, float "
     "cons", "fused_gru_update"),
    ("corr_lookup_kernel(float const*, float const*, float const*, float*",
     "fused_corr_lookup"),
    ("(anonymous namespace)::voxel_corr_kernel<4>(float const*",
     "voxel_bin_means_pallas"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, char*",
     None),
    ("pvraft.corr_lookup", None),
    ("(anonymous namespace)::corr_lookup_general_kernel((anonymous "
     "namespace)::Lookup)", "corr_lookup_general"),
    ("(anonymous namespace)::gru_general_kernel((anonymous namespace)::Gru)",
     "gru_iter_general"),
    ("void (anonymous namespace)::gru_general_kernel<false, 256>((anonymous "
     "namespace)::Args, int)", "gru_iter_general"),
])
def test_profiler_events_name_their_kernel(event, wrapper):
    """The measured launch counts on the card read the profiler's kernel
    names by the device symbols of ``csrc/*.cu``."""
    assert kernel_of(event) == wrapper


# --- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_engines():
    rng = np.random.default_rng(0)
    pc = jnp.asarray(_cloud(rng, 24)[None])
    variables = jax.jit(JRaft(JConfig(**TINY_SERVE)).init, static_argnums=3)(
        jax.random.key(0), pc, pc, 2)
    jeng = JEngine(variables,
                   JServeConfig(model=JConfig(**TINY_SERVE), **SERVE))
    tcfg = TServeConfig(model=tconfig.ModelConfig(**TINY_SERVE), **SERVE)
    return variables, jeng, tcfg


def test_compile_report_names_the_jax_programs(serve_engines):
    variables, jeng, tcfg = serve_engines
    teng = TEngine(variables, tcfg, device="cpu")
    names = [r["name"] for r in teng.compile_report()]
    assert names == [r["name"] for r in jeng.compile_report()]
    assert names == [jname(b, bs) for b in SERVE["buckets"]
                     for bs in SERVE["batch_sizes"]]
    for dtype in ("float32", "bfloat16"):
        assert predict_program_name(64, 4, dtype) == jname(64, 4, dtype)
    assert all(not r["graph"] and r["launches"] == {}
               for r in teng.compile_report())


@pytest.mark.parametrize("order", [(64, 40, 33), (33, 40, 64), (40, 64, 33)])
def test_static_buffers_carry_nothing_between_requests(serve_engines, order):
    variables, jeng, tcfg = serve_engines
    rng = np.random.default_rng(sum(order))
    requests = {n: (_cloud(rng, n), _cloud(rng, n - 3)) for n in order}
    shared = TEngine(variables, tcfg, device="cpu")
    program = shared.program(64, 1)
    for n in order:
        pc1, pc2 = requests[n]
        got = shared.predict(pc1, pc2)
        fresh = TEngine(variables, tcfg, device="cpu").predict(pc1, pc2)
        np.testing.assert_array_equal(got, fresh)
        np.testing.assert_allclose(got, jeng.predict(pc1, pc2), rtol=0,
                                   atol=2e-4)
    # The bucket's bs-1 program holds the last request's padded clouds.
    last = shared.padded_batch([requests[order[-1]]], 64)
    assert all(np.array_equal(s.numpy(), a)
               for s, a in zip(program.inputs, last))
    # A two-request batch, then a single request in the same bucket: the
    # bs-2 program's fill slot and the bs-1 program stay independent.
    pair = [requests[order[0]], requests[order[1]]]
    got = shared.predict_batch(pair, 64)
    want = jeng.predict_batch(pair, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    again = shared.predict(*requests[order[2]])
    np.testing.assert_array_equal(
        again, TEngine(variables, tcfg, device="cpu").predict(
            *requests[order[2]]))


def test_graph_program_checks_its_inputs():
    program = capture("double", lambda x: (2 * x,), (torch.zeros(2, 3),), CPU)
    out, = program(torch.ones(2, 3))
    assert torch.equal(out, torch.full((2, 3), 2.0))
    again, = program(torch.full((2, 3), 3.0))
    assert again is out and torch.equal(out, torch.full((2, 3), 6.0))
    with pytest.raises(ValueError, match="program takes"):
        program(torch.ones(3, 3))
    with pytest.raises(ValueError, match="program takes"):
        program(torch.ones(2, 3, dtype=torch.float64))


# --- training ----------------------------------------------------------------


def _batch(seed, n=N):
    ds = SyntheticDataset(size=B, nb_points=n, noise=0.01, seed=seed,
                          n_objects=3)
    return collate([ds[i] for i in range(B)])


@pytest.fixture(scope="module")
def jax_train():
    batch = _batch(0)
    init = JRaft(JConfig(use_pallas=False, **TINY)).init
    params = jax.jit(init, static_argnums=3)(
        jax.random.key(0), jnp.asarray(batch["pc1"]),
        jnp.asarray(batch["pc2"]), 1)
    sched = ("cosine", LR, 1, 4, 4)          # the lr moves every step
    tx = optax.adam(jschedule(*sched))
    jstep = jmake_train_step(JRaft(JConfig(use_pallas=False, **TINY)), tx,
                             GAMMA, ITERS, donate=False)
    return params, tx, jstep, make_lr_schedule(*sched)


def _port(params, opt_state=None):
    model = TRaft(tconfig.ModelConfig(**TINY))
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(LR),
                           betas=(0.9, 0.999), eps=1e-8)
    if opt_state is not None:
        opt.load_state_dict(opt_state_from_jax(opt_state, model, opt))
    return model, opt


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("resume", [False, True])
def test_graphed_train_step_equals_eager_and_jax(jax_train, resume):
    params, tx, jstep, schedule = jax_train
    jp, js = params, tx.init(params)
    if resume:                  # one JAX step first: optax count 1
        jp, js, _ = jstep(jp, js, _jbatch(_batch(9)))
    state = js if resume else None
    graphed_model, graphed_opt = _port(jp, state)
    eager_model, eager_opt = _port(jp, state)
    assert isinstance(graphed_opt.param_groups[0]["lr"], torch.Tensor)
    graphed = make_graphed_train_step(graphed_model, graphed_opt, schedule,
                                      GAMMA, ITERS, CPU)
    eager = make_train_step(eager_model, eager_opt, schedule, GAMMA, ITERS)
    start = int(resume)
    for i in range(3):
        b = _batch(1 + i)
        g = graphed(to_device(b, CPU))
        e = eager(to_device(b, CPU))
        assert torch.equal(g["loss"], e["loss"])
        assert torch.equal(g["epe"], e["epe"])
        assert float(graphed_opt.param_groups[0]["lr"]) == np.float32(
            schedule(start + i))
        if i < 2:
            jp, js, jm = jstep(jp, js, _jbatch(b))
            assert abs(float(g["loss"]) - float(jm["loss"])) <= 1e-4
            assert abs(float(g["epe"]) - float(jm["epe"])) <= 1e-4
        if i == 1:
            want = params_from_jax(jp)
            worst = max(float((p.detach() - want[n]).abs().max())
                        for n, p in graphed_model.named_parameters())
            assert worst <= 2 * LR
    for (n, p), q in zip(graphed_model.named_parameters(),
                         eager_model.parameters()):
        assert torch.equal(p, q), n
    assert optimizer_steps(graphed_opt) == optimizer_steps(eager_opt) \
        == start + 3
    assert len(graphed.graphs.programs) == 1


def _tiny_cfg(epochs=1, size=6, exp_path="experiments/default", **train):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=N,
                                synthetic_size=size),
        train=tconfig.TrainConfig(num_epochs=epochs, iters=ITERS,
                                  eval_iters=ITERS, **train),
        exp_path=str(exp_path))


def test_trainer_keeps_every_steps_loss(tmp_path):
    weights = seeded_state_dict(tconfig.ModelConfig(**TINY), 3)
    graphed = ttrainer.Trainer(_tiny_cfg(exp_path=tmp_path / "g"),
                               device="cpu", weights=weights)
    eager = ttrainer.Trainer(_tiny_cfg(exp_path=tmp_path / "e"), device="cpu",
                             weights=weights, graphs=False, capturable=True)
    assert isinstance(eager.optimizer.param_groups[0]["lr"], torch.Tensor)
    plain = ttrainer.Trainer(_tiny_cfg(), device="cpu", weights=weights,
                             graphs=False)
    assert isinstance(plain.optimizer.param_groups[0]["lr"], float)
    assert [r["name"].split("[")[0] for r in graphed.compile_report()] == [
        "train_step", "eval_step"]
    assert eager.compile_report() == []
    got, want = graphed.training(0), eager.training(0)
    assert got["steps"] == want["steps"] == 3
    assert got["losses"] == want["losses"]
    assert len(set(got["losses"])) == 3
    assert got["epe"] == want["epe"]
    assert graphed.val_test(0) == eager.val_test(0)


def test_fit_tests_the_best_validation_epoch(monkeypatch, tmp_path):
    cfg = _tiny_cfg(epochs=2, size=4, exp_path=tmp_path / "fit")
    weights = seeded_state_dict(cfg.model, 4)
    trainer = ttrainer.Trainer(cfg, device="cpu", weights=weights)
    step = trainer.eval_step
    worse = [False]

    def eval_step(batch):
        out, flow = step(batch)
        if worse[0]:
            out = {**out, "epe3d": out["epe3d"] + 100.0}
        return out, flow

    monkeypatch.setattr(trainer, "eval_step", eval_step)
    kept = {}

    def report(epoch, train, val):
        kept[epoch] = {k: v.clone() for k, v in
                       trainer.model.state_dict().items()}
        # Epoch 1's validation reads worse, so epoch 0 stays the best.
        worse[0] = epoch == 0

    test = trainer.fit(report)
    assert trainer.best_epe < 100.0
    # The test pass read epoch 0's weights back from best_checkpoint; runs
    # without a checkpoint of their own test the weights they hold.
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(t, kept[0][name]), name
    probe = ttrainer.Trainer(cfg.replace(exp_path=str(tmp_path / "probe")),
                             device="cpu", weights=kept[0])
    assert test == probe.val_test(1, "test")
    last = ttrainer.Trainer(cfg.replace(exp_path=str(tmp_path / "last")),
                            device="cpu", weights=kept[1])
    assert test != last.val_test(1, "test")


def test_strict_retrace_raises_on_a_new_shape(tmp_path):
    model = TRaft(tconfig.ModelConfig(**TINY))
    model.load_state_dict(seeded_state_dict(tconfig.ModelConfig(**TINY), 0))
    first, second = _batch(0), _batch(1, n=40)
    for strict in (False, True):
        step = make_graphed_eval_step(model, ITERS, GAMMA, CPU,
                                      strict_retrace=strict)
        out, _ = step(to_device(first, CPU))
        want, _ = make_eval_step(model, ITERS, GAMMA)(to_device(first, CPU))
        assert all(torch.equal(out[k], want[k]) for k in want)
        if strict:
            with pytest.raises(RetraceError, match="not captured"):
                step(to_device(second, CPU))
            assert len(step.graphs.report()) == 1
        else:
            step(to_device(second, CPU))
            assert len(step.graphs.report()) == 2
            assert step.graphs.retraces == ["float32[2,40,3], float32[2,40,3],"
                                            " float32[2,40], float32[2,40,3]"]
    trainer = ttrainer.Trainer(_tiny_cfg(size=4, strict_retrace=True,
                                         exp_path=tmp_path),
                               device="cpu")
    trainer.training(0)
    small = to_device(first_batch(PrefetchLoader(
        trainer.train_ds, 1, num_workers=0)), CPU)
    with pytest.raises(RetraceError):
        trainer.train_step(small)


def test_scan_unroll_changes_no_flow():
    rng = np.random.default_rng(5)
    x1, x2 = _cloud(rng, N)[None], _cloud(rng, N)[None]
    jflows = {}
    for unroll in (1, 2):
        jm = JRaft(JConfig(use_pallas=False, scan_unroll=unroll, **TINY))
        if unroll == 1:
            params = jax.jit(jm.init, static_argnums=3)(
                jax.random.key(2), jnp.asarray(x1), jnp.asarray(x2), 1)
        jflows[unroll], _ = jax.jit(jm.apply, static_argnums=3)(
            params, jnp.asarray(x1), jnp.asarray(x2), 3)
    np.testing.assert_allclose(np.asarray(jflows[2]), np.asarray(jflows[1]),
                               rtol=0, atol=1e-6)
    tflows = {}
    for unroll in (1, 2):
        model = TRaft(tconfig.ModelConfig(scan_unroll=unroll, **TINY))
        model.load_state_dict(params_from_jax(params), strict=True)
        with torch.no_grad():
            tflows[unroll], _ = model(torch.from_numpy(x1),
                                      torch.from_numpy(x2), 3)
    assert torch.equal(tflows[1], tflows[2])
    np.testing.assert_allclose(tflows[2].numpy(), np.asarray(jflows[2]),
                               rtol=0, atol=2e-4)


def test_first_difference_names_the_submodule_that_parts():
    """``first_difference`` runs the model's own forward: None where the
    program and the eager run agree, else the first submodule call whose
    output moved (here: the flow encoder of the second GRU iteration, in
    the eager run only)."""
    cfg = tconfig.ModelConfig(**TINY)
    model = TRaft(cfg)
    model.load_state_dict(seeded_state_dict(cfg, 0))
    rng = np.random.default_rng(7)
    x = [torch.from_numpy(_cloud(rng, N)[None]) for _ in range(2)]
    runs, calls = [0], [0]

    def fn(a, b):
        runs[0] += 1
        calls[0] = 0
        return model(a, b, ITERS)

    assert first_difference(model, fn, x, CPU) is None

    def bump(_m, _args, out):
        calls[0] += 1
        return out + 1e-3 if runs[0] == 4 and calls[0] == 2 else out

    name = "update_iter.update_block.motion_encoder.conv_flow"
    handle = model.get_submodule(name).register_forward_hook(bump)
    try:
        got = first_difference(model, fn, x, CPU)
    finally:
        handle.remove()
    assert got["module"] == name and got["call"] == 1
    assert got["max_abs_diff"] == pytest.approx(1e-3, rel=1e-3)


@pytest.mark.parametrize("flags,entry", [
    (["--refine", "--seq_parallel=2"], "ROADMAP queue 1 item 8c"),
    (["--refine", "--seq_parallel", "4"], "ROADMAP queue 1 item 8c"),
    (["--scatter_free_vjp"], "ROADMAP queue 1 item 7"),
])
def test_later_levers_name_their_roadmap_entry(flags, entry, capsys):
    """Stage 2 on a sequence axis (item 8c) and the scatter-free VJP
    (item 7) name their ROADMAP entries; stage 1 takes
    ``--seq_parallel``."""
    with pytest.raises(SystemExit):
        tcli.parse_args(["--dataset", "synthetic", *flags])
    assert entry in capsys.readouterr().err
    if "--refine" in flags:
        cfg = tcli.config_from_args(tcli.parse_args(
            ["--dataset", "synthetic", *flags[1:]]))
        assert cfg.model.seq_shard and cfg.parallel.seq_axis > 1


@pytest.mark.parametrize("flags,field,want", [
    (["--packed_state"], "parallel.packed_state", True),
    (["--packed_state", "--steps_per_dispatch", "3"],
     "parallel.steps_per_dispatch", 3),
    (["--packed_state", "--host_roundtrip"], "parallel.host_roundtrip", True),
    (["--device_prefetch", "1"], "parallel.device_prefetch", 1),
    (["--corr_chunk", "64"], "model.corr_chunk", 64),
    (["--graph_chunk", "64"], "model.graph_chunk", 64),
    (["--approx_topk"], "model.approx_topk", True),
    (["--approx_knn"], "model.approx_knn", True),
    (["--remat"], "model.remat", True),
    (["--remat_policy", "save_corr"], "model.remat_policy", "save_corr"),
])
def test_cli_takes_the_k_step_and_model_levers(flags, field, want):
    """The ten flags of the K-step levers and the model levers parse as
    the root ``train.py`` parses them, into the fields the JAX package's
    config holds them in."""
    cfg = tcli.config_from_args(tcli.parse_args(["--dataset", "synthetic",
                                                 *flags]))
    part, name = field.split(".")
    assert getattr(getattr(cfg, part), name) == want


def test_cli_refuses_what_the_parallel_config_refuses(capsys):
    """The JAX ``ParallelConfig`` errors reach the CLI's config."""
    with pytest.raises(ValueError, match="requires packed_state"):
        tcli.config_from_args(tcli.parse_args(
            ["--dataset", "synthetic", "--steps_per_dispatch", "2"]))
    with pytest.raises(ValueError, match="host_roundtrip"):
        tcli.config_from_args(tcli.parse_args(
            ["--dataset", "synthetic", "--packed_state",
             "--steps_per_dispatch", "2", "--host_roundtrip"]))


def test_cli_accepts_the_graph_knobs(capsys):
    a = tcli.parse_args(["--dataset", "synthetic", "--strict_retrace"])
    assert tcli.config_from_args(a).train.strict_retrace
    # scan_unroll changes nothing in the port: the config takes it (configs
    # shared with the JAX package), the CLI refuses it and says why.
    assert tconfig.ModelConfig(scan_unroll=4).scan_unroll == 4
    with pytest.raises(SystemExit):
        tcli.parse_args(["--dataset", "synthetic", "--scan_unroll", "4"])
    assert "captured graph holds the GRU iterations" in \
        capsys.readouterr().err
    # eval_scan arrived with the evaluator (ROADMAP queue 1 item 2).
    assert tconfig.TrainConfig(eval_scan=2).eval_scan == 2


@pytest.mark.parametrize("kw", [{"resolution": 2},
                                {"corr_knn": 40, "truncate_k": 48}])
def test_plain_path_runs_what_the_kernels_do_not_take(kw):
    """The configurations the kernels do not take, which run on the card
    with ``use_pallas=False``: flows against the JAX package's at the
    model bar (2e-4),
    and the voxel means and their gradient at an even resolution against
    the JAX package's default (XLA) path."""
    from pvraft_tpu.ops.voxel import voxel_bin_means as jvoxel
    from pvraft_tpu_torch.ops.voxel import voxel_bin_means, voxel_bwd

    cfg = {**TINY, **kw}
    rng = np.random.default_rng(6)
    x1, x2 = _cloud(rng, N)[None], _cloud(rng, N)[None]
    jm = JRaft(JConfig(use_pallas=False, **cfg))
    params = jax.jit(jm.init, static_argnums=3)(
        jax.random.key(3), jnp.asarray(x1), jnp.asarray(x2), 1)
    want, _ = jax.jit(jm.apply, static_argnums=3)(
        params, jnp.asarray(x1), jnp.asarray(x2), 2)
    model = TRaft(tconfig.ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x1), torch.from_numpy(x2), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    res = cfg["resolution"] if "resolution" in cfg else 3
    corr = rng.normal(size=(2, 30, 40)).astype(np.float32)
    rel = rng.normal(0, 0.5, (2, 30, 40, 3)).astype(np.float32)
    g = rng.normal(size=(2, 30, 3 * res**3)).astype(np.float32)
    out, vjp = jax.vjp(lambda c: jvoxel(c, jnp.asarray(rel), 3, 0.25, res),
                       jnp.asarray(corr))
    tc, tr = torch.from_numpy(corr), torch.from_numpy(rel)
    np.testing.assert_allclose(voxel_bin_means(tc, tr, 3, 0.25, res).numpy(),
                               np.asarray(out), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        voxel_bwd(tc, tr, torch.from_numpy(g), 3, 0.25, res).numpy(),
        np.asarray(vjp(jnp.asarray(g))[0]), rtol=0, atol=1e-6)
