"""The port's monitored train steps against the JAX package's, on the CPU.

One telemetry step of each port factory (``engine/steps.py``: the
stage-1, refine, packed and K-step (K = 2) steps, each eager and graphed
on the CPU's static buffers) against the JAX step it ports
(``make_train_step``, ``make_refine_train_step``,
``make_packed_train_step``, ``make_multistep_train_step`` with
``telemetry=True``) from the same weights (the port's seeded ones,
through ``params_to_jax``), the same Adam and the same numpy batch: the
same leaf set and groups, every leaf within 1e-4 relative. The port's
``update_ratio`` is the furthest (~1e-5): its update is the parameters
after Adam's step less a copy from before it, each rounded to float32,
where optax hands over the update itself.
And with telemetry off, each factory's loss, EPE and parameters are
bitwise those of the step with telemetry on. The JAX compiles (one per
JAX step) are most of the time.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.engine import steps as jsteps
from pvraft_tpu.engine.trainer import _refine_mask
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.models import PVRaftRefine as JRefine
from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.engine import steps as tsteps
from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine
from pvraft_tpu_torch.obs.monitors import TELEMETRY_LEAVES
from pvraft_tpu_torch.weights import (
    params_to_jax,
    seeded_state_dict,
    trained_parameters,
)

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, GAMMA, LR, K = 2, 48, 2, 0.8, 1e-3, 2
FACTORIES = ("eager", "graphed", "refine", "refine_graphed", "packed_eager",
             "packed", "kstep_eager", "kstep")
# The JAX step each port factory is held against.
JAX_STEP = {"eager": "train", "graphed": "train", "refine": "refine",
            "refine_graphed": "refine", "packed_eager": "packed",
            "packed": "packed", "kstep_eager": "kstep", "kstep": "kstep"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(seed):
    rng = np.random.default_rng(seed)
    pc1 = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    flow = (0.1 * rng.normal(size=(B, N, 3))).astype(np.float32)
    return {"pc1": pc1, "pc2": pc1 + flow, "flow": flow,
            "mask": np.ones((B, N), np.float32)}


BATCHES = [_batch(11), _batch(12)]


def _port(kind, telemetry):
    """(step output, the model's parameters after it) of one port step of
    ``kind`` from the seeded weights."""
    refine = JAX_STEP[kind] == "refine"
    cfg = ModelConfig(**TINY)
    model = (PVRaftRefine if refine else PVRaft)(cfg)
    model.load_state_dict(seeded_state_dict(cfg, 5, refine))
    graphed = kind in ("graphed", "refine_graphed", "packed", "kstep")
    lr = torch.tensor(LR) if graphed else LR
    optimizer = torch.optim.Adam([p for _, p in trained_parameters(model)],
                                 lr=lr, betas=(0.9, 0.999), eps=1e-8)
    schedule = lambda _: LR  # noqa: E731 — optax.adam(LR)'s constant
    cpu = torch.device("cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in BATCHES]
    if kind == "eager":
        out = tsteps.make_train_step(model, optimizer, schedule, GAMMA,
                                     ITERS, telemetry=telemetry)(batches[0])
    elif kind == "graphed":
        out = tsteps.make_graphed_train_step(
            model, optimizer, schedule, GAMMA, ITERS, cpu,
            telemetry=telemetry)(batches[0])
    elif kind == "refine":
        out = tsteps.make_refine_train_step(
            model, optimizer, schedule, ITERS, telemetry=telemetry)(
                batches[0])
    elif kind == "refine_graphed":
        out = tsteps.make_graphed_refine_train_step(
            model, optimizer, schedule, ITERS, cpu, telemetry=telemetry)(
                batches[0])
    elif kind == "packed_eager":
        step, _, _ = tsteps.make_packed_train_step(
            model, optimizer, schedule, GAMMA, ITERS, telemetry=telemetry)
        out = step(batches[0])
    elif kind == "packed":
        step, _, _ = tsteps.make_graphed_packed_train_step(
            model, optimizer, schedule, GAMMA, ITERS, cpu,
            telemetry=telemetry)
        out = step(batches[0])
    elif kind == "kstep_eager":
        step, _, _ = tsteps.make_multistep_train_step(
            model, optimizer, schedule, GAMMA, ITERS, K, telemetry=telemetry)
        out = step(tsteps.stack_batches(batches))
    else:
        step, _, _ = tsteps.make_graphed_multistep_train_step(
            model, optimizer, schedule, GAMMA, ITERS, K, cpu,
            telemetry=telemetry)
        out = step(tsteps.stack_batches(batches))
    return out, [p.detach().clone() for p in model.parameters()]


_JAX = {}


def _jax(kind):
    """The metrics of the JAX step ``kind`` ("train", "refine", "packed",
    "kstep"), from the port's weights."""
    if kind in _JAX:
        return _JAX[kind]
    refine = kind == "refine"
    state = seeded_state_dict(ModelConfig(**TINY), 5, refine)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(state))
    model = (JRefine if refine else JRaft)(JConfig(use_pallas=False, **TINY))
    tx = optax.adam(LR)
    if refine:
        tx = optax.masked(tx, _refine_mask(params))
    opt = tx.init(params)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in BATCHES]
    if kind == "train":
        _, _, m = jsteps.make_train_step(model, tx, GAMMA, ITERS,
                                         donate=False, telemetry=True)(
            params, opt, batches[0])
    elif refine:
        _, _, m = jsteps.make_refine_train_step(
            model, tx, ITERS, donate=False, telemetry=True)(
                params, opt, batches[0])
    elif kind == "packed":
        step, flat, _ = jsteps.make_packed_train_step(
            model, tx, GAMMA, ITERS, params, opt, donate=False,
            telemetry=True)
        _, m = step(flat, batches[0])
    else:
        step, flat, _ = jsteps.make_multistep_train_step(
            model, tx, GAMMA, ITERS, params, opt, K, donate=False,
            telemetry=True)
        stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *batches)
        _, m = step(flat, stacked)
    _JAX[kind] = jax.tree_util.tree_map(np.asarray, m)
    return _JAX[kind]


RTOL = 1e-4


@pytest.mark.parametrize("kind", FACTORIES)
def test_telemetry_step_matches_jax(kind):
    got, _ = _port(kind, telemetry=True)
    want = _jax(JAX_STEP[kind])
    tel, jtel = got["telemetry"], want["telemetry"]
    # JAX's dicts come back key-sorted (pytree order): compare sets.
    assert set(tel) == set(jtel) and set(tel) <= set(TELEMETRY_LEAVES)
    assert ("delta_flow_norm" in tel) == (JAX_STEP[kind] == "train")
    assert sorted(tel["grad_norm_by_group"]) == sorted(
        jtel["grad_norm_by_group"])
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=1e-5)
    for key in ("grad_norm", "param_norm", "update_ratio"):
        np.testing.assert_allclose(tel[key].numpy(), jtel[key], rtol=RTOL)
    for group, jvalue in jtel["grad_norm_by_group"].items():
        value = tel["grad_norm_by_group"][group].numpy()
        if not np.any(jvalue):  # the refine backbone: zeros on both sides
            assert not np.any(value)
            continue
        np.testing.assert_allclose(value, jvalue, rtol=RTOL)
    if "delta_flow_norm" in jtel:
        np.testing.assert_allclose(tel["delta_flow_norm"].numpy(),
                                   jtel["delta_flow_norm"], rtol=RTOL)
    np.testing.assert_array_equal(tel["nonfinite"].numpy(),
                                  jtel["nonfinite"])


@pytest.mark.parametrize("kind", FACTORIES)
def test_telemetry_off_is_bitwise_the_monitored_step(kind):
    on, on_params = _port(kind, telemetry=True)
    off, off_params = _port(kind, telemetry=False)
    assert "telemetry" not in off
    assert torch.equal(on["loss"], off["loss"])
    assert torch.equal(on["epe"], off["epe"])
    assert all(torch.equal(a, b) for a, b in zip(on_params, off_params))
