"""Per-stage train-step profiler (port of
``pvraft_tpu/profiling/step_profiler.py``).

Times a ladder of cumulative programs of the flagship train step, each
synced by a host fetch of a scalar that depends on the program's output
and fed freshly perturbed inputs at every call, so nothing can serve a
cached result:

    encoder    the PointEncoder on ONE cloud (kNN graph + 3 SetConvs)
    corr_cum   both clouds encoded + the truncated correlation
    fwd1/fwdN  the model's forward at 1 / N GRU iterations
    gru_fused  fwdN with ``ModelConfig.fused_gru=True`` (on the card the
               fused MotionEncoder+ConvGRU kernel): the kernel's A/B
               against fwdN, not part of the breakdown
    fwdbwd     the sequence loss and its gradients (no optimizer)
    step       the Trainer's whole train step (forward, backward, Adam)

On the card each rung is one captured CUDA graph
(``serve/aot.py::capture``), so a rung times the device and not the
eager host; on the CPU the same functions run eagerly. Their differences
telescope into the breakdown, whose sum is the measured step:

    encoder     = 2 x encoder
    corr_init   = corr_cum - 2 x encoder
    gru_forward = fwdN - corr_cum     (the GRU loop, the context encoder
                                       and the heads)
    backward    = fwdbwd - fwdN
    optimizer   = step - fwdbwd

:func:`validate_step_profile` checks the ``pvraft_step_profile/v1``
record (the telescoped sum, and derived stages negative beyond timing
noise); ``obs/trace.py::trace_from_step_profile`` lays the breakdown out
as ``train_step`` spans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

SCHEMA_VERSION = "pvraft_step_profile/v1"

# The cumulative host-synced programs, in ladder order.
MEASUREMENTS = ("encoder", "corr_cum", "fwd1", "fwdN", "gru_fused",
                "fwdbwd", "step")

# The derived per-stage breakdown; it telescopes to the "step" rung.
BREAKDOWN_STAGES = ("encoder", "corr_init", "gru_forward", "backward",
                    "optimizer")


def derive_breakdown(measurements: Dict[str, dict]) -> Dict[str, float]:
    """Telescoped per-stage seconds from the cumulative measurements."""
    sec = {k: measurements[k]["sec"] for k in MEASUREMENTS}
    return {
        "encoder": round(2 * sec["encoder"], 6),
        "corr_init": round(sec["corr_cum"] - 2 * sec["encoder"], 6),
        "gru_forward": round(sec["fwdN"] - sec["corr_cum"], 6),
        "backward": round(sec["fwdbwd"] - sec["fwdN"], 6),
        "optimizer": round(sec["step"] - sec["fwdbwd"], 6),
    }


def validate_step_profile(record: dict, rel_tol: float = 0.02) -> List[str]:
    """Schema problems of a step-profile record ([] = valid): the keys,
    every rung measured, and the breakdown summing to the measured step
    within ``rel_tol``, no derived stage negative beyond it."""
    problems: List[str] = []
    for key in ("schema", "platform", "variant", "points", "batch", "iters",
                "truncate_k", "host_synced", "measurements", "breakdown_s",
                "total_step_s"):
        if key not in record:
            problems.append(f"missing key {key!r}")
    if problems:
        return problems
    if record["schema"] != SCHEMA_VERSION:
        problems.append(
            f"schema {record['schema']!r} != {SCHEMA_VERSION!r}")
    if record["host_synced"] is not True:
        problems.append("host_synced must be true (non-synced timings are "
                        "dispatch rates, not device work)")
    for name in MEASUREMENTS:
        entry = record["measurements"].get(name)
        if entry is None:
            problems.append(f"missing measurement {name!r}")
        elif "sec" not in entry:
            problems.append(
                f"measurement {name!r} has no 'sec' "
                f"({entry.get('error', 'no error recorded')})")
        elif not entry["sec"] > 0:
            problems.append(f"measurement {name!r} sec={entry['sec']} <= 0")
    bd = record["breakdown_s"]
    if set(bd) != set(BREAKDOWN_STAGES):
        problems.append(
            f"breakdown stages {sorted(bd)} != {sorted(BREAKDOWN_STAGES)}")
    if problems:
        return problems
    total = record["total_step_s"]
    sum_bd = sum(bd.values())
    if abs(sum_bd - total) > max(rel_tol * abs(total), 1e-4):
        problems.append(
            f"breakdown sums to {sum_bd:.6f}s but total_step_s is "
            f"{total:.6f}s (|diff| > {rel_tol:.0%})")
    negatives = [k for k, v in bd.items()
                 if v < -max(rel_tol * abs(total), 1e-4)]
    if negatives:
        problems.append(
            f"negative derived stages {negatives} (timing noise larger "
            "than the stage; increase reps)")
    return problems


def ladder_programs(cfg, state, pc1, pc2, mask, gt, iters: int,
                    gamma: float = 0.8, lr: float = 1e-3,
                    grad_dtype: Optional[str] = None
                    ) -> List[Tuple[str, Callable]]:
    """The ladder as ``(name, fn)`` pairs in :data:`MEASUREMENTS` order,
    on ``pc1``'s device: ``fn(eps)`` perturbs the clouds by the 0-d
    tensor ``eps`` and returns a 0-d tensor whose host fetch is the sync.
    ``state`` is the PVRaft state_dict every rung runs with; the fused
    rung's model has the same weights (``fused_gru`` changes no
    parameter). The step rung is the Trainer's train step
    (``engine/steps.py``) with Adam (capturable on the card) at ``lr``,
    on a model of its own."""
    import torch

    from pvraft_tpu_torch.engine.loss import sequence_loss
    from pvraft_tpu_torch.engine.steps import (
        _stage1_loss,
        _train_body,
        init_adam_state,
    )
    from pvraft_tpu_torch.models.raft import PVRaft
    from pvraft_tpu_torch.ops.corr import corr_init

    device = pc1.device

    def build(**kw):
        model = PVRaft(dataclasses.replace(cfg, **kw))
        model.load_state_dict(state, strict=True)
        return model.to(device)

    model = build()
    fused = build(fused_gru=True)
    enc = model.feature_extractor
    params = list(model.parameters())

    def f_encoder(eps):
        with torch.no_grad():
            fmap, _ = enc(pc1 + eps)
            return fmap.float().sum()

    def f_corr_cum(eps):
        with torch.no_grad():
            fmap1, _ = enc(pc1 + eps)
            fmap2, _ = enc(pc2 + eps)
            st = corr_init(fmap1, fmap2, pc2 + eps, cfg.truncate_k,
                           cfg.corr_chunk, cfg.approx_topk)
            return st.corr.float().sum()

    def forward(net, n_iters):
        def f(eps):
            with torch.no_grad():
                flows, _ = net(pc1 + eps, pc2 + eps, n_iters)
                return flows[-1].float().sum()
        return f

    def f_fwdbwd(eps):
        flows, _ = model(pc1 + eps, pc2 + eps, iters)
        loss = sequence_loss(flows, mask, gt, gamma)
        grads = torch.autograd.grad(loss, params)
        gnorm = torch.stack(torch._foreach_norm(list(grads))).sum()
        return loss.detach() + 0.0 * gnorm

    stepper = build()
    optimizer = torch.optim.Adam(
        stepper.parameters(), lr=torch.tensor(lr, device=device),
        betas=(0.9, 0.999), eps=1e-8, capturable=device.type == "cuda")
    init_adam_state(optimizer)
    body = _train_body(optimizer, _stage1_loss(stepper, gamma, iters),
                       grad_dtype)

    def f_step(eps):
        return body(pc1 + eps, pc2 + eps, mask, gt)[0]

    f_step.preserve = list(stepper.parameters()) + [
        t for s in optimizer.state.values() for t in s.values()
        if torch.is_tensor(t)]
    builders = {
        "encoder": f_encoder,
        "corr_cum": f_corr_cum,
        "fwd1": forward(model, 1),
        "fwdN": forward(model, iters),
        "gru_fused": forward(fused, iters),
        "fwdbwd": f_fwdbwd,
        "step": f_step,
    }
    return [(name, builders[name]) for name in MEASUREMENTS]


def profile_step(cfg, points: int = 8192, batch: int = 2, iters: int = 8,
                 reps: int = 2, gamma: float = 0.8, lr: float = 1e-3,
                 grad_dtype: Optional[str] = None, variant: str = "custom",
                 device=None, seed: int = 0,
                 log: Optional[Callable[[str], None]] = None) -> dict:
    """Profile the train step of ``cfg`` (a ``ModelConfig``) stage by
    stage on ``device`` (default: the card; raises without one) and
    return the ``pvraft_step_profile/v1`` record. Clouds of ``points``
    points uniform in [-1, 1], ground truth ``pc2 - pc1``, seeded weights
    (``seed``). Each rung: captured (on the card), one first call, then
    ``reps`` timed calls; ``sec`` is their minimum."""
    import numpy as np
    import torch

    from pvraft_tpu_torch.device import resolve_device
    from pvraft_tpu_torch.rng import host_rng, torch_seed
    from pvraft_tpu_torch.serve.aot import capture
    from pvraft_tpu_torch.weights import seeded_state_dict

    say = log or (lambda msg: None)
    device = resolve_device(device)
    rng = host_rng(seed, "profile.data")
    pc1, pc2 = (torch.from_numpy(rng.uniform(
        -1, 1, (batch, points, 3)).astype(np.float32)).to(device)
        for _ in range(2))
    mask = torch.ones(batch, points, device=device)
    gt = pc2 - pc1
    state = seeded_state_dict(cfg, torch_seed(seed, "model.init"))
    programs = ladder_programs(cfg, state, pc1, pc2, mask, gt, iters,
                               gamma=gamma, lr=lr, grad_dtype=grad_dtype)
    on_card = device.type == "cuda"
    record = {
        "schema": SCHEMA_VERSION,
        "platform": "gpu" if on_card else "cpu",
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "variant": variant,
        "points": points, "batch": batch, "iters": iters,
        "truncate_k": cfg.truncate_k,
        "host_synced": True,
        "graphed": on_card,
        "config": {
            "compute_dtype": cfg.compute_dtype,
            "use_pallas": cfg.use_pallas,
            "approx_topk": cfg.approx_topk,
            "approx_knn": cfg.approx_knn,
            "scatter_free_vjp": cfg.scatter_free_vjp,
            "remat": cfg.remat,
            "remat_policy": cfg.remat_policy,
            "grad_dtype": grad_dtype or "float32",
        },
        "measurements": {},
    }
    eps = [0.0]

    def fresh_eps():
        eps[0] += 1e-6
        return torch.tensor(eps[0], dtype=torch.float32)

    for name, fn in programs:
        entry: dict = {}
        try:
            t0 = time.perf_counter()
            program = capture(
                f"profile.{name}", lambda e, fn=fn: (fn(e),),
                [fresh_eps()], device, preserve=getattr(fn, "preserve", ()))
            entry["capture_s"] = round(time.perf_counter() - t0, 3)
            entry["launches"] = program.launches
            t0 = time.perf_counter()
            float(program(fresh_eps())[0])   # the host fetch is the sync
            entry["first_call_s"] = round(time.perf_counter() - t0, 4)
            dts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                float(program(fresh_eps())[0])
                dts.append(time.perf_counter() - t0)
            entry["sec_reps"] = [round(d, 6) for d in dts]
            entry["sec"] = round(min(dts), 6)
            del program
        except Exception as e:  # noqa: BLE001 — the other rungs still run
            entry["error"] = repr(e)[:300]
        record["measurements"][name] = entry
        say(f"[step_profile] {name}: {entry}")
    meas = record["measurements"]
    if all("sec" in meas.get(k, {}) for k in MEASUREMENTS):
        record["breakdown_s"] = derive_breakdown(meas)
        record["total_step_s"] = meas["step"]["sec"]
        if iters > 1:
            record["per_iter_s"] = round(
                (meas["fwdN"]["sec"] - meas["fwd1"]["sec"]) / (iters - 1), 6)
    return record
