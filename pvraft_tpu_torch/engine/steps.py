"""Train and eval steps (port of ``pvraft_tpu/engine/steps.py``).

The train step is the reference's zero_grad / forward / sequence loss /
backward / Adam step, with the learning rate of the schedule at the
optimizer's step count set before the step (optax's order).
:func:`make_train_step` and :func:`make_eval_step` run eagerly: the CPU
path, and the yardstick on the card. :func:`make_graphed_train_step` and
:func:`make_graphed_eval_step` are the same steps captured as one CUDA
graph per input signature (``serve/aot.py``, ``obs/retrace.py``), the
counterpart of the JAX package's ``jax.jit`` steps: the train graph holds
forward, sequence loss, backward and the Adam update
(``torch.optim.Adam(capturable=True)`` with the learning rate in a device
tensor, filled from the schedule before each replay at a step count kept
on the host). The JAX package's K-step dispatch levers (packed state,
steps per dispatch, host round trip) are not ported yet (ROADMAP queue 1
item 1).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from pvraft_tpu_torch.engine.loss import sequence_loss
from pvraft_tpu_torch.engine.metrics import epe_train, flow_metrics
from pvraft_tpu_torch.obs.retrace import GraphCache
from pvraft_tpu_torch.serve.aot import capture

Batch = Dict[str, torch.Tensor]
BATCH_KEYS = ("pc1", "pc2", "mask", "flow")
EVAL_KEYS = ("loss", "epe3d", "acc3d_strict", "acc3d_relax", "outlier")


def sequence_loss_of(model, batch: Batch, gamma: float, num_iters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train step's loss: (sequence loss, flows (T, B, N, 3))."""
    flows, _ = model(batch["pc1"], batch["pc2"], num_iters)
    return sequence_loss(flows, batch["mask"], batch["flow"], gamma), flows


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken (Adam's per-parameter ``step``, which
    :func:`~pvraft_tpu_torch.weights.opt_state_from_jax` carries over from
    optax's count). Reads a device tensor under ``capturable``: a sync."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate to ``lr``: in place where it is a
    tensor (a captured step reads that tensor), else by assignment."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def scheduled_step(optimizer: torch.optim.Optimizer,
                   schedule: Callable[[int], float]) -> None:
    """One optimizer step at ``schedule(steps taken so far)``: optax's
    order, where step 0 takes lr(0)."""
    set_lr(optimizer, schedule(optimizer_steps(optimizer)))
    optimizer.step()


def init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Create Adam's per-parameter state where it is missing, as its first
    step would (step 0, on the parameter's device under ``capturable``;
    zero moments), so that a capture finds it in place."""
    for group in optimizer.param_groups:
        on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            state["step"] = torch.zeros(
                (), dtype=torch.float32,
                device=p.device if on_device else torch.device("cpu"))
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)


def _check_levers(grad_dtype: Optional[str], telemetry: bool) -> None:
    if grad_dtype not in (None, "float32", "f32"):
        raise NotImplementedError(
            f"grad_dtype={grad_dtype!r} is not ported yet: it arrives with "
            f"the bf16 slice")
    if telemetry:
        raise NotImplementedError(
            "telemetry is not ported yet: it arrives with the observability "
            "slice")


def _train_body(model, optimizer, gamma: float, num_iters: int
                ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """zero_grad / forward / loss / backward / step at the optimizer's
    current learning rate; returns (loss, epe) of the last flow."""

    def body(pc1, pc2, mask, flow):
        batch = {"pc1": pc1, "pc2": pc2, "mask": mask, "flow": flow}
        optimizer.zero_grad(set_to_none=True)
        loss, flows = sequence_loss_of(model, batch, gamma, num_iters)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            epe = epe_train(flows[-1], mask, flow)
        return loss.detach(), epe

    return body


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], gamma: float,
                    num_iters: int, grad_dtype: Optional[str] = None,
                    telemetry: bool = False) -> Callable[[Batch], Batch]:
    """Stage-1 training step: ``step(batch) -> {"loss", "epe"}`` (detached
    tensors on the batch's device). After it, each parameter's ``.grad``
    holds this step's gradient. The step count is read from the optimizer
    once, here, and kept on the host (under ``capturable`` the optimizer's
    own count is a device tensor)."""
    _check_levers(grad_dtype, telemetry)
    body = _train_body(model, optimizer, gamma, num_iters)
    count = [optimizer_steps(optimizer)]

    def train_step(batch: Batch) -> Batch:
        set_lr(optimizer, schedule(count[0]))
        loss, epe = body(*(batch[k] for k in BATCH_KEYS))
        count[0] += 1
        return {"loss": loss, "epe": epe}

    return train_step


def make_graphed_train_step(model, optimizer: torch.optim.Adam,
                            schedule: Callable[[int], float], gamma: float,
                            num_iters: int, device: torch.device,
                            strict_retrace: bool = False,
                            grad_dtype: Optional[str] = None,
                            telemetry: bool = False
                            ) -> Callable[[Batch], Batch]:
    """:func:`make_train_step` as one captured program per input
    signature. Every group's ``lr`` must be a tensor (on ``device``, with
    ``capturable=True``, on the card). Returns ``step(batch) -> {"loss",
    "epe"}``: static tensors that the next step overwrites. ``step.graphs``
    is its :class:`GraphCache` (``step.graphs.program_for(inputs)``
    captures without running a step; ``step.graphs.report()``). The step
    count is read from the optimizer once, here."""
    _check_levers(grad_dtype, telemetry)
    lrs = [g["lr"] for g in optimizer.param_groups]
    if not all(torch.is_tensor(lr) for lr in lrs):
        raise ValueError("a graphed train step needs every lr as a tensor")
    init_adam_state(optimizer)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = params + [t for s in optimizer.state.values()
                      for t in s.values() if torch.is_tensor(t)]
    body = _train_body(model, optimizer, gamma, num_iters)
    count = [optimizer_steps(optimizer)]

    # The body sets every .grad to None before its backward, so the
    # captured backward writes fresh gradient buffers of the graph's own
    # pool at every replay (PyTorch's whole-network capture recipe).
    graphs = GraphCache(
        "train_step",
        lambda name, inputs: capture(name, body, inputs, device,
                                     preserve=state),
        strict_retrace)

    def train_step(batch: Batch) -> Batch:
        inputs = [batch[k] for k in BATCH_KEYS]
        program = graphs.program_for(inputs)
        lr = schedule(count[0])
        for t in lrs:
            t.fill_(lr)
        loss, epe = program(*inputs)
        count[0] += 1
        return {"loss": loss, "epe": epe}

    train_step.graphs = graphs
    return train_step


def make_eval_step(model, num_iters: int, gamma: float,
                   per_scene: bool = False
                   ) -> Callable[[Batch], Tuple[Batch, torch.Tensor]]:
    """``step(batch) -> (metrics, flow)``: the sequence loss and
    :func:`flow_metrics` of the last flow, as batch means or, with
    ``per_scene``, as (B,) tensors (one value per scene)."""

    def eval_step(batch: Batch) -> Tuple[Batch, torch.Tensor]:
        mask, gt = batch["mask"], batch["flow"]
        with torch.no_grad():
            flows, _ = model(batch["pc1"], batch["pc2"], num_iters)
            flow = flows[-1]
            if per_scene:
                scenes = [slice(b, b + 1) for b in range(flow.shape[0])]
                per = [{"loss": sequence_loss(flows[:, s], mask[s], gt[s],
                                              gamma),
                        **flow_metrics(flow[s], mask[s], gt[s])}
                       for s in scenes]
                out = {k: torch.stack([p[k] for p in per]) for k in per[0]}
            else:
                out = {"loss": sequence_loss(flows, mask, gt, gamma),
                       **flow_metrics(flow, mask, gt)}
        return out, flow

    return eval_step


def make_graphed_eval_step(model, num_iters: int, gamma: float,
                           device: torch.device, per_scene: bool = False,
                           strict_retrace: bool = False
                           ) -> Callable[[Batch], Tuple[Batch, torch.Tensor]]:
    """:func:`make_eval_step` as one captured program per input
    signature; returns static tensors that the next call overwrites.
    ``step.graphs`` is its :class:`GraphCache`."""
    eager = make_eval_step(model, num_iters, gamma, per_scene)

    def body(*inputs):
        out, flow = eager(dict(zip(BATCH_KEYS, inputs)))
        return (*(out[k] for k in EVAL_KEYS), flow)

    graphs = GraphCache(
        "eval_step", lambda name, inputs: capture(name, body, inputs, device),
        strict_retrace)

    def eval_step(batch: Batch) -> Tuple[Batch, torch.Tensor]:
        inputs = [batch[k] for k in BATCH_KEYS]
        *metrics, flow = graphs.program_for(inputs)(*inputs)
        return dict(zip(EVAL_KEYS, metrics)), flow

    eval_step.graphs = graphs
    return eval_step
