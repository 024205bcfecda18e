"""Train and eval steps (port of ``pvraft_tpu/engine/steps.py``).

The train step is the reference's zero_grad / forward / sequence loss /
backward / Adam step, with the learning rate of the schedule at the
optimizer's step count set before the step (optax's order). It runs
eagerly; the JAX package's packed-state and multi-step dispatch levers
are remote-TPU-dispatch levers whose H100 counterpart is CUDA-graph
capture, a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from pvraft_tpu_torch.engine.loss import sequence_loss
from pvraft_tpu_torch.engine.metrics import epe_train, flow_metrics

Batch = Dict[str, torch.Tensor]


def sequence_loss_of(model, batch: Batch, gamma: float, num_iters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train step's loss: (sequence loss, flows (T, B, N, 3))."""
    flows, _ = model(batch["pc1"], batch["pc2"], num_iters)
    return sequence_loss(flows, batch["mask"], batch["flow"], gamma), flows


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken (Adam's per-parameter ``step``, which
    :func:`~pvraft_tpu_torch.weights.opt_state_from_jax` carries over from
    optax's count)."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def scheduled_step(optimizer: torch.optim.Optimizer,
                   schedule: Callable[[int], float]) -> None:
    """One optimizer step at ``schedule(steps taken so far)``: optax's
    order, where step 0 takes lr(0)."""
    lr = schedule(optimizer_steps(optimizer))
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], gamma: float,
                    num_iters: int, grad_dtype: Optional[str] = None,
                    telemetry: bool = False) -> Callable[[Batch], Batch]:
    """Stage-1 training step: ``step(batch) -> {"loss", "epe"}`` (detached
    tensors on the batch's device). After it, each parameter's ``.grad``
    holds this step's gradient."""
    if grad_dtype not in (None, "float32", "f32"):
        raise NotImplementedError(
            f"grad_dtype={grad_dtype!r} is not ported yet: it arrives with "
            f"the bf16 slice")
    if telemetry:
        raise NotImplementedError(
            "telemetry is not ported yet: it arrives with the observability "
            "slice")

    def train_step(batch: Batch) -> Batch:
        optimizer.zero_grad(set_to_none=True)
        loss, flows = sequence_loss_of(model, batch, gamma, num_iters)
        loss.backward()
        scheduled_step(optimizer, schedule)
        with torch.no_grad():
            epe = epe_train(flows[-1], batch["mask"], batch["flow"])
        return {"loss": loss.detach(), "epe": epe}

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
