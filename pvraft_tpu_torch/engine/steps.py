"""Train and eval steps (port of ``pvraft_tpu/engine/steps.py``).

The train step is the reference's zero_grad / forward / loss / backward /
Adam step, with the learning rate of the schedule at the optimizer's step
count set before the step (optax's order). Stage 1 trains on the sequence
loss of every iteration's flow; stage 2 (:func:`make_refine_train_step`,
a ``PVRaftRefine`` whose backbone runs without autograd and an Adam over
its head) on the masked L1 of the one refined flow.
:func:`make_train_step`, :func:`make_refine_train_step` and
:func:`make_eval_step` run eagerly: the CPU path, and the yardstick on
the card. The ``make_graphed_*`` steps are the same steps captured as
one CUDA graph per input signature (``serve/aot.py``,
``obs/retrace.py``), the counterpart of the JAX package's ``jax.jit``
steps: a train graph holds forward, loss, backward and the Adam update
(``torch.optim.Adam(capturable=True)`` with the learning rate in a device
tensor, filled from the schedule before each replay at a step count kept
on the host). ``grad_dtype="bfloat16"`` rounds every gradient to bf16 and
back right after the backward (:func:`maybe_cast_grads`), in the eager
and the graphed train steps of both stages; Adam's state stays float32.

The K-step levers (the JAX ``ParallelConfig``): :class:`PackedState`
makes every trained parameter and Adam's ``step``, ``exp_avg`` and
``exp_avg_sq`` views of one flat float32 buffer, which
:func:`make_packed_train_step` (and its graphed twin) run on, optionally
sending the buffer to pinned host memory and back before each step
(``host_roundtrip``); :func:`make_multistep_train_step` and its graphed
twin run K whole train steps on K stacked batches, the graphed one as one
CUDA graph whose learning rates come from one device tensor of K
entries, filled once before each replay. Both stages, as the JAX
``refine=True``. All of them are bitwise equal to as many single steps.

Data and sequence parallelism (``parallel/``): with a process group,
every train step factory's body (:func:`_train_body`) reduces the
gradients, the loss and the EPE over the group's ranks in one collective
(:class:`GradientAllReduce`) right after the backward, before the bf16
gradient cast, the monitors and Adam: the JAX order, where GSPMD's
gradients are global before either reads them. It runs at every world
size, 1 included. A sequence-parallel model (``PVRaft(cfg, mesh)`` with
``seq_shard``) holds this rank's rows of each scene: its loss and EPE
are this rank's share of the scene's (``engine/loss.py``), and the
reduction sums over the seq axis and averages over the data axis.

``telemetry=True`` (every train step factory) adds the in-step numerics
monitors (``obs/monitors.py``) as ``metrics["telemetry"]``, as the JAX
steps do: :class:`StepMonitor` copies the trained parameters just before
Adam's step (inside the capture; the packed steps copy the parameters'
slots of the flat buffer) and computes the leaves from the copy, the
gradients, the update (the parameters after the step less the copy) and
the flows, as static outputs of the graph; the K-step step's leaves
carry a leading axis of K. The stage-1 single steps carry
``delta_flow_norm``; the refine, packed and K-step steps do not (the JAX
steps' leaf sets). With ``telemetry=False`` nothing of it is built: the
step runs and launches what it did before.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pvraft_tpu_torch.engine.loss import compute_loss, sequence_loss
from pvraft_tpu_torch.engine.metrics import epe_train, flow_metrics
from pvraft_tpu_torch.obs import monitors
from pvraft_tpu_torch.obs.retrace import GraphCache
from pvraft_tpu_torch.parallel.collectives import group_size
from pvraft_tpu_torch.parallel.distributed import is_initialized
from pvraft_tpu_torch.serve.aot import capture
from pvraft_tpu_torch.weights import trained_parameters

Batch = Dict[str, torch.Tensor]
BATCH_KEYS = ("pc1", "pc2", "mask", "flow")
EVAL_KEYS = ("loss", "epe3d", "acc3d_strict", "acc3d_relax", "outlier")


def sequence_loss_of(model, batch: Batch, gamma: float, num_iters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train step's loss: (sequence loss, flows (T, B, N, 3)); a
    sequence-parallel model's share of it."""
    flows, _ = model(batch["pc1"], batch["pc2"], num_iters)
    return sequence_loss(flows, batch["mask"], batch["flow"], gamma,
                         seq_group_of(model)), flows


def seq_group_of(model) -> Any:
    """The seq group a sequence-parallel model's points are sharded over,
    else None."""
    return getattr(model, "seq_group", None)


def refine_loss_of(model, batch: Batch, num_iters: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The refine train step's loss: (masked L1 of the refined flow, the
    refined flow (B, N, 3)) (``tools/engine_refine.py:142``); a
    sequence-parallel model's share of it (the mask counted over its
    seq group)."""
    flow = model(batch["pc1"], batch["pc2"], num_iters)
    return compute_loss(flow, batch["mask"], batch["flow"],
                        seq_group_of(model)), flow


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


FLOAT32_NAMES = (None, "float32", "f32")


def maybe_cast_grads(grads: Sequence[torch.Tensor],
                     grad_dtype: Optional[str]) -> List[torch.Tensor]:
    """The bf16-gradient lever (``TrainConfig.grad_dtype``, the JAX
    ``maybe_cast_grads``): each gradient cast to ``grad_dtype`` and back
    to its own dtype, so that the optimizer state stays float32. The
    gradients as they are for float32."""
    if grad_dtype in FLOAT32_NAMES:
        return list(grads)
    dt = getattr(torch, grad_dtype)
    return [g.to(dt).to(g.dtype) for g in grads]


def _cast_param_grads(optimizer: torch.optim.Optimizer,
                      grad_dtype: Optional[str]) -> None:
    """:func:`maybe_cast_grads` on the ``.grad`` of every parameter the
    optimizer updates, in place of the gradient (before its step)."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is not None]
    for p, g in zip(params, maybe_cast_grads([p.grad for p in params],
                                             grad_dtype)):
        p.grad = g


def _check_levers(grad_dtype: Optional[str]) -> None:
    if grad_dtype not in (*FLOAT32_NAMES, "bfloat16"):
        raise ValueError(f"grad_dtype must be 'float32' or 'bfloat16', "
                         f"got {grad_dtype!r}")


class StepMonitor:
    """The telemetry of one train step (``obs/monitors.py``): every
    parameter of ``model``, the ones ``optimizer`` trains (the views of
    the ``packed`` state's flat buffer where it is given), and whether
    the step's stacked flows are monitored (``flows``). ``paths`` is the
    layout of the leaves the step returns after its loss and EPE."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, flows: bool,
                 packed: Optional["PackedState"] = None):
        self.model = model
        self.packed = packed
        self.flows = flows
        self.trained = [p for g in optimizer.param_groups
                        for p in g["params"]]
        names = {id(p): n for n, p in model.named_parameters()}
        self.trained_names = [names[id(p)] for p in self.trained]
        groups = sorted({monitors.param_group(n) for n in names.values()})
        self.paths = ([("grad_norm",), ("param_norm",), ("update_ratio",)]
                      + [("grad_norm_by_group", g) for g in groups]
                      + ([("delta_flow_norm",)] if flows else [])
                      + [("nonfinite",)])

    def before(self) -> List[torch.Tensor]:
        """Copies of the trained parameters, taken just before the
        optimizer's step: one multi-tensor copy, or one copy of the
        parameters' slots of the packed buffer."""
        if self.packed is not None:
            flat = self.packed.flat
            return self.packed.param_views(
                flat[:self.packed.param_end].clone())
        return list(torch._foreach_mul([p.detach() for p in self.trained],
                                       1.0))

    def leaves(self, before: List[torch.Tensor], loss: torch.Tensor,
               flows: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The leaves, in ``paths`` order, after the step."""
        pre = dict(zip(self.trained_names, before))
        named = list(self.model.named_parameters())
        tel = monitors.telemetry_leaves(
            {n: pre.get(n, p.detach()) for n, p in named},
            {n: p.grad for n, p in named},
            torch._foreach_sub([p.detach() for p in self.trained], before),
            loss.detach(), flows if self.flows else None)
        return monitors.flatten(tel)

    def telemetry(self, leaves: Sequence[torch.Tensor]) -> Dict:
        return monitors.unflatten(self.paths, leaves)


# loss_of(batch) -> (loss, the flow the EPE is read from, the stacked
# flows of stage 1 or None)
LossOf = Callable[[Batch], Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]]


class GradientAllReduce:
    """The reduction of one train step (the gradient all-reduce GSPMD
    inserts into the JAX step): the gradients of the parameters
    ``optimizer`` trains, then the step's loss and EPE, packed into one
    flat float32 bucket, one collective over ``group`` (the whole run),
    and the result scaled by ``n_seq / world``: summed over the ranks of
    each seq group (``n_seq`` of them, whose gradients, loss and EPE are
    shares of their scenes') and averaged over the data axis. Every rank's
    gradients become the global batch's, the same bit for bit on every
    rank, and the loss and EPE the global batch's means. On NCCL without
    a seq axis the collective averages itself (``ReduceOp.AVG``, a
    premultiplied sum: at one rank an in-place SUM launches no kernel, an
    average launches one, so a profile of the step shows the reduction);
    else it sums and the bucket is scaled. Inside a captured step the
    collective is captured too (NCCL only)."""

    def __init__(self, optimizer: torch.optim.Optimizer, group: Any,
                 n_seq: int = 1):
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.group = group
        self.world = dist.get_world_size(group)
        self.n_seq = n_seq
        self.average = dist.get_backend(group) == "nccl" and n_seq == 1
        self.calls = 0

    def __call__(self, loss: torch.Tensor, epe: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        grads = [p.grad for p in self.params if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.reshape(1).float(), epe.reshape(1).float()])
        if self.average:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            flat.mul_(self.n_seq / self.world)
        parts = flat.split([g.numel() for g in grads] + [1, 1])
        torch._foreach_copy_(grads, [v.view_as(g)
                                     for v, g in zip(parts, grads)])
        self.calls += 1
        return parts[-2].reshape(()), parts[-1].reshape(())


def data_group(model=None) -> Any:
    """The group a train step reduces over: the whole group of
    ``model``'s mesh where it has one (``PVRaft(cfg, mesh)``), else the
    whole process group where there is one (of any size, 1 included),
    else None (one process: nothing to reduce)."""
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.group is not None:
        return mesh.group
    return dist.group.WORLD if is_initialized() else None


def _train_body(optimizer, loss_of: LossOf, grad_dtype: Optional[str] = None,
                monitor: Optional[StepMonitor] = None
                ) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """zero_grad / ``loss_of`` / backward / with a process group, the
    gradients, loss and EPE through :class:`GradientAllReduce` over
    :func:`data_group` of ``loss_of.model`` (summed over its seq group
    where the model is sequence-parallel) / the gradients through
    :func:`maybe_cast_grads` / step at the optimizer's current learning
    rate; returns (loss, epe) of the last flow, then ``monitor``'s leaves
    where it is given (read from the reduced gradients and loss; the
    flows' leaves are this rank's batch's). ``body.reduce`` is the
    reduction, or None."""
    model = getattr(loss_of, "model", None)
    seq = seq_group_of(model)
    group = data_group(model)
    reduce = (GradientAllReduce(optimizer, group, group_size(seq))
              if group is not None else None)

    def body(pc1, pc2, mask, flow):
        batch = {"pc1": pc1, "pc2": pc2, "mask": mask, "flow": flow}
        optimizer.zero_grad(set_to_none=True)
        loss, last, flows = loss_of(batch)
        loss.backward()
        with torch.no_grad():
            loss = loss.detach()
            epe = epe_train(last, mask, flow, seq)
            if reduce is not None:
                loss, epe = reduce(loss, epe)
        _cast_param_grads(optimizer, grad_dtype)
        pre = monitor.before() if monitor is not None else None
        optimizer.step()
        with torch.no_grad():
            if monitor is None:
                return loss, epe
            return (loss, epe, *monitor.leaves(pre, loss, flows))

    body.reduce = reduce
    return body


def _stage1_loss(model, gamma: float, num_iters: int) -> LossOf:
    def loss_of(batch: Batch):
        loss, flows = sequence_loss_of(model, batch, gamma, num_iters)
        return loss, flows[-1], flows

    loss_of.model = model
    return loss_of


def _refine_loss(model, num_iters: int) -> LossOf:
    def loss_of(batch: Batch):
        loss, flow = refine_loss_of(model, batch, num_iters)
        return loss, flow, None

    loss_of.model = model
    return loss_of


def _metrics(out: Sequence[torch.Tensor],
             monitor: Optional[StepMonitor]) -> Batch:
    """A step's ``{"loss", "epe"[, "telemetry"]}`` from its body's
    outputs."""
    metrics = {"loss": out[0], "epe": out[1]}
    if monitor is not None:
        metrics["telemetry"] = monitor.telemetry(out[2:])
    return metrics


def _eager_step(body, optimizer, schedule, count: Optional[List[int]] = None,
                before: Optional[Callable[[], None]] = None,
                monitor: Optional[StepMonitor] = None
                ) -> Callable[[Batch], Batch]:
    count = [optimizer_steps(optimizer)] if count is None else count

    def train_step(batch: Batch) -> Batch:
        if before is not None:
            before()
        set_lr(optimizer, schedule(count[0]))
        out = body(*(batch[k] for k in BATCH_KEYS))
        count[0] += 1
        return _metrics(out, monitor)

    train_step.count = count
    train_step.monitor = monitor
    train_step.reduce = body.reduce
    return train_step


def _monitor(telemetry: bool, model, optimizer, flows: bool,
             packed: Optional["PackedState"] = None
             ) -> Optional[StepMonitor]:
    return (StepMonitor(model, optimizer, flows, packed) if telemetry
            else None)


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], gamma: float,
                    num_iters: int, grad_dtype: Optional[str] = None,
                    telemetry: bool = False) -> Callable[[Batch], Batch]:
    """Stage-1 training step: ``step(batch) -> {"loss", "epe"}`` (detached
    tensors on the batch's device). After it, each parameter's ``.grad``
    holds this step's gradient. The step count is read from the optimizer
    once, here, and kept on the host (under ``capturable`` the optimizer's
    own count is a device tensor) in ``step.count[0]``, the schedule's
    position, which a resume sets. With a process group the gradients,
    loss and EPE are the mean over its ranks (:func:`data_group`, in every
    train step factory)."""
    _check_levers(grad_dtype)
    monitor = _monitor(telemetry, model, optimizer, flows=True)
    return _eager_step(_train_body(optimizer, _stage1_loss(
        model, gamma, num_iters), grad_dtype, monitor), optimizer, schedule,
        monitor=monitor)


def make_refine_train_step(model, optimizer: torch.optim.Optimizer,
                           schedule: Callable[[int], float], num_iters: int,
                           grad_dtype: Optional[str] = None,
                           telemetry: bool = False
                           ) -> Callable[[Batch], Batch]:
    """Stage-2 training step (``pvraft_tpu/engine/steps.py::
    make_refine_train_step``): :func:`make_train_step` on a PVRaftRefine
    and an optimizer over its head (``weights.trained_parameters``), with
    :func:`refine_loss_of` for the loss. The backbone gets no gradient."""
    _check_levers(grad_dtype)
    monitor = _monitor(telemetry, model, optimizer, flows=False)
    return _eager_step(_train_body(
        optimizer, _refine_loss(model, num_iters), grad_dtype, monitor),
        optimizer, schedule, monitor=monitor)


def _tensor_lrs(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    lrs = [g["lr"] for g in optimizer.param_groups]
    if not all(torch.is_tensor(lr) for lr in lrs):
        raise ValueError("a graphed train step needs every lr as a tensor")
    return lrs


def _graph_cache(name: str, body, optimizer: torch.optim.Adam,
                 device: torch.device, strict_retrace: bool,
                 packed: Optional["PackedState"]) -> GraphCache:
    """The step's programs. Each capture's eager warm-up is undone on
    the parameters and Adam's state (``preserve``): the one flat buffer
    when they are packed. The body sets every .grad to None before its
    backward, so the captured backward writes fresh gradient buffers of
    the graph's own pool at every replay (PyTorch's whole-network capture
    recipe)."""
    if packed is not None:
        state = [packed.flat]
    else:
        init_adam_state(optimizer)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = params + [t for s in optimizer.state.values()
                          for t in s.values() if torch.is_tensor(t)]
    return GraphCache(
        name,
        lambda name, inputs: capture(name, body, inputs, device,
                                     preserve=state),
        strict_retrace)


def _graphed_step(name: str, body, optimizer: torch.optim.Adam, schedule,
                  device: torch.device, strict_retrace: bool,
                  packed: Optional["PackedState"] = None,
                  before: Optional[Callable[[], None]] = None,
                  monitor: Optional[StepMonitor] = None
                  ) -> Callable[[Batch], Batch]:
    lrs = _tensor_lrs(optimizer)
    graphs = _graph_cache(name, body, optimizer, device, strict_retrace,
                          packed)
    count = [optimizer_steps(optimizer)] if packed is None else packed.count

    def train_step(batch: Batch) -> Batch:
        inputs = [batch[k] for k in BATCH_KEYS]
        program = graphs.program_for(inputs)
        if before is not None:
            before()
        lr = schedule(count[0])
        for t in lrs:
            t.fill_(lr)
        out = program(*inputs)
        count[0] += 1
        return _metrics(out, monitor)

    train_step.graphs = graphs
    train_step.count = count
    train_step.monitor = monitor
    train_step.reduce = body.reduce
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
    count is read from the optimizer once, here, into ``step.count[0]``."""
    _check_levers(grad_dtype)
    monitor = _monitor(telemetry, model, optimizer, flows=True)
    return _graphed_step("train_step", _train_body(
        optimizer, _stage1_loss(model, gamma, num_iters), grad_dtype,
        monitor), optimizer, schedule, device, strict_retrace,
        monitor=monitor)


def make_graphed_refine_train_step(model, optimizer: torch.optim.Adam,
                                   schedule: Callable[[int], float],
                                   num_iters: int, device: torch.device,
                                   strict_retrace: bool = False,
                                   grad_dtype: Optional[str] = None,
                                   telemetry: bool = False
                                   ) -> Callable[[Batch], Batch]:
    """:func:`make_refine_train_step` as one captured program per input
    signature (``refine_train_step``), as :func:`make_graphed_train_step`
    captures the stage-1 step: the backbone's iterations run in the graph
    without autograd, the head's forward, backward and Adam with it."""
    _check_levers(grad_dtype)
    monitor = _monitor(telemetry, model, optimizer, flows=False)
    return _graphed_step("refine_train_step", _train_body(
        optimizer, _refine_loss(model, num_iters), grad_dtype, monitor),
        optimizer, schedule, device, strict_retrace, monitor=monitor)


# --- the K-step levers: packed state, host round trip, K steps a graph ----

ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


# Each tensor of the packed state starts on a multiple of this many
# floats (512 bytes, the caching allocator's alignment), so that a view
# is as aligned as a tensor of its own and every kernel (cuBLAS among
# them) takes the path it takes on one: packed steps stay bitwise equal
# to unpacked ones.
SLOT_ALIGN = 128


class PackedState:
    """The optimizer's parameters and Adam's ``step``, ``exp_avg`` and
    ``exp_avg_sq`` as views of one flat float32 buffer on the
    parameters' device (the JAX ``ravel_pytree`` of ``(params,
    opt_state)``): the parameters first, then each parameter's three
    state tensors, each slot starting on a multiple of
    :data:`SLOT_ALIGN` floats. ``count`` is the schedule's position, kept
    on the host and shared by every step built on this state: make one
    per optimizer, and pass it to each packed step built on that
    optimizer."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer):
        init_adam_state(optimizer)
        self.optimizer = optimizer
        self.params = [p for g in optimizer.param_groups
                       for p in g["params"]]
        names = {id(p): n for n, p in trained_parameters(model)}
        self.names = [names[id(p)] for p in self.params]
        self.shapes = [t.shape for t in self.tensors()]
        self.offsets, o = [], 0
        for shape in self.shapes:
            self.offsets.append(o)
            o += -(-shape.numel() // SLOT_ALIGN) * SLOT_ALIGN
        self.flat = torch.zeros(o, dtype=torch.float32,
                                device=self.params[0].device)
        self.count = [optimizer_steps(optimizer)]
        self.repack()

    @property
    def param_end(self) -> int:
        """The end of the parameters' slots, which come first."""
        return self.offsets[len(self.params)]

    def param_views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """The parameters' slots as views of ``buf`` (a copy of the flat
        buffer, or of its first :attr:`param_end` floats)."""
        n = len(self.params)
        return [buf[o:o + shape.numel()].view(shape)
                for o, shape in zip(self.offsets[:n], self.shapes[:n])]

    def tensors(self) -> List[torch.Tensor]:
        state = self.optimizer.state
        return self.params + [state[p][k] for p in self.params
                              for k in ADAM_KEYS]

    def _slots(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[o:o + shape.numel()].view(shape)
                for o, shape in zip(self.offsets, self.shapes)]

    def repack(self) -> None:
        """Make every tensor the view of its slot again, copying in its
        value where it is not (``optimizer.load_state_dict`` replaces
        Adam's state tensors). The buffer stays the same, so steps
        captured on it stay valid."""
        state = self.optimizer.state
        with torch.no_grad():
            for i, (t, slot) in enumerate(zip(self.tensors(),
                                              self._slots(self.flat))):
                if (t.data_ptr() == slot.data_ptr()
                        and t.shape == slot.shape):
                    continue
                slot.copy_(t)
                if i < len(self.params):
                    self.params[i].data = slot
                else:
                    j, k = divmod(i - len(self.params), len(ADAM_KEYS))
                    state[self.params[j]][ADAM_KEYS[k]] = slot

    def unravel(self, flat: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor],
                           List[Dict[str, torch.Tensor]]]:
        """``flat`` (this buffer or a copy of it) as (trained parameters by
        name, Adam's state per parameter in the optimizer's order), views
        of ``flat``."""
        slots = self._slots(flat)
        n = len(self.params)
        params = dict(zip(self.names, slots[:n]))
        state = [dict(zip(ADAM_KEYS, slots[n + 3 * j:n + 3 * j + 3]))
                 for j in range(n)]
        return params, state


def _loss_for(model, refine: bool, gamma: float, num_iters: int) -> LossOf:
    if refine:
        return _refine_loss(model, num_iters)
    return _stage1_loss(model, gamma, num_iters)


def _round_trip(packed: PackedState) -> Callable[[], None]:
    """``host_roundtrip``: the flat buffer to host memory (pinned where
    the buffer is on the card) and back, bitwise."""
    host = torch.empty(packed.flat.shape, dtype=packed.flat.dtype,
                       pin_memory=packed.flat.is_cuda)

    def round_trip() -> None:
        host.copy_(packed.flat)
        packed.flat.copy_(host)

    return round_trip


def make_packed_train_step(model, optimizer: torch.optim.Optimizer,
                           schedule: Callable[[int], float], gamma: float,
                           num_iters: int, refine: bool = False,
                           host_roundtrip: bool = False,
                           grad_dtype: Optional[str] = None,
                           telemetry: bool = False,
                           packed: Optional[PackedState] = None):
    """The train step of either stage (``refine``) on the packed state
    (``packed``, else a new :class:`PackedState` of ``optimizer``).
    Returns ``(step, flat, unravel)`` as the JAX
    ``make_packed_train_step`` does: ``step(batch) -> {"loss", "epe"}``
    (it updates ``flat`` in place), the flat buffer, and ``unravel(flat)
    -> (parameters, Adam state)``. ``host_roundtrip`` sends the buffer to
    host memory and back before each step. Bitwise equal to
    :func:`make_train_step` (:func:`make_refine_train_step`)."""
    _check_levers(grad_dtype)
    packed = packed or PackedState(model, optimizer)
    monitor = _monitor(telemetry, model, optimizer, False, packed)
    body = _train_body(optimizer, _loss_for(model, refine, gamma, num_iters),
                       grad_dtype, monitor)
    step = _eager_step(body, optimizer, schedule, packed.count,
                       _round_trip(packed) if host_roundtrip else None,
                       monitor)
    return step, packed.flat, packed.unravel


def make_graphed_packed_train_step(model, optimizer: torch.optim.Adam,
                                   schedule: Callable[[int], float],
                                   gamma: float, num_iters: int,
                                   device: torch.device, refine: bool = False,
                                   host_roundtrip: bool = False,
                                   strict_retrace: bool = False,
                                   grad_dtype: Optional[str] = None,
                                   telemetry: bool = False,
                                   packed: Optional[PackedState] = None):
    """:func:`make_packed_train_step` as one captured program per input
    signature (``packed_train_step``): the capture's warm-up is undone on
    the one flat buffer; the round trip runs before each replay."""
    _check_levers(grad_dtype)
    packed = packed or PackedState(model, optimizer)
    monitor = _monitor(telemetry, model, optimizer, False, packed)
    body = _train_body(optimizer, _loss_for(model, refine, gamma, num_iters),
                       grad_dtype, monitor)
    step = _graphed_step("packed_train_step", body, optimizer, schedule,
                         device, strict_retrace, packed,
                         _round_trip(packed) if host_roundtrip else None,
                         monitor)
    return step, packed.flat, packed.unravel


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """K batches stacked on a leading axis: the multistep steps' input."""
    return {k: torch.stack([b[k] for b in batches]) for k in BATCH_KEYS}


def _check_k(steps_per_dispatch: int) -> None:
    if steps_per_dispatch < 1:
        raise ValueError("steps_per_dispatch must be >= 1")


def make_multistep_train_step(model, optimizer: torch.optim.Optimizer,
                              schedule: Callable[[int], float], gamma: float,
                              num_iters: int, steps_per_dispatch: int,
                              refine: bool = False,
                              grad_dtype: Optional[str] = None,
                              telemetry: bool = False,
                              packed: Optional[PackedState] = None):
    """K = ``steps_per_dispatch`` packed train steps a call (the JAX
    ``make_multistep_train_step``, eager): ``step(batches)`` takes a batch
    whose tensors carry a leading axis of K (:func:`stack_batches`) and
    returns ``{"loss", "epe"}`` of shape (K,), one entry a step. Returns
    ``(step, flat, unravel)``; built on the ``packed`` state of a packed
    single step, it shares that step's buffer and schedule position."""
    _check_levers(grad_dtype)
    _check_k(steps_per_dispatch)
    single, flat, unravel = make_packed_train_step(
        model, optimizer, schedule, gamma, num_iters, refine,
        grad_dtype=grad_dtype, telemetry=telemetry, packed=packed)
    monitor = single.monitor

    def multistep_train_step(batches: Batch) -> Batch:
        out = [single({k: v[i] for k, v in batches.items()})
               for i in range(steps_per_dispatch)]
        metrics = {k: torch.stack([o[k] for o in out])
                   for k in ("loss", "epe")}
        if monitor is not None:
            metrics["telemetry"] = monitor.telemetry(
                [torch.stack(leaf) for leaf in zip(
                    *(monitors.flatten(o["telemetry"]) for o in out))])
        return metrics

    multistep_train_step.count = single.count
    multistep_train_step.monitor = monitor
    multistep_train_step.reduce = single.reduce
    return multistep_train_step, flat, unravel


def make_graphed_multistep_train_step(model, optimizer: torch.optim.Adam,
                                      schedule: Callable[[int], float],
                                      gamma: float, num_iters: int,
                                      steps_per_dispatch: int,
                                      device: torch.device,
                                      refine: bool = False,
                                      strict_retrace: bool = False,
                                      grad_dtype: Optional[str] = None,
                                      telemetry: bool = False,
                                      packed: Optional[PackedState] = None):
    """:func:`make_multistep_train_step` as one captured program per input
    signature (``multistep_train_step``): K whole train steps (forward,
    loss, backward, the gradient cast, Adam) in one CUDA graph over K
    static batches. The learning rates are one device tensor of K
    entries, an input of the program filled once before each replay from
    ``schedule(count + i)``; captured step i copies entry i into every
    group's ``lr`` before its Adam step. Same kernels in the same order
    as K replays of the packed single step: bitwise equal to them. On
    the CPU the same program runs the K steps on the same static
    buffers."""
    _check_levers(grad_dtype)
    _check_k(steps_per_dispatch)
    k_steps = steps_per_dispatch
    lrs = _tensor_lrs(optimizer)
    packed = packed or PackedState(model, optimizer)
    monitor = _monitor(telemetry, model, optimizer, False, packed)
    body = _train_body(optimizer, _loss_for(model, refine, gamma, num_iters),
                       grad_dtype, monitor)

    def k_body(lr, pc1, pc2, mask, flow):
        outs = []
        for i in range(k_steps):
            for t in lrs:
                t.copy_(lr[i])
            outs.append(body(pc1[i], pc2[i], mask[i], flow[i]))
        # (loss, epe[, leaves...]) of every step, each stacked over K.
        return tuple(torch.stack(col) for col in zip(*outs))

    graphs = _graph_cache("multistep_train_step", k_body, optimizer, device,
                          strict_retrace, packed)
    count = packed.count

    def inputs(batches: Batch) -> List[torch.Tensor]:
        lr = torch.tensor([schedule(count[0] + i) for i in range(k_steps)],
                          dtype=torch.float32)
        return [lr] + [batches[k] for k in BATCH_KEYS]

    def multistep_train_step(batches: Batch) -> Batch:
        args = inputs(batches)
        out = graphs.program_for(args)(*args)
        count[0] += k_steps
        return _metrics(out, monitor)

    multistep_train_step.graphs = graphs
    multistep_train_step.inputs = inputs
    multistep_train_step.count = count
    multistep_train_step.monitor = monitor
    multistep_train_step.reduce = body.reduce
    return multistep_train_step, packed.flat, packed.unravel


def make_eval_step(model, num_iters: int, gamma: float,
                   per_scene: bool = False, refine: bool = False
                   ) -> Callable[[Batch], Tuple[Batch, torch.Tensor]]:
    """``step(batch) -> (metrics, flow)``: the sequence loss and
    :func:`flow_metrics` of the last flow (``refine``: the masked L1 and
    the metrics of a PVRaftRefine's refined flow), as batch means or, with
    ``per_scene``, as (B,) tensors (one value per scene). A
    sequence-parallel model's values are this rank's shares of its
    scenes' (summed over the seq group, they are the scenes')."""
    seq = seq_group_of(model)

    def loss_of(flows, mask, gt):
        if refine:
            return compute_loss(flows, mask, gt, seq)
        return sequence_loss(flows, mask, gt, gamma, seq)

    def eval_step(batch: Batch) -> Tuple[Batch, torch.Tensor]:
        mask, gt = batch["mask"], batch["flow"]
        with torch.no_grad():
            if refine:
                flows = flow = model(batch["pc1"], batch["pc2"], num_iters)
            else:
                flows, _ = model(batch["pc1"], batch["pc2"], num_iters)
                flow = flows[-1]
            if per_scene:
                # Scene b of the (T, B, N, 3) flows or the (B, N, 3) flow.
                per = [{"loss": loss_of(flows[..., b:b + 1, :, :],
                                        mask[b:b + 1], gt[b:b + 1]),
                        **flow_metrics(flow[b:b + 1], mask[b:b + 1],
                                       gt[b:b + 1], seq)}
                       for b in range(flow.shape[0])]
                out = {k: torch.stack([p[k] for p in per]) for k in per[0]}
            else:
                out = {"loss": loss_of(flows, mask, gt),
                       **flow_metrics(flow, mask, gt, seq)}
        return out, flow

    return eval_step


def make_graphed_eval_step(model, num_iters: int, gamma: float,
                           device: torch.device, per_scene: bool = False,
                           strict_retrace: bool = False, refine: bool = False
                           ) -> Callable[[Batch], Tuple[Batch, torch.Tensor]]:
    """:func:`make_eval_step` as one captured program per input
    signature; returns static tensors that the next call overwrites.
    ``step.graphs`` is its :class:`GraphCache`."""
    eager = make_eval_step(model, num_iters, gamma, per_scene, refine)

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
