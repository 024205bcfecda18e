"""Captured programs: the port's counterpart of ``pvraft_tpu/serve/aot.py``.

The JAX package compiles each serve program ahead of time
(``AotProgram``) and runs its train and eval steps as ``jax.jit``
programs. On the card the port captures each such function once as a
CUDA graph over static input and output tensors, and replays it:
:class:`GraphProgram`. :func:`capture` makes one: it copies example
inputs into static buffers, runs the function once eagerly on a side
stream (the first launch of each kernel builds it, loads it and sets its
attributes, none of which a graph can hold; the recipe of PyTorch's
whole-network capture), puts back whatever that run changed
(``preserve``), and captures the function into a
``torch.cuda.CUDAGraph``. A failed capture raises: nothing falls back to
eager execution on the card.

On the CPU, which only a caller that asks for it gets, there is no
graph: the program runs the same function on the same static buffers
at every call and copies its results into the same static outputs, so
the CPU tests exercise what the card replays.

Kernel launches inside a capture are recorded by the wrappers in
``ops/cuda.captured``, and the program keeps its share as ``launches``:
what one replay should launch. What a replay did launch is measured on
the card by ``ops/cuda.measured_launches``. :func:`first_difference`
names the first submodule at which a program and its function run
eagerly part.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from pvraft_tpu_torch.ops import cuda as _cuda

Tensors = Tuple[torch.Tensor, ...]

SERVE_DTYPES = {"float32": "fp32", "bfloat16": "bf16"}


def predict_program_name(bucket: int, batch_size: int,
                         dtype: str = "float32") -> str:
    """The serve engine's per-program name
    (``pvraft_tpu/programs/geometries.py::predict_program_name``): fp32
    keeps 'predict_b{bucket}_bs{bs}', other dtypes splice their short tag
    ('predict_bf16_b..')."""
    short = SERVE_DTYPES[dtype]
    prefix = "predict" if dtype == "float32" else f"predict_{short}"
    return f"{prefix}_b{bucket}_bs{batch_size}"


class GraphProgram:
    """One function over static tensors: captured as a CUDA graph on the
    card, run eagerly on the same buffers on the CPU.

    ``program(*args)`` copies each argument into its static input (shapes
    and dtypes must match), replays (or runs), and returns the static
    outputs, which the next call overwrites: a caller that keeps a result
    across calls clones it.
    """

    def __init__(self, name: str, fn: Callable[..., Tensors],
                 inputs: Tensors, outputs: Optional[Tensors] = None,
                 graph: Optional[torch.cuda.CUDAGraph] = None,
                 warmup_s: float = 0.0, capture_s: float = 0.0,
                 pool_bytes: int = 0,
                 launches: Optional[Dict[str, int]] = None):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.graph = graph
        self.warmup_s = warmup_s
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.launches = dict(launches or {})

    def __call__(self, *args: torch.Tensor) -> Tensors:
        if len(args) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(args)} inputs, expected "
                             f"{len(self.inputs)}")
        for i, (a, s) in enumerate(zip(args, self.inputs)):
            if a.shape != s.shape or a.dtype != s.dtype:
                raise ValueError(
                    f"{self.name}: input {i} is {a.dtype}{list(a.shape)}, "
                    f"the program takes {s.dtype}{list(s.shape)}")
            s.copy_(a)
        if self.graph is not None:
            self.graph.replay()
        elif self.outputs is None:
            self.outputs = tuple(self.fn(*self.inputs))
        else:
            for s, o in zip(self.outputs, self.fn(*self.inputs)):
                s.copy_(o)
        return self.outputs

    def report(self) -> Dict[str, Any]:
        """JSON-safe record (the JAX ``AotProgram.report``): name, eager
        warm-up and capture seconds, the device memory its capture added
        to the pool (``pool_bytes``; in a shared pool, what the programs
        captured before it did not already hold), the kernel launches its
        capture recorded, and whether it is a graph."""
        return {"name": self.name, "graph": self.graph is not None,
                "warmup_s": round(self.warmup_s, 3),
                "capture_s": round(self.capture_s, 3),
                "pool_bytes": self.pool_bytes,
                "launches": dict(self.launches)}


def capture(name: str, fn: Callable[..., Tensors],
            example: Sequence[torch.Tensor], device: torch.device,
            pool: Any = None,
            preserve: Sequence[torch.Tensor] = ()) -> GraphProgram:
    """A :class:`GraphProgram` of ``fn`` over static copies of
    ``example`` on ``device``. ``fn`` returns a tuple of tensors. On a
    CUDA device: one eager warm-up run on a side stream, then every tensor
    of ``preserve`` (parameters, optimizer state) is put back to its value
    before the warm-up, in place, then ``fn`` is captured into one graph
    in ``pool`` (a ``torch.cuda.graph_pool_handle()`` that programs which
    never run at once may share). Raises if the capture fails. On the
    CPU: static buffers only, nothing runs."""
    inputs = tuple(t.detach().to(device).clone() for t in example)
    if device.type != "cuda":
        return GraphProgram(name, fn, inputs)
    kept = [t.detach().clone() for t in preserve]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream(device).wait_stream(side)
    with torch.no_grad():
        for t, k in zip(preserve, kept):
            t.copy_(k)
    del kept
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    # torch.cuda.graph empties the allocator's cache before capturing; do
    # it first, so that the growth of reserved memory is the pool's.
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = dict(_cuda.captured)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outputs = tuple(fn(*inputs))
    torch.cuda.synchronize(device)
    launches = {k: n - before.get(k, 0) for k, n in _cuda.captured.items()
                if n != before.get(k, 0)}
    return GraphProgram(
        name, fn, inputs, outputs, graph, warmup_s=t1 - t0,
        capture_s=time.perf_counter() - t1,
        pool_bytes=torch.cuda.memory_reserved(device) - reserved,
        launches=launches)


def _tensors(out: Any) -> list:
    """The tensors of a module's output (nested tuples, lists, dicts)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def first_difference(module: torch.nn.Module, fn: Callable[..., Any],
                     example: Sequence[torch.Tensor], device: torch.device
                     ) -> Optional[Dict[str, Any]]:
    """Where a captured program of ``fn`` (which runs ``module``) first
    parts from ``fn`` run eagerly on the same inputs, both without
    gradients. A forward hook on every submodule of ``module`` clones its
    tensor outputs; inside the capture the clones are recorded into the
    graph, so one replay refreshes them. The records of the replay and of
    the eager run are compared in the order the calls finished (the
    innermost module first). Returns ``{"module", "call", "max_abs_diff"}``
    of the first record that is not bitwise equal (``call``: which call of
    that module), or None."""
    records = []

    def hook_for(name):
        def hook(_mod, _args, out):
            records.extend((name, t.detach().clone())
                           for t in _tensors(out))
        return hook

    def traced(*inputs):
        records.clear()
        with torch.no_grad():
            fn(*inputs)
        return tuple(t for _, t in records)

    handles = [m.register_forward_hook(hook_for(n))
               for n, m in module.named_modules() if n]
    try:
        program = capture("first_difference", traced, example, device)
        replayed = [t.clone() for t in program(*program.inputs)]
        eager = traced(*program.inputs)
        names = [n for n, _ in records]
    finally:
        for h in handles:
            h.remove()
    calls: Dict[str, int] = {}
    for name, got, want in zip(names, replayed, eager):
        calls[name] = calls.get(name, 0) + 1
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max()
            return {"module": name, "call": calls[name] - 1,
                    "max_abs_diff": float(diff)}
    return None
