"""The registry's cost inventory, the ``pvraft_costs/v1`` document, and
its read side (the port's counterpart of ``pvraft_tpu/programs/
costs.py``).

**The count.** There is no XLA cost analysis here: the port counts its
own programs. :func:`count_program` runs a program once, eagerly, under
a ``TorchDispatchMode`` (:class:`OpCounter`) that sees every aten op:

* ``flops``: the matrix products, by ``torch.utils.flop_counter``'s
  registered formulas (elementwise ops count none, as there);
* ``bytes_accessed``: each op's tensor operands read and its outputs
  written, at their shapes: a view moves nothing, an in-place op's
  output is the operand it writes (read and written once each), an
  ``out=`` operand is written only, a fresh ``empty`` nothing. This is
  op traffic without fusion, the port's counterpart of XLA's "bytes
  accessed" (``PERF.md`` §3);
* the peak of live tensor bytes (arguments included): each new storage
  from when an op makes it until it is freed.

Inside a hand-written kernel's autograd Function the counter adds the
kernel's own bytes and operations (``ops/kernel_bounds.py``, the numbers
``PERF.md``'s Bound column uses) and counts none of the ops the plain
version runs there on the CPU, so a program counts the same on the CPU
and on the card.

**The record** (:func:`cost_record`) keeps the JAX fields and passes the
JAX package's ``validate_costs``: ``name``, ``target`` (the card's name,
or "host"), ``tags``, ``flops``, ``bytes_accessed``, ``ok``, ``memory``
(``argument_size_in_bytes``, ``output_size_in_bytes``,
``live_bytes_estimate``, ``fits_hbm`` against the document's
``hbm_limit_bytes``, ``fits_16GiB_hbm`` answered literally, and on the
card ``max_memory_allocated`` of the run and ``allocated_at_start``, the
bytes allocated when it began: its arguments and whatever else the
process held), ``count_s`` where JAX records compile seconds, and for a
program on a mesh (``fn.mesh``) the record's ``mesh``, its axis sizes.

**The surface** (:class:`CostSurface`) prices a program from its record
by the roofline, ``max(flops / peak, bytes / bandwidth)``, at the H100's
peaks (``ops/kernel_bounds.py``): the JAX package's ``basis="roofline"``
(the shared event schema admits no other basis here).

CLI::

    python -m pvraft_tpu_torch.programs costs [--out PATH] [--device cpu]
    python -m pvraft_tpu_torch.programs costs --check PATH

The default document is ``pvraft_tpu_torch/_build/programs_costs.json``
(git-ignored): nothing of it is committed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pvraft_tpu_torch.ops.kernel_bounds import (
    BF16_FLOPS_PER_S,
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    HBM_CAPACITY_BYTES,
)
from pvraft_tpu_torch.ops import kernel_bounds
from pvraft_tpu_torch.programs.spec import ProgramSpec
from pvraft_tpu_torch.serve.aot import SERVE_DTYPES

COSTS_SCHEMA = "pvraft_costs/v1"

# The JAX validator's literal verdict key: live bytes within 16 GiB.
GIB16 = 16 * 1024**3

_MEMORY_BYTE_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
                     "live_bytes_estimate", "max_memory_allocated",
                     "allocated_at_start")

# Factory ops that allocate without writing.
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


def _tensors(x) -> List[Any]:
    """The tensors of a (nested) argument or result."""
    import torch

    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class OpCounter:
    """Counts one eager run (see the module docstring). Use as a context
    manager around the run; read ``flops``, ``bytes_accessed``,
    ``peak_live_bytes`` and ``by_op`` (op name -> [calls, bytes, flops])
    afterwards."""

    def __init__(self):
        self.flops = 0
        self.bytes_accessed = 0
        self.by_op: Dict[str, List[int]] = {}
        self.kernel_launches = 0
        self._kernel_depth = 0
        self._live: Dict[int, int] = {}
        self._finalizers: List[Any] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._mode = None

    # --- live bytes --------------------------------------------------------

    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` as live until they are freed
        (each storage once)."""
        for t in tensors:
            storage = t.untyped_storage()
            key, size = storage.data_ptr(), storage.nbytes()
            if size == 0 or key in self._live:
                continue
            self._live[key] = size
            self.live_bytes += size
            self._finalizers.append(
                weakref.finalize(storage, self._free, key))
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # --- the kernels' hook (ops/kernel_bounds.kernel_scope) ----------------

    def enter_kernel(self) -> None:
        self._kernel_depth += 1

    def kernel_outputs(self, outputs) -> None:
        self.track(_tensors(outputs))

    def exit_kernel(self, cost) -> None:
        self._kernel_depth -= 1
        self.kernel_launches += 1
        self._add("kernel", cost.bytes, cost.flops)

    # --- the ops -----------------------------------------------------------

    def _add(self, name: str, bytes_: int, flops: int) -> None:
        self.bytes_accessed += bytes_
        self.flops += flops
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += bytes_
        row[2] += flops

    def count_op(self, func, args, kwargs, out) -> None:
        if self._kernel_depth:
            return
        from torch.utils.flop_counter import flop_registry

        schema = func._schema
        returns = schema.returns
        fresh = _tensors(out)
        if returns and all(r.alias_info is not None
                           and not r.alias_info.is_write for r in returns):
            return                      # a view: no traffic, no storage
        reads, writes = [], []
        bound = list(zip(schema.arguments, args)) + [
            (a, kwargs[a.name]) for a in schema.arguments
            if a.name in kwargs]
        for arg, value in bound:
            ts = _tensors(value)
            info = arg.alias_info
            if info is not None and info.is_write:
                writes += ts
                if not arg.kwarg_only:      # in place: read, then written
                    reads += ts
            else:
                reads += ts
        if any(r.alias_info is not None and r.alias_info.is_write
               for r in returns):
            fresh = []                      # the written operands, counted
        if func.overloadpacket.__name__ in _NO_TRAFFIC:
            reads, writes = [], []
        else:
            writes += fresh
        flops = 0
        counter = flop_registry.get(func.overloadpacket)
        if counter is not None:
            flops = int(counter(*args, **kwargs, out_val=out))
        self._add(func.overloadpacket.__name__,
                  sum(_nbytes(t) for t in reads + writes), flops)
        self.track(fresh)

    def __enter__(self) -> "OpCounter":
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                counter.count_op(func, args, kwargs, out)
                return out

        self._mode = _Mode()
        kernel_bounds._ACTIVE.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._mode.__exit__(*exc)
        finally:
            kernel_bounds._ACTIVE.remove(self)
            for f in self._finalizers:
                f.detach()
            self._finalizers = []


def count_program(fn, inputs: Sequence[Any]) -> Dict[str, Any]:
    """Run ``fn(*inputs)`` once under an :class:`OpCounter`; returns its
    flops, bytes accessed, argument and output bytes (``fn.state``
    counted among the arguments), the peak of live bytes, the kernel
    launches counted by their own numbers, the seconds and the per-op
    rows."""
    args = _tensors(list(inputs)) + _tensors(list(getattr(fn, "state", ())))
    arg_storages = {t.untyped_storage().data_ptr(): t.untyped_storage()
                    .nbytes() for t in args}
    t0 = time.perf_counter()
    with OpCounter() as counter:
        counter.track(args)
        out = fn(*inputs)
    outs = _tensors(out)
    seen = {}
    for t in outs:
        seen.setdefault(t.untyped_storage().data_ptr(), _nbytes(t))
    return {
        "flops": counter.flops,
        "bytes_accessed": counter.bytes_accessed,
        "argument_size_in_bytes": sum(arg_storages.values()),
        "output_size_in_bytes": sum(seen.values()),
        "live_bytes_estimate": counter.peak_live_bytes,
        "kernel_launches": counter.kernel_launches,
        "count_s": time.perf_counter() - t0,
        "by_op": counter.by_op,
    }


def target_of(device) -> str:
    """The record's ``target``: the card's name, or "host"."""
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"


def hbm_limit_of(device) -> int:
    """The card's device memory (``torch.cuda.mem_get_info``), or on the
    host the H100's by its data sheet."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return HBM_CAPACITY_BYTES


def cost_record(spec: ProgramSpec, device=None, size: str = "flagship",
                hbm_limit_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Build ``spec`` on ``device`` (the card unless another device is
    named) at ``size``, count one run and return its ``pvraft_costs/v1``
    record. A failure is recorded (``ok: false`` and the error), never
    raised: one broken program must not hide the rest of the inventory."""
    import gc

    import torch

    from pvraft_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    limit = hbm_limit_of(dev) if hbm_limit_bytes is None else hbm_limit_bytes
    rec: Dict[str, Any] = {"name": spec.name, "target": target_of(dev),
                           "tags": list(spec.tags), "size": size}
    try:
        fn, inputs = spec.build(dev, size)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            at_start = int(torch.cuda.memory_allocated(dev))
        got = count_program(fn, inputs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        live = got["live_bytes_estimate"]
        memory = {k: got[k] for k in ("argument_size_in_bytes",
                                      "output_size_in_bytes",
                                      "live_bytes_estimate")}
        memory["fits_hbm"] = live <= limit
        memory["fits_16GiB_hbm"] = live <= GIB16
        if dev.type == "cuda":
            memory["max_memory_allocated"] = int(
                torch.cuda.max_memory_allocated(dev))
            memory["allocated_at_start"] = at_start
        if getattr(fn, "mesh", None) is not None:
            rec["mesh"] = dict(fn.mesh)
        rec.update(flops=float(got["flops"]),
                   bytes_accessed=float(got["bytes_accessed"]),
                   kernel_launches=got["kernel_launches"],
                   count_s=round(got["count_s"], 3), memory=memory, ok=True)
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {str(e)[:800]}"
    finally:
        fn = inputs = got = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def run_costs(specs: Sequence[ProgramSpec], device=None,
              size: str = "flagship", log=None) -> Dict[str, Any]:
    """The inventory of ``specs`` counted on ``device`` (the card unless
    another device is named) at ``size``."""
    import torch

    from pvraft_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    t0 = time.monotonic()
    results: List[Dict[str, Any]] = []
    doc: Dict[str, Any] = {
        "schema": COSTS_SCHEMA,
        "topology": target_of(dev),
        "hbm_limit_bytes": hbm_limit_of(dev),
        "host_platform": "gpu" if dev.type == "cuda" else dev.type,
        "size": size,
        "versions": {"torch": torch.__version__,
                     "cuda": torch.version.cuda},
        "excluded_expect_failure": [],
        "programs": results,
    }
    for spec in specs:
        r = cost_record(spec, dev, size, doc["hbm_limit_bytes"])
        results.append(r)
        if log is not None:
            log(progress_line(r))
    doc["total_s"] = round(time.monotonic() - t0, 1)
    doc["ok"] = all(r["ok"] for r in results)
    return doc


def progress_line(r: Dict[str, Any]) -> str:
    if r.get("ok"):
        mem = r.get("memory") or {}
        return (f"[costs] {r['name']} ({r['target']}): "
                f"{r.get('flops', 0):.4g} flops, "
                f"{r.get('bytes_accessed', 0):.4g} B accessed, "
                f"peak {mem.get('live_bytes_estimate', 0):.4g} B "
                f"(count {r.get('count_s')}s)")
    return (f"[costs] {r['name']} ({r['target']}): FAIL "
            f"{r.get('error', '')[:200]}")


# ---------------------------------------------------------------- validate --


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_costs(doc: Any, path: str = "<costs>") -> List[str]:
    """Schema problems of a ``pvraft_costs/v1`` document ([] = valid):
    the JAX package's checks (every record ok, flops and bytes numbers
    >= 0, byte counts >= 0, the live-bytes estimate and the 16 GiB
    verdict present) and the port's ``fits_hbm`` verdict."""
    if not isinstance(doc, dict):
        return [f"{path}: document is {type(doc).__name__}, not an object"]
    problems: List[str] = []
    if doc.get("schema") != COSTS_SCHEMA:
        problems.append(
            f"{path}: schema {doc.get('schema')!r} != {COSTS_SCHEMA!r}")
    for key in ("topology", "hbm_limit_bytes", "programs"):
        if key not in doc:
            problems.append(f"{path}: missing field {key!r}")
    if problems:
        return problems
    if not isinstance(doc["programs"], list):
        return [f"{path}: programs must be a list"]
    seen = set()
    for i, r in enumerate(doc["programs"]):
        where = f"{path}: programs[{i}]"
        if not isinstance(r, dict) or not isinstance(r.get("name"), str):
            problems.append(f"{where}: not an object with a 'name'")
            continue
        where = f"{path}: {r['name']}"
        if r["name"] in seen:
            problems.append(f"{where}: duplicate record")
        seen.add(r["name"])
        if not isinstance(r.get("target"), str) or not r.get("target"):
            problems.append(f"{where}: missing/empty 'target'")
        if not r.get("ok"):
            problems.append(
                f"{where}: record is not ok "
                f"({r.get('error', 'no error recorded')[:200]})")
            continue
        for key in ("flops", "bytes_accessed"):
            if not _is_num(r.get(key)) or r[key] < 0:
                problems.append(
                    f"{where}: {key}={r.get(key)!r} must be a number >= 0")
        mem = r.get("memory")
        if not isinstance(mem, dict):
            problems.append(f"{where}: missing memory analysis")
            continue
        for key in _MEMORY_BYTE_KEYS:
            if key in mem and (not _is_num(mem[key]) or mem[key] < 0):
                problems.append(f"{where}: memory.{key}={mem[key]!r} must "
                                "be a number >= 0")
        if not _is_num(mem.get("live_bytes_estimate")):
            problems.append(f"{where}: memory.live_bytes_estimate missing "
                            "— the peak estimate is the record's point")
        for key in ("fits_hbm", "fits_16GiB_hbm"):
            if not isinstance(mem.get(key), bool):
                problems.append(f"{where}: memory.{key} must be a bool "
                                "verdict")
    return problems


def check_coverage(doc: Dict[str, Any], specs: Sequence[ProgramSpec],
                   path: str = "<costs>") -> List[str]:
    """Both directions against the registry: every spec has a record and
    every record names a live spec."""
    problems: List[str] = []
    want = {s.name for s in specs}
    have = {r.get("name") for r in doc.get("programs", ())
            if isinstance(r, dict)}
    for name in sorted(want - have):
        problems.append(
            f"{path}: registry spec {name!r} has no cost record — "
            "regenerate with `python -m pvraft_tpu_torch.programs costs "
            f"--out {path}`")
    for name in sorted(have - want):
        problems.append(f"{path}: record {name!r} names no live registry "
                        "spec (stale document) — regenerate")
    return problems


def validate_costs_file(path: str, coverage: bool = False) -> List[str]:
    """:func:`validate_costs` of the file at ``path`` and, with
    ``coverage``, :func:`check_coverage` against the whole catalog."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: {type(e).__name__}: {e}"]
    problems = validate_costs(doc, path=path)
    if coverage and not problems:
        from pvraft_tpu_torch.programs import load_catalog, specs

        load_catalog()
        problems = check_coverage(doc, list(specs().values()), path=path)
    return problems


# ------------------------------------------------------------ CostSurface --


# serve_predict_<variant>_b<bucket>_bs<bs> (programs/catalog.py).
_SERVE_RECORD_RE = re.compile(
    r"^serve_predict_(?P<variant>[a-z0-9_]+?)_b(?P<bucket>\d+)"
    r"_bs(?P<bs>\d+)$")


def _normalize_dtype(dtype: Optional[str]) -> str:
    """The config's compute-dtype aliases: 'f32' and None are float32,
    'bf16' bfloat16."""
    if dtype in ("f32", None):
        return "float32"
    if dtype == "bf16":
        return "bfloat16"
    return dtype


def peak_flops_for(dtype: str) -> float:
    """The H100's peak for a compute dtype: the bf16 tensor cores at
    bfloat16, else the fp32 CUDA cores (the port turns TF32 off)."""
    return BF16_FLOPS_PER_S if _normalize_dtype(dtype) == "bfloat16" \
        else FP32_FLOPS_PER_S


def hardware_utilization(flops: float, measured_s: float,
                         dtype: str) -> Optional[float]:
    """The share of the card's peak that ``flops`` in ``measured_s``
    achieved (None when the measurement carries no signal)."""
    if measured_s <= 0 or flops <= 0:
        return None
    return flops / (measured_s * peak_flops_for(dtype))


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One prediction off the inventory: ``device_seconds`` is the
    roofline ``max(flops / peak, bytes / bandwidth)`` of one run
    (``basis="roofline"``). ``comparable`` is True for a record counted
    on the card (``target`` not "host"); a dispatch's calibration is
    comparable only on a TPU (``serve/costing.py``), so never here.
    ``extrapolated`` marks a linear scaling from a neighbouring serve
    geometry (``reference``, ``scale``)."""

    name: str
    target: str
    flops: float
    bytes_accessed: float
    device_seconds: float
    basis: str
    comparable: bool
    optimal_seconds: Optional[float] = None
    live_bytes_estimate: Optional[float] = None
    extrapolated: bool = False
    scale: float = 1.0
    reference: Optional[str] = None


def default_costs_path() -> str:
    """``pvraft_tpu_torch/_build/programs_costs.json``: where ``programs
    costs`` writes and the Trainer looks (git-ignored)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "_build", "programs_costs.json")


class CostSurface:
    """Queryable view over one ``pvraft_costs/v1`` document. Lookups
    return a :class:`CostEstimate`, or None where the inventory holds no
    record; nothing here builds or runs a program."""

    def __init__(self, doc: Dict[str, Any], path: str = "<costs>"):
        if not isinstance(doc, dict) or doc.get("schema") != COSTS_SCHEMA:
            got = (doc.get("schema") if isinstance(doc, dict)
                   else type(doc).__name__)
            raise ValueError(f"{path}: not a {COSTS_SCHEMA} document "
                             f"(schema={got!r})")
        self.path = path
        self._records: Dict[str, Dict[str, Any]] = {
            r["name"]: r for r in doc.get("programs", ())
            if isinstance(r, dict) and isinstance(r.get("name"), str)
            and r.get("ok")}
        self._serve_index: Dict[Tuple[str, int, int], str] = {}
        for name in self._records:
            m = _SERVE_RECORD_RE.match(name)
            if m:
                self._serve_index[(m.group("variant"), int(m.group("bucket")),
                                   int(m.group("bs")))] = name

    @classmethod
    def load(cls, path: Optional[str] = None) -> "CostSurface":
        """Load a document (default :func:`default_costs_path`). Raises
        OSError or ValueError on a missing or malformed file: arming the
        surface is explicit wherever it happens, so a bad path fails
        there; only the Trainer's lookup of the default degrades to
        None."""
        path = path or default_costs_path()
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f), path=path)

    def __len__(self) -> int:
        return len(self._records)

    def lookup(self, program_name: str) -> Optional[CostEstimate]:
        rec = self._records.get(program_name)
        return None if rec is None else self._estimate(rec)

    def _estimate(self, rec: Dict[str, Any]) -> CostEstimate:
        flops = float(rec.get("flops", 0.0) or 0.0)
        bytes_accessed = float(rec.get("bytes_accessed", 0.0) or 0.0)
        dtype = "bfloat16" if "bf16" in rec["name"] else "float32"
        seconds = max(flops / peak_flops_for(dtype),
                      bytes_accessed / HBM_BYTES_PER_S)
        mem = rec.get("memory") or {}
        return CostEstimate(
            name=rec["name"], target=rec.get("target", ""),
            flops=flops, bytes_accessed=bytes_accessed,
            device_seconds=seconds, basis="roofline",
            comparable=rec.get("target") != "host",
            live_bytes_estimate=mem.get("live_bytes_estimate"))

    def _variants_for(self, dtype: str) -> List[str]:
        short = SERVE_DTYPES.get(_normalize_dtype(dtype), dtype)
        return sorted({v for v, _, _ in self._serve_index
                       if v == short or v.startswith(short + "_")})

    def serve_coverage(self, dtype: str) -> List[Tuple[int, int]]:
        """The (bucket, batch) geometries with a record at ``dtype``."""
        variants = set(self._variants_for(dtype))
        return sorted({(b, bs) for v, b, bs in self._serve_index
                       if v in variants})

    def lookup_serve(self, bucket: int, batch: int,
                     dtype: str) -> Optional[CostEstimate]:
        """The exact record of one serve geometry, or None."""
        for variant in self._variants_for(dtype):
            name = self._serve_index.get((variant, int(bucket), int(batch)))
            if name is not None:
                return self._estimate(self._records[name])
        return None

    def estimate_serve(self, bucket: int, batch: int,
                       dtype: str) -> Optional[CostEstimate]:
        """One serve dispatch: the exact record, else a linear scaling in
        bucket x batch of the nearest geometry of the same dtype (by log
        ratio), flagged ``extrapolated``; None when the dtype has no
        serve record."""
        exact = self.lookup_serve(bucket, batch, dtype)
        if exact is not None:
            return exact
        covered = self.serve_coverage(dtype)
        if not covered:
            return None
        work = float(bucket) * float(batch)
        ref_bucket, ref_bs = min(
            covered,
            key=lambda gm: abs(math.log(work / (float(gm[0])
                                                * float(gm[1])))))
        base = self.lookup_serve(ref_bucket, ref_bs, dtype)
        scale = work / (float(ref_bucket) * float(ref_bs))
        return dataclasses.replace(
            base, flops=base.flops * scale,
            bytes_accessed=base.bytes_accessed * scale,
            device_seconds=base.device_seconds * scale,
            optimal_seconds=None, extrapolated=True, scale=scale,
            reference=base.name)

    def serve_seconds_per_request(self, bucket: int,
                                  dtype: str) -> Optional[float]:
        """Predicted device-seconds of one request in ``bucket``: the
        best batch size's seconds over its batch (exact records only)."""
        per_request = [
            self.lookup_serve(b, bs, dtype).device_seconds / bs
            for b, bs in self.serve_coverage(dtype) if b == int(bucket)]
        return min(per_request) if per_request else None

    def lookup_train_step(self, dtype: str) -> Optional[CostEstimate]:
        """The flagship train step's record at a compute dtype (names
        ``flagship_train_step*`` holding ``fp32`` or ``bf16``)."""
        short = SERVE_DTYPES.get(_normalize_dtype(dtype), dtype)
        names = sorted(n for n in self._records
                       if n.startswith("flagship_train_step") and short in n)
        return self.lookup(names[0]) if names else None
