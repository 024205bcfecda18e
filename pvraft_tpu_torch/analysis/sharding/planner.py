"""The pod planner: the ``pvraft_pod_plan/v1`` document for H100 meshes
(the port's own copy of ``pvraft_tpu/analysis/sharding/planner.py``: its
structure and arithmetic, over the port's inputs and the card's limits).

It answers "which (data, seq) mesh does a scene of N points train on"
from what the port already has:

* **leaves**: the port's own model, under ``weights.py``'s flax paths
  (:func:`model_leaves`), split by ``programs/partitioning.py``'s rules
  (every leaf replicates);
* **inventory**: a ``pvraft_costs/v1`` document
  (``programs/costs.py::default_costs_path()``, which phase 15 of
  ``chip_smoke.py`` writes on the card);
* **activation basis**: the ``flagship_train_step_fp32_remat`` record,
  its peak less its arguments (parameters, Adam's state, the batch) and
  outputs, which is what XLA's temp bytes count: the peak is
  ``max_memory_allocated`` less the bytes allocated when the run began
  where the record was taken on the card, else ``live_bytes_estimate``
  (``scenario.activation_source`` says which); per (batch x point) of
  the record's geometry, scaled linearly;
* **hardware**: :data:`H100`, the published H100 SXM figures (80 GB of
  HBM3 at 3.35 TB/s and 67 TFLOP/s fp32, from ``ops/kernel_bounds.py``;
  NVLink at 450 GB/s each way for one hop of a ring). NCCL across ranks
  is unverified on one card, and each ring row says so.

Per mesh: parameter and Adam bytes per device; per (mesh, scene): the
activation, the ring fold's transient at the declared chunking, the
batch arrays, the total against the card's memory, and the ring's
traffic against its compute. A cross-check holds the byte model against
the ``dp_sp_2x2_train_step`` record at that record's own mesh (one
process: 1 x 1): the remat-basis estimate must lie in (1/8, 1] of the
un-remat'd step's peak. A GS004 finding in shardcheck's scope or a
failed cross-check refuses the plan.

Keys that name the JAX package's chip name the card's limit instead:
``fits_16GiB_hbm`` is ``Hardware.fits_key`` (``fits_80GB_hbm``) and
``interconnect.ici_bytes_per_s`` is ``Hardware.link_key``
(``nvlink_bytes_per_s``); the cross-check's ``compiled_live_bytes_per_
device`` and ``model_vs_compiled_ratio`` are ``program_peak_bytes_per_
device`` and ``model_vs_peak_ratio``. Hardware, meshes and scenes are
parameters of :func:`build_plan`, so the JAX plan's own inputs give the
JAX plan's rows.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from pvraft_tpu_torch.ops.kernel_bounds import (
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    HBM_CAPACITY_BYTES,
)
from pvraft_tpu_torch.programs.geometries import (
    FLAGSHIP_BATCH,
    FLAGSHIP_POINTS,
    TINY_POINTS,
)
from pvraft_tpu_torch.programs.partitioning import (
    MESH_AXES,
    PARTITION_RULES,
    leaf_bytes,
    match_partition_rules,
    shard_factor,
)

PLAN_SCHEMA = "pvraft_pod_plan/v1"


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's limits and a ring hop's link, as the plan prices
    them. ``fits_key`` and ``link_key`` are the plan's key names for the
    memory verdict and the link rate; ``unit`` and ``unit_name`` print
    the verdict's bytes."""

    name: str
    hbm_bytes: int
    hbm_bytes_per_s: float
    peak_flops_f32: float
    link_bytes_per_s: float
    fits_key: str
    link_key: str
    unit: int
    unit_name: str
    basis: str
    comms_note: str = ""


H100 = Hardware(
    name="NVIDIA H100 SXM",
    hbm_bytes=HBM_CAPACITY_BYTES,
    hbm_bytes_per_s=HBM_BYTES_PER_S,
    peak_flops_f32=FP32_FLOPS_PER_S,
    link_bytes_per_s=450e9,
    fits_key="fits_80GB_hbm",
    link_key="nvlink_bytes_per_s",
    unit=10**9,
    unit_name="GB",
    basis="published H100 SXM figures: 80 GB HBM3 at 3.35 TB/s, 67 "
          "TFLOP/s fp32 (ops/kernel_bounds.py); NVLink 4 at 450 GB/s each "
          "way, one link per ring hop",
    comms_note="NCCL across ranks is unverified (one card)")

# Candidate (dp, sp) meshes of one 8-GPU node.
CANDIDATE_MESHES: Tuple[Tuple[int, int], ...] = (
    (1, 1), (1, 2), (2, 2), (1, 4), (2, 4), (1, 8))

# Scene sizes: the serve buckets, the flagship, the 16k long-context
# scene and the 100k stretch scene (the JAX plan's).
SCENE_POINTS: Tuple[int, ...] = (2048, 8192, 16384, 100000)

# The activation basis: the fp32 train step with remat=True.
ACTIVATION_BASIS_PROGRAM = "flagship_train_step_fp32_remat"

# The cross-check target: the sharded train step (no remat).
SHARDED_STEP_PROGRAM = "dp_sp_2x2_train_step"

# The remat-basis estimate of the sharded step must lie in this band of
# the step's own peak: above 1 the "cheaper" remat model exceeds the
# un-remat'd program (a broken model); below 1/8 something lost a
# dimension or a per-device divide.
CROSS_CHECK_BAND = (1.0 / 8.0, 1.0)

PER_DEVICE_BATCH = 1          # one scene per data row: the memory floor
ADAM_STATE_FACTOR = 2         # exp_avg + exp_avg_sq mirror the parameters
RING_CHUNK = 4096             # corr_chunk / graph_chunk of the ring fold
RING_FOLD_FACTOR = 3          # fold matrix + top-k concat + xyz planes

_F32 = 4
# Batch arrays per scene row: pc1 + pc2 + flow (3 floats each) + mask.
_BATCH_FLOATS_PER_POINT = 10


def _round(x: float, sig: int = 6) -> float:
    """Stable float rounding, so the document is byte-deterministic."""
    return float(f"{x:.{sig}g}")


def _cost_record(costs: Mapping[str, Any],
                 name: str) -> Optional[Dict[str, Any]]:
    for rec in costs.get("programs", ()):
        if isinstance(rec, dict) and rec.get("name") == name:
            return rec
    return None


def _record_geometry(costs: Mapping[str, Any]) -> Tuple[int, int]:
    """(batch, points) the inventory's train steps ran at: the
    flagship's, or at size "tiny" the tiny points."""
    points = TINY_POINTS if costs.get("size") == "tiny" else FLAGSHIP_POINTS
    return FLAGSHIP_BATCH, points


def record_peak(rec: Mapping[str, Any]) -> Tuple[int, str]:
    """A record's peak bytes with its own arguments resident, and where
    it came from: on the card ``max_memory_allocated`` less what was
    allocated when the run began, plus the arguments; elsewhere the
    counted ``live_bytes_estimate``."""
    mem = rec.get("memory") or {}
    if "max_memory_allocated" in mem:
        peak = int(mem["max_memory_allocated"])
        if "allocated_at_start" in mem:
            peak += (int(mem.get("argument_size_in_bytes", 0))
                     - int(mem["allocated_at_start"]))
        return peak, "max_memory_allocated"
    return int(mem.get("live_bytes_estimate", 0)), "live_bytes_estimate"


def activation_bytes_per_point(costs: Mapping[str, Any]
                               ) -> Tuple[float, str]:
    """The basis record's activation bytes (its peak less its arguments
    and outputs) per (batch x point), and the peak's source."""
    rec = _cost_record(costs, ACTIVATION_BASIS_PROGRAM)
    if rec is None or not rec.get("ok"):
        raise ValueError(
            f"costs document has no ok record for "
            f"{ACTIVATION_BASIS_PROGRAM!r}: count it (python -m "
            f"pvraft_tpu_torch.programs costs)")
    peak, source = record_peak(rec)
    mem = rec["memory"]
    temp = (peak - int(mem.get("argument_size_in_bytes", 0))
            - int(mem.get("output_size_in_bytes", 0)))
    if temp <= 0:
        raise ValueError(f"{ACTIVATION_BASIS_PROGRAM}: no activation bytes "
                         f"in its record ({source} {peak})")
    b, n = _record_geometry(costs)
    return temp / float(b * n), source


# --- per-device byte accounting ---------------------------------------------

def param_bytes_per_device(leaves: Sequence[Mapping[str, Any]],
                           mesh_shape: Mapping[str, int]) -> int:
    """Sum of leaf bytes / shard factor under the partition rules."""
    spec_of = match_partition_rules(
        PARTITION_RULES, [leaf["path"] for leaf in leaves])
    total = 0
    for leaf in leaves:
        factor = shard_factor(spec_of[leaf["path"]], mesh_shape)
        total += -(-leaf_bytes(leaf) // factor)  # ceil-divide
    return total


def ring_transient_bytes(points_per_device: int, chunk: int,
                         per_device_batch: int = PER_DEVICE_BATCH) -> int:
    """Fold-transient bytes of one ring step at the declared chunking:
    the (Nq_local x chunk) fold matrix plus the top-k concat and gathered
    xyz planes (RING_FOLD_FACTOR)."""
    c = min(points_per_device, chunk)
    return (per_device_batch * points_per_device * c
            * _F32 * RING_FOLD_FACTOR)


def ring_comms(points_per_device: int, sp: int, feature_dim: int,
               per_device_batch: int = PER_DEVICE_BATCH) -> Dict[str, Any]:
    """Per-step ring traffic (``parallel/ring.py``): each hop forwards
    this device's circulating chunk, ``sp - 1`` hops a ring. Two kNN
    graph rings (pc1, pc2: xyz chunks, no backward traffic) and one
    correlation ring (fmap2 + xyz2 chunks, counted twice for the shift's
    adjoint in the backward)."""
    hops = max(0, sp - 1)
    knn_hop = per_device_batch * points_per_device * 3 * _F32
    corr_hop = per_device_batch * points_per_device * \
        (feature_dim + 3) * _F32
    total = hops * (2 * knn_hop + 2 * corr_hop)
    return {
        "hops": hops,
        "knn_per_hop_bytes": knn_hop,
        "knn_rings": 2,
        "corr_per_hop_bytes": corr_hop,
        "corr_rings_fwd_bwd": 2,
        "total_bytes_per_step": total,
    }


def step_bytes(act_per_point: float, param_bytes: int, points: int,
               batch: int, chunk: int = RING_CHUNK) -> Dict[str, int]:
    """One device's bytes for a train step on ``batch`` scenes of
    ``points`` rows each: parameters, Adam's state, the activation, the
    ring fold's transient, the batch arrays and their total."""
    out = {
        "params_bytes": param_bytes,
        "optimizer_bytes": ADAM_STATE_FACTOR * param_bytes,
        "activation_bytes": int(act_per_point * batch * points),
        "ring_transient_bytes": ring_transient_bytes(points, chunk, batch),
        "batch_bytes": batch * points * _BATCH_FLOATS_PER_POINT * _F32,
    }
    out["total_bytes"] = sum(out.values())
    return out


def predict_step_bytes(plan: Mapping[str, Any], points: int, batch: int,
                       chunk: int = RING_CHUNK, dp: int = 1,
                       sp: int = 1) -> Dict[str, int]:
    """:func:`step_bytes` of one device of a (dp, sp) mesh from a plan
    document: its activation basis and that mesh's parameter bytes,
    ``points`` rows of each scene split over ``sp``."""
    row = next(m for m in plan["meshes"] if (m["dp"], m["sp"]) == (dp, sp))
    return step_bytes(plan["scenario"]["activation_bytes_per_batch_point"],
                      row["params_bytes_per_device"], points // sp, batch,
                      chunk)


# --- inputs of the port ------------------------------------------------------

def model_leaves(cfg=None) -> List[Dict[str, Any]]:
    """The port model's leaves under their flax paths (``weights.
    params_to_jax``), sorted: ``{"path", "shape", "dtype"}`` each, the
    records of ``artifacts/params_tree.json``."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.weights import params_to_jax

    model = PVRaft(cfg if cfg is not None else ModelConfig())
    out: List[Dict[str, Any]] = []

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}"
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                out.append({"path": path, "shape": list(value.shape),
                            "dtype": str(value.dtype)})

    walk(params_to_jax(model.state_dict())["params"], "params")
    return sorted(out, key=lambda leaf: leaf["path"])


def basis_remat_policy() -> str:
    """The remat policy the basis program runs (``remat=True``)."""
    from pvraft_tpu_torch.config import ModelConfig, resolve_remat_policy

    return resolve_remat_policy(ModelConfig(remat=True)) or "none"


def _feature_dim() -> int:
    from pvraft_tpu_torch.config import ModelConfig

    return int(ModelConfig().feature_dim)


def _load_costs(costs: Union[str, Mapping[str, Any], None]
                ) -> Tuple[Dict[str, Any], str]:
    if costs is None:
        from pvraft_tpu_torch.programs.costs import default_costs_path

        costs = default_costs_path()
    if isinstance(costs, str):
        with open(costs, "r", encoding="utf-8") as f:
            return json.load(f), os.path.basename(costs)
    return dict(costs), "<costs>"


# --- plan assembly ------------------------------------------------------------

def build_plan(costs: Union[str, Mapping[str, Any], None] = None,
               leaves: Optional[Sequence[Mapping[str, Any]]] = None, *,
               hardware: Hardware = H100,
               meshes: Sequence[Tuple[int, int]] = CANDIDATE_MESHES,
               scenes: Sequence[int] = SCENE_POINTS,
               feature_dim: Optional[int] = None,
               scope: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The ``pvraft_pod_plan/v1`` document. ``costs``: a costs document
    or its path (default ``default_costs_path()``); ``leaves``: leaf
    records (default :func:`model_leaves`); ``scope``: shardcheck's
    paths (default its scope). Raises ValueError on any problem: a GS004
    finding, a failed cross-check, a missing basis record."""
    from pvraft_tpu_torch.analysis.sharding.check import (
        check_paths,
        default_scope,
    )

    costs, costs_name = _load_costs(costs)
    leaves = list(leaves) if leaves is not None else model_leaves()
    feature_dim = feature_dim if feature_dim is not None else _feature_dim()

    problems: List[str] = []
    findings, _n = check_paths(list(scope or default_scope()))
    problems.extend(f"shardcheck finding: {d.format()}" for d in findings)

    try:
        act_per_bn, act_source = activation_bytes_per_point(costs)
    except ValueError as e:
        problems.append(str(e))
        act_per_bn, act_source = 0.0, ""
    basis_b, basis_n = _record_geometry(costs)
    basis = _cost_record(costs, ACTIVATION_BASIS_PROGRAM) or {}
    flops_basis = float(basis.get("flops", 0.0) or 0.0)
    unit = f"{hardware.unit_name}"

    rows: List[Dict[str, Any]] = []
    for dp, sp in meshes:
        pbytes = param_bytes_per_device(leaves, {"data": dp, "seq": sp})
        rec: Dict[str, Any] = {
            "dp": dp,
            "sp": sp,
            "devices": dp * sp,
            "global_batch": PER_DEVICE_BATCH * dp,
            "params_bytes_per_device": pbytes,
            "optimizer_bytes_per_device": ADAM_STATE_FACTOR * pbytes,
            "scenes": [],
        }
        for n_points in scenes:
            if n_points % sp:
                rec["scenes"].append({
                    "n_points": n_points,
                    hardware.fits_key: False,
                    "verdict": f"seq axis {sp} does not divide "
                               f"{n_points} points",
                })
                continue
            pts = n_points // sp
            b = step_bytes(act_per_bn, pbytes, pts, PER_DEVICE_BATCH)
            total = b["total_bytes"]
            fits = total <= hardware.hbm_bytes
            comms = ring_comms(pts, sp, feature_dim)
            flops_per_device = 0.0
            if flops_basis:
                scale = (PER_DEVICE_BATCH * dp * n_points) / float(
                    basis_b * basis_n)
                flops_per_device = flops_basis * scale / (dp * sp)
            compute_s = (flops_per_device / hardware.peak_flops_f32
                         if flops_per_device else 0.0)
            comm_s = comms["total_bytes_per_step"] / hardware.link_bytes_per_s
            ring = dict(comms, **{
                "comm_seconds_per_step": _round(comm_s),
                "compute_seconds_per_step": _round(compute_s),
                "comm_compute_ratio": _round(
                    comm_s / compute_s if compute_s else 0.0),
            })
            if hardware.comms_note:
                ring["note"] = hardware.comms_note
            rec["scenes"].append({
                "n_points": n_points,
                "points_per_device": pts,
                "activation_bytes": b["activation_bytes"],
                "ring_transient_bytes": b["ring_transient_bytes"],
                "batch_bytes": b["batch_bytes"],
                "total_bytes_per_device": total,
                hardware.fits_key: fits,
                "ring": ring,
                "verdict": (
                    f"{total / hardware.unit:.2f} {unit} of "
                    f"{hardware.hbm_bytes / hardware.unit:.0f} {unit} per "
                    f"device — " + ("fits" if fits else "does NOT fit")),
            })
        rows.append(rec)

    # The byte model against the sharded step's own record, at the mesh
    # that record ran on.
    cross: Dict[str, Any] = {"program": SHARDED_STEP_PROGRAM}
    ds = _cost_record(costs, SHARDED_STEP_PROGRAM)
    if ds is None or not ds.get("ok"):
        problems.append(
            f"costs document has no ok record for {SHARDED_STEP_PROGRAM!r}: "
            f"cross-check impossible")
    elif act_per_bn:
        mesh = ds.get("mesh") or {"data": 2, "seq": 2}
        dp, sp = int(mesh["data"]), int(mesh["seq"])
        peak, peak_source = record_peak(ds)
        b_loc, pts = max(1, basis_b // dp), basis_n // sp
        pbytes = param_bytes_per_device(leaves, {"data": dp, "seq": sp})
        model_total = step_bytes(act_per_bn, pbytes, pts, b_loc)[
            "total_bytes"]
        ratio = model_total / peak if peak else float("inf")
        lo, hi = CROSS_CHECK_BAND
        cross.update({
            "mesh": {"data": dp, "seq": sp},
            "program_peak_bytes_per_device": peak,
            "peak_source": peak_source,
            "model_bytes_per_device": model_total,
            "model_vs_peak_ratio": _round(ratio),
            "band": [lo, hi],
            "note": ("the record is the step without remat; the "
                     "remat-basis model must come in below it but not "
                     "vanish: outside the band the byte model has "
                     "diverged from the real program"),
        })
        if not (lo <= ratio <= hi):
            problems.append(
                f"{SHARDED_STEP_PROGRAM}: model estimate {model_total} B "
                f"vs the program's peak {peak} B: ratio {ratio:.3f} outside "
                f"the [{lo:g}, {hi:g}] band; the byte model has diverged "
                f"from the real sharded program")

    if problems:
        raise ValueError("pod plan cannot be built:\n  "
                         + "\n  ".join(problems))

    verdicts: Dict[str, str] = {}
    for n_points in scenes:
        fitting = [f"{m['dp']}x{m['sp']}" for m in rows
                   if any(s["n_points"] == n_points
                          and s.get(hardware.fits_key) for s in m["scenes"])]
        verdicts[str(n_points)] = (
            f"fits per-device on: {', '.join(fitting)}" if fitting
            else "fits NO candidate mesh — a bigger seq axis or a "
                 "smaller ring chunk is required")

    n_params = sum(math.prod(leaf["shape"]) for leaf in leaves)
    return {
        "schema": PLAN_SCHEMA,
        "hardware": hardware.name,
        "topology": costs.get("topology"),
        "costs_artifact": costs_name,
        "params_artifact": "the port's model (weights.params_to_jax paths)",
        "declared_axes": sorted(MESH_AXES),
        "partition_rules": [[pat, list(spec)]
                            for pat, spec in PARTITION_RULES],
        "params": {
            "leaves": len(leaves),
            "total_parameters": n_params,
            "total_bytes": sum(leaf_bytes(leaf) for leaf in leaves),
        },
        "scenario": {
            "per_device_batch": PER_DEVICE_BATCH,
            "remat_policy": basis_remat_policy(),
            "activation_basis": ACTIVATION_BASIS_PROGRAM,
            "activation_source": act_source,
            "activation_basis_geometry": [basis_b, basis_n],
            "activation_bytes_per_batch_point": _round(act_per_bn),
            "ring_chunk": RING_CHUNK,
            "ring_fold_factor": RING_FOLD_FACTOR,
            "adam_state_factor": ADAM_STATE_FACTOR,
            "feature_dim": feature_dim,
        },
        "interconnect": {
            hardware.link_key: hardware.link_bytes_per_s,
            "peak_flops_f32": hardware.peak_flops_f32,
            "hbm_bytes_per_s": hardware.hbm_bytes_per_s,
            "basis": hardware.basis,
            **({"note": hardware.comms_note} if hardware.comms_note else {}),
        },
        "hbm_limit_bytes": hardware.hbm_bytes,
        "meshes": rows,
        "sharded_step_cross_check": cross,
        "scene_verdicts": verdicts,
    }


def largest_fitting_scene(plan: Mapping[str, Any]) -> Optional[int]:
    """The most points of any scene the plan says fits one card (the
    1 x 1 mesh)."""
    row = next(m for m in plan["meshes"] if (m["dp"], m["sp"]) == (1, 1))
    fit = [s["n_points"] for s in row["scenes"] if s.get(H100.fits_key)]
    return max(fit) if fit else None


def default_plan_path() -> str:
    """``pvraft_tpu_torch/_build/pod_plan.json`` (git-ignored)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "_build", "pod_plan.json")


def write_plan(plan: Mapping[str, Any], out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(plan, f, indent=1, sort_keys=True)
        f.write("\n")


def check_plan_file(path: str, costs: Union[str, Mapping[str, Any], None]
                    = None) -> List[str]:
    """Rebuild the plan from ``costs`` and the port's model and compare
    it with the one at ``path``. Returns problems ([] = up to date)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            saved = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable: {e}"]
    if not isinstance(saved, dict):
        return [f"{path}: document is {type(saved).__name__}, not a "
                f"{PLAN_SCHEMA} object"]
    try:
        fresh = build_plan(costs)
    except (OSError, ValueError) as e:
        return [f"{path}: cannot rebuild the plan: {e}"]
    if saved != fresh:
        drift = [k for k in sorted(set(saved) | set(fresh))
                 if saved.get(k) != fresh.get(k)]
        return [f"{path}: the plan drifted from the rebuilt one (differing "
                f"keys: {', '.join(drift)}); rebuild it: python -m "
                f"pvraft_tpu_torch.analysis sharding --plan --out {path}"]
    return []


# --- the card's side ----------------------------------------------------------

def basis_inventory(device=None) -> Dict[str, Any]:
    """A ``pvraft_costs/v1`` document of the two programs the plan reads
    (the activation basis and the sharded step), counted on ``device``
    (the card unless another device is named; "tiny" on the CPU)."""
    from pvraft_tpu_torch.device import resolve_device
    from pvraft_tpu_torch.programs import load_catalog, specs
    from pvraft_tpu_torch.programs.costs import run_costs

    dev = resolve_device(device)
    load_catalog()
    catalog = specs()
    return run_costs([catalog[ACTIVATION_BASIS_PROGRAM],
                      catalog[SHARDED_STEP_PROGRAM]], dev,
                     "flagship" if dev.type == "cuda" else "tiny")


def fold_chunk(points: int, chunk: int = RING_CHUNK) -> int:
    """The chunk a run can stream ``points`` rows in: the largest divisor
    of ``points`` up to ``chunk`` (the chunked kNN and ``corr_init``
    take only a chunk that divides the cloud; 4,000 at 100,000 points)."""
    return next(c for c in range(min(chunk, points), 0, -1)
                if points % c == 0)


def measure_step_peak(points: int, batch: int = PER_DEVICE_BATCH,
                      chunk: Optional[int] = None, device=None,
                      seed: int = 0,
                      cfg_overrides: Optional[Mapping[str, Any]] = None
                      ) -> Dict[str, Any]:
    """One eager stage-1 train step with remat (the basis's policy) and
    ``corr_chunk``/``graph_chunk`` ``chunk`` (default
    :func:`fold_chunk`) on ``batch`` synthetic scenes of ``points``
    rows, seeded weights, Adam at lr 0, on
    ``device`` (the card unless another device is named): its loss and,
    on the card, ``max_memory_allocated`` and the bytes allocated when it
    began. ``cfg_overrides`` changes ModelConfig fields (the tests' tiny
    widths)."""
    import time

    import torch

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import (PrefetchLoader, SyntheticDataset,
                                       first_batch, to_device)
    from pvraft_tpu_torch.device import resolve_device
    from pvraft_tpu_torch.engine.steps import make_train_step
    from pvraft_tpu_torch.models import PVRaft
    from pvraft_tpu_torch.weights import seeded_state_dict

    dev = resolve_device(device)
    chunk = chunk or fold_chunk(points)
    cfg = ModelConfig(**{"corr_chunk": chunk, "graph_chunk": chunk,
                         "remat": True, **dict(cfg_overrides or {})})
    model = PVRaft(cfg)
    model.load_state_dict(seeded_state_dict(cfg, seed))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.0)
    step = make_train_step(model, opt, lambda _: 0.0, 0.8, 8)
    ds = SyntheticDataset(size=batch, nb_points=points, noise=0.01,
                          seed=seed, n_objects=4)
    data = to_device(first_batch(PrefetchLoader(ds, batch, num_workers=0)),
                     dev)
    out: Dict[str, Any] = {"points": points, "batch": batch, "chunk": chunk,
                           "remat_policy": basis_remat_policy(),
                           "device": str(dev)}
    card = dev.type == "cuda"
    if card:
        torch.cuda.synchronize(dev)
        out["allocated_at_start"] = int(torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out["loss"] = float(step(data)["loss"])
    if card:
        torch.cuda.synchronize(dev)
        out["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(dev))
    out["step_s"] = time.perf_counter() - t0
    return out
