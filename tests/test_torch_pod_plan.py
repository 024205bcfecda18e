"""The port's pod planner (``pvraft_tpu_torch/analysis/sharding/
planner.py``) against the JAX package's: the same byte and traffic
arithmetic on the same leaves, meshes and scenes; JAX's committed plan
(``artifacts/pod_plan.json``) rebuilt exactly from JAX's committed
inputs and constants; the port's own leaves equal to the committed leaf
inventory. Then an H100 plan from a small inventory counted here on the
CPU: rows that grow with the points and shrink with the seq axis, the
refusals (a failed cross-check, a GS004 finding), the CLI and the remat
step it measures."""

import copy
import json
import math
import os

import pytest

from pvraft_tpu.analysis.kernels.planner import (
    HBM_BYTES_PER_S as JAX_HBM_BYTES_PER_S,
    PEAK_FLOPS_F32 as JAX_PEAK_FLOPS_F32,
)
from pvraft_tpu.analysis.sharding import planner as jax_planner
from pvraft_tpu.programs.geometries import HBM_BYTES as JAX_HBM_BYTES
from pvraft_tpu_torch.analysis.sharding import planner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_COSTS = os.path.join(REPO, "artifacts", "programs_costs.json")
JAX_PLAN = os.path.join(REPO, "artifacts", "pod_plan.json")
JAX_PARAMS = os.path.join(REPO, "artifacts", "params_tree.json")
RED = os.path.join(REPO, "tests", "fixtures", "shardcheck",
                   "gs004_unguarded_io_red.py")


def _jax_leaves():
    with open(JAX_PARAMS, encoding="utf-8") as f:
        return json.load(f)["leaves"]


def _jax_plan():
    with open(JAX_PLAN, encoding="utf-8") as f:
        return json.load(f)


V5E = planner.Hardware(
    name="TPU v5e", hbm_bytes=JAX_HBM_BYTES,
    hbm_bytes_per_s=JAX_HBM_BYTES_PER_S, peak_flops_f32=JAX_PEAK_FLOPS_F32,
    link_bytes_per_s=jax_planner.ICI_BYTES_PER_S, fits_key="fits_16GiB_hbm",
    link_key="ici_bytes_per_s", unit=2**30, unit_name="GiB",
    basis="public TPU v5e specs (one ICI link per ring hop)")

MESHES = sorted(set(planner.CANDIDATE_MESHES)
                | set(jax_planner.CANDIDATE_MESHES))


# --- the arithmetic against JAX's -------------------------------------------

@pytest.mark.parametrize("dp, sp", MESHES)
def test_param_bytes_equal_jaxs(dp, sp):
    leaves = _jax_leaves()
    mesh = {"data": dp, "seq": sp}
    assert planner.param_bytes_per_device(leaves, mesh) == \
        jax_planner.param_bytes_per_device(leaves, mesh)


@pytest.mark.parametrize("n_points", planner.SCENE_POINTS)
def test_ring_bytes_and_traffic_equal_jaxs(n_points):
    for _, sp in MESHES:
        pts = n_points // sp
        for chunk in (1024, planner.RING_CHUNK, 8192):
            assert planner.ring_transient_bytes(pts, chunk) == \
                jax_planner.ring_transient_bytes(pts, chunk)
            assert planner.ring_transient_bytes(pts, chunk, 2) == \
                jax_planner.ring_transient_bytes(pts, chunk, 2)
        assert planner.ring_comms(pts, sp, 128) == \
            jax_planner.ring_comms(pts, sp, 128)


def test_jax_inputs_rebuild_the_committed_plan():
    """JAX's costs, leaves, ladder and chip give JAX's committed plan:
    its rows, its verdicts and its cross-check ratio."""
    want = _jax_plan()
    got = planner.build_plan(
        JAX_COSTS, _jax_leaves(), hardware=V5E,
        meshes=jax_planner.CANDIDATE_MESHES,
        scenes=jax_planner.SCENE_POINTS, feature_dim=128)
    assert got["meshes"] == want["meshes"]
    assert got["scene_verdicts"] == want["scene_verdicts"]
    assert got["sharded_step_cross_check"]["model_vs_peak_ratio"] == \
        want["sharded_step_cross_check"]["model_vs_compiled_ratio"]
    assert got["sharded_step_cross_check"]["model_bytes_per_device"] == \
        want["sharded_step_cross_check"]["model_bytes_per_device"]
    assert got["scenario"]["activation_bytes_per_batch_point"] == \
        want["scenario"]["activation_bytes_per_batch_point"]
    # JAX's document labels its remat=True basis "dots"; the basis runs
    # remat=True, which is the "full" policy.
    assert want["scenario"]["remat_policy"] == "dots"
    assert got["scenario"]["remat_policy"] == "full"


def test_the_ports_leaves_are_the_committed_inventory():
    mine = planner.model_leaves()
    want = [{k: leaf[k] for k in ("path", "shape", "dtype")}
            for leaf in _jax_leaves()]
    assert mine == want
    assert sum(math.prod(leaf["shape"]) for leaf in mine) == 192034


# --- an H100 plan from an inventory counted here ---------------------------

@pytest.fixture(scope="module")
def costs():
    """The plan's two programs counted on the CPU at size "tiny"."""
    return planner.basis_inventory("cpu")


@pytest.fixture(scope="module")
def plan(costs):
    return planner.build_plan(costs)


def test_the_inventory_holds_the_basis_and_the_sharded_step(costs):
    recs = {r["name"]: r for r in costs["programs"]}
    assert set(recs) == {planner.ACTIVATION_BASIS_PROGRAM,
                         planner.SHARDED_STEP_PROGRAM}
    assert all(r["ok"] for r in recs.values())
    assert recs[planner.SHARDED_STEP_PROGRAM]["mesh"] == {"data": 1,
                                                          "seq": 1}
    assert "mesh" not in recs[planner.ACTIVATION_BASIS_PROGRAM]


def test_h100_plan_rows(plan):
    assert plan["schema"] == planner.PLAN_SCHEMA
    assert plan["hbm_limit_bytes"] == 80 * 10**9
    assert plan["interconnect"]["nvlink_bytes_per_s"] == 450e9
    assert "unverified" in plan["interconnect"]["note"]
    assert plan["scenario"]["remat_policy"] == "full"
    assert plan["scenario"]["activation_source"] == "live_bytes_estimate"
    assert plan["params"] == {"leaves": 95, "total_parameters": 192034,
                              "total_bytes": 4 * 192034}
    assert [(m["dp"], m["sp"]) for m in plan["meshes"]] == list(
        planner.CANDIDATE_MESHES)
    by_mesh = {(m["dp"], m["sp"]): m for m in plan["meshes"]}
    for (dp, sp), row in by_mesh.items():
        totals = [s["total_bytes_per_device"] for s in row["scenes"]]
        assert totals == sorted(totals) and len(set(totals)) == len(totals)
        for s in row["scenes"]:
            assert isinstance(s["fits_80GB_hbm"], bool)
            assert "fits_16GiB_hbm" not in s
            assert s["ring"]["hops"] == sp - 1
            assert "unverified" in s["ring"]["note"]
            assert s["verdict"].endswith(
                "fits" if s["fits_80GB_hbm"] else "does NOT fit")
            assert " GB of 80 GB per device" in s["verdict"]
    for dp in (1, 2):
        for n in planner.SCENE_POINTS:
            row = [by_mesh[(dp, sp)]["scenes"][planner.SCENE_POINTS.index(n)]
                   ["total_bytes_per_device"]
                   for sp in (1, 2, 4, 8) if (dp, sp) in by_mesh]
            assert row == sorted(row, reverse=True), (dp, n, row)
    assert set(plan["scene_verdicts"]) == {str(n)
                                           for n in planner.SCENE_POINTS}
    lo, hi = planner.CROSS_CHECK_BAND
    assert lo <= plan["sharded_step_cross_check"]["model_vs_peak_ratio"] \
        <= hi


def test_prediction_equals_the_rows(plan):
    for m in plan["meshes"]:
        for s in m["scenes"]:
            got = planner.predict_step_bytes(plan, s["n_points"], 1,
                                             dp=m["dp"], sp=m["sp"])
            # The plan's basis is rounded to 6 significant digits.
            assert got["total_bytes"] == pytest.approx(
                s["total_bytes_per_device"], rel=1e-5)
    assert planner.largest_fitting_scene(plan) == max(
        s["n_points"] for s in plan["meshes"][0]["scenes"]
        if s["fits_80GB_hbm"])


def test_a_failed_cross_check_refuses_the_plan(costs):
    bad = copy.deepcopy(costs)
    for r in bad["programs"]:
        if r["name"] == planner.SHARDED_STEP_PROGRAM:
            r["memory"]["live_bytes_estimate"] //= 100
    with pytest.raises(ValueError, match="outside the"):
        planner.build_plan(bad)


def test_a_gs004_finding_refuses_the_plan(costs):
    with pytest.raises(ValueError, match="shardcheck finding"):
        planner.build_plan(costs, scope=[RED])


def test_a_missing_basis_refuses_the_plan(costs):
    bad = copy.deepcopy(costs)
    bad["programs"] = [r for r in bad["programs"]
                       if r["name"] != planner.ACTIVATION_BASIS_PROGRAM]
    with pytest.raises(ValueError, match="no ok record"):
        planner.build_plan(bad)


def test_card_records_subtract_what_was_allocated_before(costs):
    """A record taken on the card: the peak is max_memory_allocated less
    the bytes the process held when the run began, plus the run's own
    arguments."""
    rec = copy.deepcopy(costs["programs"][0])
    rec["memory"].update(max_memory_allocated=10_000_000,
                         allocated_at_start=4_000_000,
                         argument_size_in_bytes=3_000_000)
    assert planner.record_peak(rec) == (9_000_000, "max_memory_allocated")


def test_cli_plan_out_and_check(tmp_path, costs, capsys):
    from pvraft_tpu_torch.analysis.__main__ import main

    costs_path, out = tmp_path / "costs.json", tmp_path / "plan.json"
    costs_path.write_text(json.dumps(costs))
    assert main(["sharding", "--plan", "--costs", str(costs_path),
                 "--out", str(out)]) == 0
    assert "[pod] 100000 points: fits per-device on:" in \
        capsys.readouterr().err
    assert main(["sharding", "--plan", "--costs", str(costs_path),
                 "--check", str(out)]) == 0
    saved = json.loads(out.read_text())
    saved["scene_verdicts"]["2048"] = "edited"
    out.write_text(json.dumps(saved))
    assert main(["sharding", "--plan", "--costs", str(costs_path),
                 "--check", str(out)]) == 1
    assert "scene_verdicts" in capsys.readouterr().err


@pytest.mark.parametrize("points, chunk", [
    (100000, 4000), (16384, 4096), (8192, 4096), (2048, 2048), (96, 96)])
def test_fold_chunk_divides_the_cloud(points, chunk):
    assert planner.fold_chunk(points) == chunk


def test_the_remat_step_it_measures_runs():
    got = planner.measure_step_peak(
        64, batch=1, chunk=32, device="cpu",
        cfg_overrides={"truncate_k": 16, "corr_knn": 8, "graph_k": 8})
    assert got["remat_policy"] == "full" and got["points"] == 64
    assert got["loss"] == got["loss"] and "max_memory_allocated" not in got


def test_the_catalog_registers_the_basis():
    from pvraft_tpu_torch.programs import load_catalog, specs

    load_catalog()
    spec = specs()[planner.ACTIVATION_BASIS_PROGRAM]
    assert set(spec.tags) == {"flagship", "train"}
    assert spec.determinism and spec.geometry["lookup"]["n"] == 8192
