"""The launch plan of every kernel over the program catalog fits what one
Hopper block may have: for each ``kernel`` spec and each serve, train
and profile geometry of ``programs/catalog.py`` (``ProgramSpec.
geometry``), the plan the wrapper takes there (the tuned kernels' fixed
launches, read from their sources; ``general_lookup_plan``,
``general_gru_plan``, ``bf16_gru_plan``) keeps the dynamic shared memory
within ``SMEM_MAX``, the threads of a block within 1,024 and the grid
within the x dimension's range. A new spec is checked without a new
test. Plans only: nothing is built or launched.
"""

import os
import re

import pytest

from pvraft_tpu_torch.ops import cuda as kcuda
from pvraft_tpu_torch.ops.cuda.corr_lookup import general_lookup_plan
from pvraft_tpu_torch.ops.cuda.gru_iter import bf16_gru_plan, general_gru_plan
from pvraft_tpu_torch.programs import load_catalog, specs

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pvraft_tpu_torch", "csrc")
MAX_THREADS = 1024
MAX_GRID_X = 2**31 - 1
H100_SMS = 132

load_catalog()
CASES = [(s.name, kind) for s in specs().values() for kind in s.geometry]


def _constant(source: str, name: str) -> int:
    with open(os.path.join(CSRC, source), encoding="utf-8") as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{source}: no constexpr {name}"
    return int(m.group(1))


def _tuned_gru_smem() -> int:
    """kSmemBytes of csrc/gru_iter.cu, from its constants."""
    h, f, tile = (_constant("gru_iter.cu", k) for k in ("kH", "kF", "kTile"))
    act = 4 * tile * (2 * h + 8) + tile * (2 * f + 8)
    slots = _constant("gru_iter.cu", "kStages") * 32 * (3 * h + 8)
    return 4 * (act + slots)


def _plan(kind, geo):
    """(grid x, threads, dynamic shared memory bytes) of the launch."""
    rows = geo["b"] * geo["n"]
    if kind in ("lookup", "voxel"):
        knn = geo.get("knn", 0)
        if kcuda.lookup_variant(geo["k"], knn, geo["resolution"]) == "tuned":
            source = "corr_lookup.cu" if kind == "lookup" else "voxel_corr.cu"
            warps = _constant(source, "kWarpsPerBlock")
            return -(-rows // warps), 32 * warps, 0
        plan = general_lookup_plan(geo["k"], knn, geo["resolution"],
                                   geo["levels"])
        assert plan.resident >= 1
        return -(-rows // plan.warps), 32 * plan.warps, plan.smem
    h, c, f = geo["hidden"], geo["context"], geo["corr"]
    variant = kcuda.gru_variant(h, c, f, geo["dtype"])
    if variant == "bf16":
        blocks, threads, smem, _ = bf16_gru_plan(h, c, f, rows, H100_SMS)
        return blocks, threads, smem
    if variant == "tuned":
        return (-(-rows // _constant("gru_iter.cu", "kTile")),
                32 * _constant("gru_iter.cu", "kWarps"), _tuned_gru_smem())
    plan = general_gru_plan(h, c, f)
    return -(-rows // plan.rows), plan.threads, plan.smem


def test_the_catalog_declares_launch_geometries():
    kinds = {kind for _, kind in CASES}
    assert kinds == {"lookup", "voxel", "gru"}
    assert len(CASES) >= len(specs()) - 2     # the encoder rungs have none


@pytest.mark.parametrize("name, kind", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_launch_fits_a_hopper_block(name, kind):
    geo = specs()[name].geometry[kind]
    grid, threads, smem = _plan(kind, geo)
    assert 1 <= grid <= MAX_GRID_X, (name, grid)
    assert 32 <= threads <= MAX_THREADS and threads % 32 == 0, (name, threads)
    assert 0 <= smem <= kcuda.SMEM_MAX, (name, smem)


def test_tuned_gru_shared_memory_is_the_documented_one():
    assert _tuned_gru_smem() == 222208 <= kcuda.SMEM_MAX
