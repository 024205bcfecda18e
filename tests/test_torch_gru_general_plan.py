"""The general float32 GRU kernel's launch plan (``ops/cuda/gru_iter.py::
general_gru_plan``), on the CPU (the kernel runs on the card:
``tests/test_torch_cuda.py``).

Every width the kernel took before it moved to the tensor cores (its FMA
body's formula, kept in ``gru_ab.v7_plan``) is taken, within the shared memory a
block can have; the widths the models run (every hidden + context = 128 at
correlation width 64, the context encoder's split, and widths 32, 96 and
128) take a tensor-core mode. The C entry point checks a launch against
the formulas of its ``PLAN`` block (``csrc/gru_iter_general.cu``), which is
plain C++: it is compiled here with the host compiler and held against
the Python formulas over a grid of widths, modes and block sizes.
"""

import ctypes
import itertools
import re
import shutil
import subprocess

import pytest

from pvraft_tpu_torch.gru_ab import v7_plan
from pvraft_tpu_torch.ops import cuda as tcuda
from pvraft_tpu_torch.ops.cuda import gru_iter as gr

TENSOR_CORES = ("resident", "ring")
# Widths the FMA body's plan reached, its extremes among them: C up to ~7,200
# at H = 1, H up to ~1,000.
EXTREMES = [(1, 7200, 1), (1000, 16, 16), (512, 512, 512), (7, 3, 1),
            (200, 64, 64), (256, 256, 64), (129, 128, 64), (1, 1, 1),
            (128, 2000, 64), (64, 64, 3000), (960, 1, 1), (33, 50, 37)]
GRID = sorted(set(itertools.product(
    (1, 3, 8, 17, 32, 33, 48, 64, 96, 120, 127, 128, 129, 200, 384),
    (1, 7, 32, 50, 96, 128, 300, 1000),
    (1, 8, 37, 64, 128, 500))))


@pytest.mark.parametrize("h,c,f", EXTREMES)
def test_every_width_the_v7_plan_took_is_taken(h, c, f):
    v7_plan(h, c, f)                        # the old plan took it
    plan = gr.general_gru_plan(h, c, f)
    assert plan.mode in gr.GENERAL_MODES
    assert 0 < plan.smem <= tcuda.SMEM_MAX
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert gr.general_gru_need(plan.mode, plan.rows, h, c, f) == (
        plan.smem, plan.threads, plan.chunk)
    assert plan.launch == (gr.GENERAL_MODES.index(plan.mode), plan.rows,
                           plan.smem)
    if plan.mode == "fma":
        # No tensor-core layout fits; the FMA body keeps the old shape.
        assert all(gr.general_gru_need(m, r, h, c, f) is None
                   or gr.general_gru_need(m, r, h, c, f)[0] > tcuda.SMEM_MAX
                   for m in TENSOR_CORES for r in (32, 64))
        groups, threads, smem = v7_plan(h, c, f)
        assert (plan.rows, plan.threads, plan.smem) == (8 * groups, threads,
                                                        smem)


def test_the_whole_grid_the_v7_plan_took_is_taken():
    taken = 0
    for h, c, f in GRID:
        try:
            v7_plan(h, c, f)
        except ValueError:
            with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
                gr.general_gru_plan(h, c, f)
            continue
        assert gr.general_gru_plan(h, c, f).smem <= tcuda.SMEM_MAX
        taken += 1
    assert taken > 0.9 * len(GRID)


def test_every_context_encoder_split_takes_the_tensor_cores():
    """The context encoder's 128 channels split into hidden + context."""
    for hidden in range(1, 128):
        plan = gr.general_gru_plan(hidden, 128 - hidden, 64)
        assert plan.mode in TENSOR_CORES and plan.rows in (32, 64), hidden


@pytest.mark.parametrize("h,c,f,want", [
    (32, 32, 64, ("resident", 64, 256, 0)),
    (96, 96, 64, ("ring", 32, 384, 40)),
    (128, 128, 64, ("ring", 32, 512, 24)),
    (32, 96, 64, ("resident", 64, 256, 0)),
    (96, 32, 64, ("ring", 32, 384, 48)),
    (48, 80, 64, ("resident", 64, 384, 0)),
    (33, 50, 37, ("resident", 64, 320, 0)),
    (64, 64, 64, ("ring", 64, 512, 56)),
])
def test_the_widths_the_models_run(h, c, f, want):
    plan = gr.general_gru_plan(h, c, f)
    assert (plan.mode, plan.rows, plan.threads, plan.chunk) == want


def test_a_mode_can_be_asked_for_and_an_unknown_one_is_refused():
    ring = gr.general_gru_plan(32, 96, 64, "ring")
    assert (ring.mode, ring.rows, ring.chunk) == ("ring", 64, 64)
    assert ring.smem < gr.general_gru_plan(32, 96, 64).smem
    fma = gr.general_gru_plan(32, 96, 64, "fma")
    assert fma.launch == (0, 8 * v7_plan(32, 96, 64)[0], v7_plan(32, 96, 64)[2])
    with pytest.raises(ValueError, match="is not one of"):
        gr.general_gru_plan(32, 96, 64, "tuned")
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gr.general_gru_plan(200, 64, 64, "resident")
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gr.general_gru_plan(2048, 64, 64)
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gr.general_gru_plan(64, 0, 64)


def _plan_block() -> str:
    with open(tcuda.sources()["gru_iter_general"]) as fh:
        src = fh.read()
    got = re.search(r"// BEGIN PLAN.*?\n(.*)// END PLAN", src, re.S)
    assert got, "gru_iter_general.cu has no PLAN block"
    return got.group(1)


@pytest.fixture(scope="module")
def c_need(tmp_path_factory):
    """``plan::need`` of the kernel source, built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("gru_plan")
    (d / "plan.cc").write_text(
        "#define PLAN_FN inline\n" + _plan_block() +
        'extern "C" long long plan_need(int mode, int rows, int h, int c,\n'
        "    int f, int* threads, int* chunk) {\n"
        "  return plan::need(mode, rows, h, c, f, threads, chunk);\n}\n")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(d / "libplan.so"), str(d / "plan.cc")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.plan_need.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.plan_need.restype = ctypes.c_longlong

    def need(mode, rows, h, c, f):
        threads, chunk = ctypes.c_int(), ctypes.c_int()
        got = lib.plan_need(mode, rows, h, c, f, ctypes.byref(threads),
                            ctypes.byref(chunk))
        return None if got < 0 else (got, threads.value, chunk.value)

    return need


@pytest.mark.parametrize("mode", gr.GENERAL_MODES)
def test_the_c_entry_checks_the_same_formulas(c_need, mode):
    code = gr.GENERAL_MODES.index(mode)
    for (h, c, f), rows in itertools.product(EXTREMES + GRID,
                                             (8, 16, 24, 32, 64, 65)):
        assert c_need(code, rows, h, c, f) == gr.general_gru_need(
            mode, rows, h, c, f), (mode, rows, h, c, f)
    assert c_need(7, 64, 32, 96, 64) is None
    assert c_need(code, 64, 0, 96, 64) is None


def test_the_c_entry_takes_every_plan(c_need):
    for h, c, f in EXTREMES + GRID:
        try:
            plan = gr.general_gru_plan(h, c, f)
        except ValueError:
            continue
        smem, threads, chunk = c_need(*plan.launch[:2], h, c, f)
        assert smem <= plan.smem <= tcuda.SMEM_MAX
        assert (threads, chunk) == (plan.threads, plan.chunk)
