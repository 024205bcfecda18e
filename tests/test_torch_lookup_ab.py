"""``python -m pvraft_tpu_torch.lookup_ab`` on the CPU: its options, the
sorting kernel's launch plan it keeps, and its refusal without a card
(the timing runs on the card)."""

import os
import subprocess
import sys

import pytest

from pvraft_tpu_torch import lookup_ab
from pvraft_tpu_torch.ops import cuda as tcuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sources_take_their_plans():
    got = lookup_ab.parse_sources(["parent=old/corr_lookup_general.cu@sort",
                                   "variant=v.cu"])
    assert got == {"parent": ("old/corr_lookup_general.cu", "sort"),
                   "variant": ("v.cu", "this"),
                   "this": (tcuda.sources()["corr_lookup_general"], "this")}


@pytest.mark.parametrize("spec,match", [
    ("old", "NAME=PATH"), ("=x.cu", "NAME=PATH"), ("old=", "NAME=PATH"),
    ("old=x.cu@tuned", "is not one of"), ("this=x.cu", "is taken"),
    ("plain=x.cu", "is taken"),
])
def test_bad_sources_are_refused(spec, match):
    with pytest.raises(ValueError, match=match):
        lookup_ab.parse_sources([spec])


# (K, knn, R) -> (sort length, points per block, shared bytes): the plan
# the sorting kernel ran on; the first four as the card read them back
# (lookup_ab's "launch" lists, PERF.md section 6).
@pytest.mark.parametrize("shape,want", [
    ((1024, 64, 3), (1024, 3, 46752)), ((1024, 0, 3), (0, 4, 29568)),
    ((510, 48, 2), (512, 4, 25888)), ((512, 32, 5), (512, 1, 37360)),
    ((40, 8, 3), (64, 4, 31616)),
])
def test_the_sort_plan_is_the_sorting_kernels(shape, want):
    assert lookup_ab.sort_plan(*shape) == want


def test_without_a_card_it_exits_2_and_builds_nothing():
    before = os.path.exists(os.path.join(tcuda.BUILD_ROOT, "ab"))
    proc = subprocess.run(
        [sys.executable, "-m", "pvraft_tpu_torch.lookup_ab",
         "--source", "parent=x.cu@sort"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr and proc.stdout == ""
    assert os.path.exists(os.path.join(tcuda.BUILD_ROOT, "ab")) == before
