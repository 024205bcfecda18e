"""``python -m pvraft_tpu_torch.gru_ab`` on the CPU: its options and its
refusal without a card (the timing runs on the card)."""

import os
import subprocess
import sys

import pytest

from pvraft_tpu_torch import gru_ab
from pvraft_tpu_torch.ops import cuda as tcuda
from pvraft_tpu_torch.ops.cuda import gru_iter as gr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_bf16_entry_takes_sources_with_their_plans():
    got = gru_ab.parse_sources(["parent=old/gru_iter_bf16.cu@general",
                                "variant=v.cu"], "bf16")
    assert got == {"parent": ("old/gru_iter_bf16.cu", "general"),
                   "variant": ("v.cu", "bf16"),
                   "this": (tcuda.sources()["gru_iter_bf16"], "bf16")}
    assert gru_ab.ENTRIES["bf16"][0] == "pvraft_gru_update_bf16"


def test_the_fp32_entry_is_the_default_and_takes_no_plan():
    got = gru_ab.parse_sources(["old=a/gru_iter.cu"], "fp32")
    assert got == {"old": ("a/gru_iter.cu", ""),
                   "this": (tcuda.sources()["gru_iter"], "")}
    with pytest.raises(ValueError, match="takes no plan"):
        gru_ab.parse_sources(["old=a/gru_iter.cu@bf16"], "fp32")


@pytest.mark.parametrize("spec,match", [
    ("old", "NAME=PATH"), ("=x.cu", "NAME=PATH"), ("old=", "NAME=PATH"),
    ("old=x.cu@tuned", "is not one of"), ("this=x.cu", "is taken"),
])
def test_bad_sources_are_refused(spec, match):
    with pytest.raises(ValueError, match=match):
        gru_ab.parse_sources([spec], "bf16")


def test_without_a_card_it_exits_2_and_builds_nothing():
    before = os.path.exists(os.path.join(tcuda.BUILD_ROOT, "ab"))
    proc = subprocess.run(
        [sys.executable, "-m", "pvraft_tpu_torch.gru_ab", "--entry", "bf16",
         "--source", "parent=x.cu@general"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr and proc.stdout == ""
    assert os.path.exists(os.path.join(tcuda.BUILD_ROOT, "ab")) == before
    with pytest.raises(SystemExit):
        gru_ab.main(["--entry", "int8"])


def test_the_general_entry_takes_the_modes_and_the_v7_plan():
    got = gru_ab.parse_sources(["parent=old/gru_iter_general.cu@v7",
                                "ring=v.cu@ring", "x=y.cu"], "general")
    assert got == {"parent": ("old/gru_iter_general.cu", "v7"),
                   "ring": ("v.cu", "ring"), "x": ("y.cu", "general"),
                   "this": (tcuda.sources()["gru_iter_general"], "general")}
    assert gru_ab.ENTRIES["general"] == ("pvraft_gru_update_general",
                                         "gru_iter_general", 7)
    with pytest.raises(ValueError, match="is not one of"):
        gru_ab.parse_sources(["old=x.cu@bf16"], "general")


def test_the_launch_ints_of_each_plan():
    """``@v7`` is the FMA kernel's formula (groups of 8 points, threads, shared
    memory; at hidden 32 / context 96: 3 groups, 96 threads, 37,632
    bytes), which the bf16 entry's ``@general`` names too; the general
    entry's own plans are ``general_gru_plan``'s launch ints, held to a
    mode where one is named."""
    assert gru_ab.v7_plan(32, 96, 64) == (3, 96, 37632)
    assert gru_ab._launch_ints("bf16", "general", 32, 96, 64, 8192) == (
        3, 96, 37632)
    assert gru_ab._launch_ints("general", "v7", 33, 50, 37, 8192) == (
        gru_ab.v7_plan(33, 50, 37))
    plan = gr.general_gru_plan(32, 96, 64)
    assert gru_ab._launch_ints("general", "general", 32, 96, 64, 8192) == (
        plan.launch)
    ring = gru_ab._launch_ints("general", "ring", 32, 96, 64, 8192)
    assert ring == gr.general_gru_plan(32, 96, 64, "ring").launch
    assert ring[0] == gr.GENERAL_MODES.index("ring") != plan.launch[0]
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gru_ab._launch_ints("general", "resident", 128, 128, 64, 8192)
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gru_ab.v7_plan(2048, 64, 64)
