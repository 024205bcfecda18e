"""Which CUDA kernel variant each shape selects, and the general kernels'
launch plans, on the CPU (the kernels themselves run on the card:
``tests/test_torch_cuda.py``).

The tuned kernels take what they are built on (K <= 512, knn <= 32,
resolution 3; GRU widths 64); every other shape selects the general
kernel, whose shared-memory plan must cover every configuration the
repository uses (the JAX package's tests and
``pvraft_tpu/programs/geometries.py``: K from 8 to 1024, knn up to 64,
resolutions 1 to 5, GRU widths 32 to 128) and refuses, naming the limit,
what no block can hold. The general wrappers launch their kernel or
raise; on a CPU tensor the Functions that call them take the plain
version and launch nothing.
"""

import pytest
import torch

from pvraft_tpu.programs import geometries
from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.ops import cuda as tcuda
from pvraft_tpu_torch.ops.cuda import corr_lookup as lk
from pvraft_tpu_torch.ops.cuda import gru_iter as gr


@pytest.mark.parametrize("k,knn,res,want", [
    (512, 32, 3, "tuned"), (16, 8, 3, "tuned"), (40, 0, 3, "tuned"),
    (513, 32, 3, "general"), (1024, 64, 3, "general"), (510, 48, 2, "general"),
    (512, 33, 3, "general"), (512, 32, 5, "general"), (8, 8, 1, "general"),
])
def test_lookup_variant_of_each_shape(k, knn, res, want):
    assert tcuda.lookup_variant(k, knn, res) == want


@pytest.mark.parametrize("widths,want", [
    ((64, 64, 64), "tuned"), ((32, 32, 64), "general"),
    ((96, 96, 64), "general"), ((128, 128, 64), "general"),
    ((64, 128, 64), "general"), ((64, 64, 32), "general"),
    ((64, 64, 64, "f32"), "tuned"), ((64, 64, 64, "bfloat16"), "bf16"),
    ((32, 96, 64, "bfloat16"), "bf16"), ((33, 50, 37, "bfloat16"), "bf16"),
])
def test_gru_variant_of_each_width(widths, want):
    assert tcuda.gru_variant(*widths) == want


def test_the_flagship_geometry_takes_the_tuned_kernels():
    cfg = ModelConfig(truncate_k=geometries.FLAGSHIP_TRUNCATE_K)
    assert tcuda.kernel_takes(cfg) == {"corr_lookup": "tuned",
                                       "voxel_corr": "tuned",
                                       "gru_iter": "tuned"}


@pytest.mark.parametrize("kw", [{}, {"hidden_dim": 32, "context_dim": 96},
                                {"truncate_k": 1024, "corr_knn": 64}])
def test_a_bf16_model_routes_the_gru_to_the_bf16_kernel(kw):
    """At compute_dtype bfloat16 the GRU update runs the bf16 kernel at
    every width; the lookup and the voxel means keep their float32
    variant (their operands are float32 at both dtypes)."""
    f32 = tcuda.kernel_takes(ModelConfig(**kw))
    bf16 = tcuda.kernel_takes(ModelConfig(compute_dtype="bfloat16", **kw))
    assert bf16 == {**f32, "gru_iter": "bf16"}


@pytest.mark.parametrize("k", [8, 16, 37, 64, 510, 512, 600, 1024, 4096])
@pytest.mark.parametrize("knn,res,levels", [(0, 3, 3), (8, 2, 3), (32, 3, 3),
                                            (64, 4, 3), (64, 5, 4),
                                            (8, 1, 2)])
def test_general_lookup_plan_covers_the_configurations_in_use(k, knn, res,
                                                              levels):
    """Every configuration in use gets a launch that fits a block: the
    points per block, the levels per pass (packed counts of
    bit_length(16 * chunks) bits fit a word; the passes even; never fewer
    resident warps than one level per pass gives, up to the register cap)
    and the shared memory of the kernel's layout."""
    knn = min(knn, k)
    plan = lk.general_lookup_plan(k, knn, res, levels)
    words = lk.general_layout_words(k, knn, res, levels, plan.levels_per_pass)
    assert plan.smem == 4 * plan.warps * words <= tcuda.SMEM_MAX
    assert 1 <= plan.warps <= 4
    assert 1 <= plan.levels_per_pass <= levels
    assert plan.levels_per_pass * (16 * -(-k // lk.CHUNK)).bit_length() <= 32
    passes = -(-levels // plan.levels_per_pass)
    assert -(-levels // passes) == plan.levels_per_pass
    one = lk.general_layout_words(k, knn, res, levels, 1)
    assert plan.resident >= min(lk.REG_WARPS,
                                lk.SMEM_SM // (4 * one + lk.BLOCK_RESERVED))
    sort_len = 1 << (knn - 1).bit_length() if knn else 0
    tables = (plan.levels_per_pass * res**3 + res**3 + 2) * 32
    keys = -(-k // lk.CHUNK) * lk.CHUNK if knn and k > 2 * lk.CHUNK else 0
    assert words == -(-max(tables, 2 * sort_len) // 32) * 32 + keys


# The shapes phase 1 of chip_smoke.py runs the general kernel at: (K, knn,
# resolution, levels) -> (points per block, levels per pass, resident warps
# per SM). At R 3 every level goes in one pass with 16 warps resident; R 5's
# 125-row tables take one level a pass, one point a block.
@pytest.mark.parametrize("shape,want", [
    ((1024, 64, 3, 3), (4, 3, 16)), ((1024, 0, 3, 3), (4, 3, 16)),
    ((510, 48, 2, 3), (4, 3, 16)), ((510, 0, 2, 3), (4, 3, 16)),
    ((512, 32, 5, 4), (1, 1, 7)), ((512, 0, 5, 4), (1, 1, 7)),
])
def test_general_lookup_plan_of_the_main_shapes(shape, want):
    plan = lk.general_lookup_plan(*shape)
    assert (plan.warps, plan.levels_per_pass, plan.resident) == want


def test_general_lookup_plan_names_its_limit():
    with pytest.raises(ValueError, match="232448"):
        lk.general_lookup_plan(512, 32, 10, 3)
    # Past 1,024 candidates the kNN keeps every distance key in shared
    # memory: 60,000 of them do not fit a block.
    lk.general_lookup_plan(40000, 32, 3, 3)
    with pytest.raises(ValueError, match="232448"):
        lk.general_lookup_plan(60000, 32, 3, 3)
    with pytest.raises(ValueError, match="0 <= knn <= K"):
        lk.general_lookup_plan(16, 17, 3, 3)


@pytest.mark.parametrize("h,c,f,mode", [
    (32, 32, 64, "resident"), (64, 64, 64, "ring"), (96, 96, 64, "ring"),
    (128, 128, 64, "ring"), (48, 80, 40, "resident"),
    (33, 50, 37, "resident"), (32, 96, 64, "resident")])
def test_general_gru_plan(h, c, f, mode):
    """The repository's widths run on the tensor cores: 64 points a block
    where a layout fits, else 32; a warp owns 32 points and one n8 channel
    tile, 16 warps at most; weights resident where they fit beside the
    tile, else streamed through a ring of 8 to 64 rows a slot."""
    plan = gr.general_gru_plan(h, c, f)
    assert plan.mode == mode
    warps = plan.rows // 32 * -(-h // 8)
    assert plan.threads == 32 * warps <= 512
    at64 = gr.general_gru_need(mode, 64, h, c, f)
    assert plan.rows == (64 if at64 and at64[0] <= tcuda.SMEM_MAX else 32)
    assert plan.smem == gr.general_gru_need(mode, plan.rows, h, c, f)[0]
    assert plan.smem <= tcuda.SMEM_MAX
    assert (plan.chunk in range(8, 65, 8)) == (mode == "ring")
    # The model's widths: every split of the context encoder's 128
    # channels at correlation width 64, and widths 32, 96 and 128.
    for w in [(k, 128 - k, 64) for k in range(4, 125, 15)] + [
            (32, 32, 64), (96, 96, 64), (128, 128, 64)]:
        assert gr.general_gru_plan(*w).mode in ("resident", "ring")


def test_general_gru_plan_names_its_limit():
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gr.general_gru_plan(2048, 64, 64)
    # Above hidden 128 no tensor-core layout exists: the FMA body, one
    # 8-point group above 48 KB opts in, alone in its block.
    plan = gr.general_gru_plan(256, 256, 64)
    assert (plan.mode, plan.rows, plan.threads) == ("fma", 8, 256)
    assert tcuda.SMEM_DEFAULT < plan.smem <= tcuda.SMEM_MAX
    assert plan.launch == (0, 8, plan.smem)


def test_general_wrappers_refuse_cpu_tensors():
    """The general wrappers launch their kernel or raise: a CPU tensor
    raises, counts no launch, and the Functions that call them take the
    plain version on it instead."""
    gen = torch.Generator().manual_seed(0)
    corr = torch.randn(1, 5, 40, generator=gen)
    xyz = torch.randn(1, 5, 40, 3, generator=gen)
    coords = torch.randn(1, 5, 3, generator=gen)
    before = (lk.corr_lookup_general.launches, gr.gru_iter_general.launches)
    bf16_before = gr.gru_iter_bf16.launches
    with pytest.raises(ValueError, match="CUDA device"):
        lk.corr_lookup_general(corr, xyz, coords, 2, 0.25, 2, 40)
    h, c, f = 32, 48, 64
    w = [torch.randn(s, generator=gen) for s in
         [(f, h), (h,), (3, h), (h,), (2 * h, h - 3), (h - 3,)]
         + [(2 * h + c, h), (h,)] * 3]
    weights = gr.pack_gru_weights(w[:6], w[6:], h, c)
    acts = [torch.randn(1, 5, n, generator=gen) for n in (h, c, f)]
    flow8 = gr.pad_flow(torch.randn(1, 5, 3, generator=gen))
    with pytest.raises(ValueError, match="CUDA device"):
        gr.gru_iter_general(*acts, flow8, weights)
    with pytest.raises(ValueError, match="CUDA device"):
        gr.gru_iter_bf16(acts[0], acts[1], acts[2].bfloat16(), flow8,
                         weights)
    got = lk.fused_corr_lookup(corr, xyz, coords, 2, 0.25, 2, 40)
    want = lk.corr_lookup_plain(corr, xyz, coords, 2, 0.25, 2, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(gr.fused_gru_update(*acts, flow8, weights),
                       gr.gru_math(*acts, flow8, weights))
    assert (lk.corr_lookup_general.launches,
            gr.gru_iter_general.launches) == before
    assert gr.gru_iter_bf16.launches == bf16_before
    assert set(tcuda.launch_counts()) == set(tcuda.KERNEL_SYMBOLS)
