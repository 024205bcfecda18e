"""The bf16 GRU kernel's launch plan (``ops/cuda/gru_iter.py::
bf16_gru_plan``), on the CPU (the kernel runs on the card:
``tests/test_torch_cuda.py``).

Every width the kernel took before it moved to the tensor cores (it ran
on ``general_gru_plan``) is taken: the flagship's 64, phase 6's and
phase 10's 32, 96, 128 and 32/96, and 33/50/37 (not multiples of 16);
the plan stays within the shared memory a block can have, keeps the
weights resident where they fit beside four tiles' staged rows (a tile
on two warps above hidden width 32), streams them a slab at a time where
a slab and one tile's rows fit, and sizes the grid to the rows. A width
no warp's bare rows fit is refused, naming the limit.
"""

import pytest

from pvraft_tpu_torch.ops import cuda as tcuda
from pvraft_tpu_torch.ops.cuda import gru_iter as gr

SMS = 132                      # the H100 SXM's SMs
WIDTHS = [(64, 64, 64), (32, 32, 64), (96, 96, 64), (128, 128, 64),
          (32, 96, 64), (33, 50, 37)]
RESIDENT = {(64, 64, 64), (32, 32, 64), (32, 96, 64), (33, 50, 37)}


def _pad(x, m):
    return -(-x // m) * m


def _rows(h, c, f, staged):
    """Bytes of one warp's 16 rows."""
    hp = _pad(h, 32)
    if not staged:
        return 32 * (4 * hp + 8)
    cor = _pad(f, 16) if _pad(f, 16) > 2 * hp else 0
    return 32 * (5 * hp + _pad(c, 16) + 16 + cor + 8)


MATS = lambda h, c, f: [(f, 1), (8, 1), (h, 1), (h, 1), (c, 3), (h, 3),
                        (8, 3), (h, 3)]


def _weights(h, c, f):
    hp = _pad(h, 32)
    return sum(2 * _pad(k, 16) * (ng * hp + 8) for k, ng in MATS(h, c, f))


def _slab(h, c, f):
    """The largest stage's weight columns for a block of 32 channels, in
    bf16."""
    m = MATS(h, c, f)

    def part(i, ng):
        return 2 * _pad(m[i][0], 16) * (ng * 32 + 8)

    return max(part(0, 1) + part(1, 1), part(2, 1) + part(3, 1),
               part(4, 3) + part(5, 3) + part(6, 3) + part(7, 2), part(7, 1))


@pytest.mark.parametrize("rows", [37, 2048, 8192, 16384, 32768])
@pytest.mark.parametrize("h,c,f", WIDTHS)
def test_the_plan_takes_every_width_the_kernel_took(h, c, f, rows):
    blocks, threads, smem, mode = gr.bf16_gru_plan(h, c, f, rows, SMS)
    gr.general_gru_plan(h, c, f)            # the old plan took it too
    warps = threads // 32
    resident = mode == "resident"
    team = 2 if resident and h > 32 else 1
    assert 1 <= warps <= gr.BF16_MAX_WARPS and threads % 32 == 0
    assert mode == ("resident" if (h, c, f) in RESIDENT else "streamed")
    assert warps % team == 0
    bias = 24 * _pad(h, 32)
    store = _weights(h, c, f) if resident else _slab(h, c, f)
    assert smem == bias + store + warps // team * _rows(h, c, f, True)
    assert smem <= tcuda.SMEM_MAX
    tiles = -(-rows // 16)
    # Teams of warps spread the 16-point tiles over the SMs, at least four
    # warps where the weights are resident (they stage the arrays at once);
    # every tile has a team, at once or in a persistent loop of at most
    # one block per SM where the weights are resident.
    fit = min(gr.BF16_MAX_WARPS,
              team * ((tcuda.SMEM_MAX - bias - store) // _rows(h, c, f, True)))
    want = min(fit, max(team, team * -(-tiles // SMS)))
    assert warps == (max(4, want) if resident else want)
    if resident:
        assert blocks == min(-(-tiles // (warps // team)), SMS)
    else:
        assert blocks * (warps // team) >= tiles
        assert blocks == -(-tiles // (warps // team))


def test_the_flagship_width_holds_its_weights_beside_its_tiles():
    rows = _rows(64, 64, 64, True)
    assert rows == 32 * (5 * 64 + 64 + 16 + 8)     # cor over hid, r * netd
    # Eight warps, four tiles on two warps each, at 1 x 8192 and 4 x 8192.
    for n, blocks in ((8192, 128), (4 * 8192, SMS)):
        assert gr.bf16_gru_plan(64, 64, 64, n, SMS) == (
            blocks, 256, 1536 + 113152 + 4 * rows, "resident")


@pytest.mark.parametrize("h,c,f", [(1, 7200, 1), (1000, 16, 16),
                                   (512, 512, 512), (7, 3, 1), (200, 64, 64)])
def test_every_width_the_old_plan_took_is_taken(h, c, f):
    """The old plan refused a width where 8 points' float32 rows did not
    fit; the new one only where 16 points' bf16 intermediates do not (the
    inputs read from global memory where their staged rows do not fit):
    every width the old plan took, the new one takes."""
    gr.general_gru_plan(h, c, f)
    blocks, threads, smem, mode = gr.bf16_gru_plan(h, c, f, 8192, SMS)
    assert blocks >= 1 and threads >= 32 and smem <= tcuda.SMEM_MAX
    bias = 24 * _pad(h, 32)
    staged = _rows(h, c, f, True)
    assert (mode == "bare") == (bias + _slab(h, c, f) + staged
                                > tcuda.SMEM_MAX
                                and bias + _weights(h, c, f) + 4 * staged
                                > tcuda.SMEM_MAX)


def test_the_plan_names_its_limit():
    with pytest.raises(ValueError, match=str(tcuda.SMEM_MAX)):
        gr.bf16_gru_plan(2048, 64, 64, 8192, SMS)
    with pytest.raises(ValueError, match="widths >= 1"):
        gr.bf16_gru_plan(64, 0, 64, 8192, SMS)
