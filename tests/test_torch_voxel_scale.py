"""The premises of the voxel kernels' arithmetic, checked on the CPU.

``csrc/voxel_bins.cuh`` bins without a division where every level's edge
``r = 0.25 * 2^l`` is a power of two, and rounds with one add of
1.5 * 2^23 instead of a rounding instruction. Both claims are about IEEE
float32 arithmetic, which the CPU shares with the card, so they are
checked here bitwise against what the plain version computes
(``pvraft_tpu_torch/ops/voxel.py``: ``torch.round(rel / r)`` with ``r`` a
0-dim tensor), on ~10^5 seeded offsets that include subnormals, exact
multiples of r/2 and values near +/-1e30.
"""

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.ops.cuda import reciprocal_is_exact

ROUND = np.float32(1.5 * 2**23)       # kRound in voxel_bins.cuh


def _offsets() -> torch.Tensor:
    rng = np.random.default_rng(0)
    tiny = np.float32(2.0**-149)
    parts = [
        rng.normal(0, 1, 40000),                          # typical offsets
        rng.normal(0, 1e-3, 10000),
        rng.integers(-2**23, 2**23, 20000) * tiny,        # subnormals
        rng.integers(-64, 65, 10000) * 0.125 * 0.5,       # multiples of r/2
        rng.integers(-64, 65, 5000) * 4.0 * 0.5,
        rng.uniform(-1e30, 1e30, 5000),                   # near +/-1e30
        np.sign(rng.normal(size=5000)) * 1e30 * (1 + rng.uniform(-1e-6, 1e-6, 5000)),
        [0.0, -0.0, 2.0**-126, -(2.0**-126), 3.4e38, -3.4e38],
    ]
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _divide(x: torch.Tensor, r: float) -> torch.Tensor:
    return x / torch.tensor(r, dtype=torch.float32)   # the plain version's


@pytest.mark.parametrize("level", range(5))
def test_reciprocal_multiply_is_the_division(level):
    x = _offsets()
    r = 0.25 * 2**level
    inv = torch.tensor(1.0 / r, dtype=torch.float32)
    assert torch.equal(_bits(x * inv), _bits(_divide(x, r)))


@pytest.mark.parametrize("level", range(4))
def test_halving_is_the_next_levels_division(level):
    """Halving one level's quotient gives the next level's, subnormals
    included, wherever that quotient is finite. Where it overflowed
    (|x| near 3.4e38) halving keeps the infinity, so the kernel multiplies
    each level by its own reciprocal instead of halving."""
    x = _offsets()
    q = _divide(x, 0.25 * 2**level)
    nxt = _divide(x, 0.25 * 2**(level + 1))
    finite = torch.isfinite(q)
    assert torch.equal(_bits(q * 0.5)[finite], _bits(nxt)[finite])
    assert bool((x[~finite].abs() > 1e38).all())


@pytest.mark.parametrize("scale,levels", [(0.25, 1), (0.3, 1)])
def test_one_add_rounds_and_range_tests_like_the_plain_version(scale, levels):
    """bits(fl(q + 1.5 * 2^23)) - bits(1.5 * 2^23) + 1 <= 2 (unsigned) iff
    |round(q)| <= 1, and then it is round(q) + 1: the kernel's cell test.
    For a power-of-two r the kernel forms fl(rel * (1/r) + 1.5 * 2^23) in
    one fma; float64 holds that product exactly, so it is emulated here."""
    x = _offsets()
    r = scale
    q = _divide(x, r)
    want = torch.round(q)
    valid = want.abs() <= 1
    sums = [q + torch.tensor(ROUND)]
    if reciprocal_is_exact(scale, levels):
        exact = (x.double() * (1.0 / r) + float(ROUND)).float()
        assert torch.equal(_bits(exact), _bits(sums[0]))
        sums.append(exact)
    for y in sums:
        u = (_bits(y).long() - (int(_bits(torch.tensor(ROUND))) - 1)) % 2**32
        assert torch.equal(u <= 2, valid)
        assert torch.equal((u[valid] - 1).float(), want[valid] + 0.0)


@pytest.mark.parametrize("scale,want", [(0.25, True), (0.5, True),
                                        (2.0, True), (0.3, False),
                                        (0.1, False), (0.0, False)])
def test_reciprocal_helper(scale, want):
    assert reciprocal_is_exact(scale, 3) is want


def test_reciprocal_helper_needs_a_normal_reciprocal_at_every_level():
    assert reciprocal_is_exact(2.0**-126, 3)
    assert not reciprocal_is_exact(2.0**-127, 3)       # subnormal r
    assert reciprocal_is_exact(2.0**124, 3)             # r up to 2^126
    assert not reciprocal_is_exact(2.0**125, 3)         # 1/r subnormal
    assert not reciprocal_is_exact(-0.25, 3)
    assert not reciprocal_is_exact(float("inf"), 3)
