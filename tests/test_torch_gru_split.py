"""The premises of the GRU kernel's 3xTF32 arithmetic, checked on the CPU.

``csrc/gru_iter.cu`` runs every product of the fused GRU update on the
TF32 tensor cores and keeps fp32 accuracy by splitting each fp32 operand
into ``hi = rna_tf32(x)`` (``cvt.rna.tf32.f32``: 10 mantissa bits, to
nearest, ties away from zero) and ``lo = x - hi``, exact in fp32, so that
``hi + lo == x`` (the kernel recovers ``net`` from its split); the tensor
core reads the top 11 significant bits of ``lo`` (truncation). Per 8-deep
step it sums ``a_lo.b_hi``, then ``a_hi.b_lo``, then ``a_hi.b_hi``. The
split is IEEE bit arithmetic, emulated here on the float bits; the
products of two TF32 values are exact in fp32, and the sums are emulated
in float64 and rounded to fp32.
Checked on ~10^5 seeded values (subnormals, +-1e30, exact ties), and on
the whole update at width 64 against ``gru_math`` in fp32 and in fp64 on
``chip_smoke.py``'s input distributions (activation scale 1) and on
activations scaled x10 that saturate sigmoid and tanh.
"""

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.ops.cuda.gru_iter import (
    gru_math, pack_gru_weights, pad_flow)

TIE = 0x1000                  # half a TF32 unit in the last place
LOW = 0x1FFF                  # the 13 mantissa bits TF32 drops


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits: add half a unit of the 10th
    mantissa bit to the magnitude and drop the 13 bits below it (ties away
    from zero; a carry may reach the exponent). Inf and NaN pass."""
    bits = x.view(torch.int32)
    out = (bits + TIE) & ~LOW
    finite = torch.isfinite(x)
    return torch.where(finite, out, bits).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its top 11
    significant bits (the low 13 bits dropped, toward zero)."""
    return (x.view(torch.int32) & ~LOW).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split: hi = rna_tf32(x), lo = x - hi."""
    hi = rna_tf32(x)
    return hi, x - hi


def _values() -> torch.Tensor:
    rng = np.random.default_rng(0)
    tiny = np.float32(2.0**-149)
    ties = (rng.integers(1, 2**10, 5000).astype(np.int64) << 13) | TIE
    ties |= rng.integers(1, 254, 5000).astype(np.int64) << 23
    ties |= rng.integers(0, 2, 5000).astype(np.int64) << 31
    parts = [
        rng.normal(0, 1, 40000),                          # activations
        rng.normal(0, 0.15, 20000),                       # weights
        rng.normal(0, 10, 10000),                         # saturating
        rng.integers(-2**23, 2**23, 10000) * tiny,        # subnormals
        rng.uniform(-1e30, 1e30, 5000),                   # near +-1e30
        np.sign(rng.normal(size=5000)) * 1e30 * (1 + rng.uniform(-1e-6, 1e-6, 5000)),
        np.exp(rng.uniform(-87, 87, 5000)),               # every binade
        [0.0, -0.0, 2.0**-126, -(2.0**-126), 1e38, -1e38],
    ]
    x = np.concatenate([np.asarray(p, np.float64).astype(np.float32)
                        for p in parts])
    return torch.cat([torch.from_numpy(x),
                      torch.from_numpy(ties.astype(np.uint32).view(np.int32))
                      .view(torch.float32)])


def test_hi_keeps_at_most_eleven_significant_bits():
    x = _values()
    hi, _ = split(x)
    assert int((hi.view(torch.int32) & LOW).abs().sum()) == 0
    assert bool(torch.isfinite(hi).all())


def test_hi_plus_lo_is_x_exactly():
    """x - hi is exact in fp32, so hi + lo gives x back (bitwise, but for
    the sign of a zero: -0 splits into -0 and +0)."""
    x = _values()
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)
    nonzero = x != 0
    assert torch.equal((hi + lo).view(torch.int32)[nonzero],
                       x.view(torch.int32)[nonzero])
    assert torch.equal(hi.double() + lo.double(), x.double())


def test_what_the_tensor_core_reads_reproduces_x():
    """hi + (lo's top 11 bits) is within 2^-21 |x| wherever lo is a normal
    number (|x| >= 2^-115); below, lo's TF32 subnormal quantum 2^-136
    bounds it. Rounding lo as well (the textbook split) would give 2^-22
    but lose hi + lo == x."""
    x = _values()
    hi, lo = split(x)
    err = (x.double() - (hi.double() + tf32_read(lo).double())).abs()
    bound = torch.clamp(x.double().abs() * 2.0**-21, min=2.0**-136)
    assert bool((err <= bound).all())
    normal = x.double().abs() >= 2.0**-115
    assert int(normal.sum()) > 80000
    assert bool((err[normal] <= x.double().abs()[normal] * 2.0**-21).all())
    rounded = (x.double() - (hi.double() + rna_tf32(lo).double())).abs()
    assert bool((rounded[normal] <= x.double().abs()[normal] * 2.0**-22).all())


def test_ties_round_away_from_zero():
    x = _values()
    bits = x.view(torch.int32)
    tie = ((bits & LOW) == TIE) & torch.isfinite(x) & (x != 0)
    assert int(tie.sum()) >= 5000
    hi = rna_tf32(x[tie])
    assert bool((hi.abs() > x[tie].abs()).all())
    assert bool((torch.sign(hi) == torch.sign(x[tie])).all())
    down = (bits & ~LOW) | (TIE - 1)           # just below a tie: down
    xd = down.view(torch.float32)[tie]
    assert torch.equal(rna_tf32(xd), (down & ~LOW).view(torch.float32)[tie])


# ------------------------------------------------- the update at width 64 --

H = 64


def _chain(acc, terms, passes):
    """The kernel's accumulator: ``acc`` (fp32) plus each (x, w) product,
    8 input channels at a time, each pass of ``passes`` ((x part, w part)
    pairs, as the tensor core reads them) summed exactly and rounded to
    fp32 onto the accumulator."""
    for x, w in terms:
        xs = [tf32_read(v) for v in split(x)]
        ws = [tf32_read(v) for v in split(w)]
        parts = {"hi": 0, "lo": 1}
        for k0 in range(0, x.shape[-1], 8):
            for a, b in passes:
                xa = xs[parts[a]][..., k0:k0 + 8].double()
                wb = ws[parts[b]][k0:k0 + 8].double()
                acc = (acc.double() + xa @ wb).float()
    return acc


THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
ONE = (("hi", "hi"),)


def kernel_math(net, inp, cor_in, flow8, weights, passes):
    """The kernel's arithmetic (``csrc/gru_iter.cu``): each stage's
    accumulator starts at its bias and takes the stage's products in the
    kernel's order; ``passes`` THREE is 3xTF32, ONE a single TF32 pass."""
    wc, wf, wh, wn3, wi3, wh3, wf3, bias = weights
    b_me, b_g = bias[0], bias[1]
    rows = net.shape[:-1]

    def start(b):
        return b.expand(*rows, b.shape[-1]).clone()

    cor = torch.relu(_chain(start(b_me[0:H]), [(cor_in, wc)], passes))
    flo = torch.relu(_chain(start(b_me[H:2 * H]), [(flow8, wf)], passes))
    hid = torch.relu(_chain(start(b_me[2 * H:]),
                            [(cor, wh[:H]), (flo, wh[H:])], passes))
    px = _chain(start(b_g), [(inp, wi3), (hid, wh3), (flow8, wf3)], passes)
    zr = _chain(px[..., :2 * H], [(net, wn3[:, :2 * H])], passes)
    z = torch.sigmoid(zr[..., :H])
    r = torch.sigmoid(zr[..., H:])
    q = torch.tanh(_chain(px[..., 2 * H:], [(r * net, wn3[:, 2 * H:])],
                          passes))
    return (1.0 - z) * net + z * q


def _inputs(scale, n=2048, seed=0):
    """chip_smoke.py's GRU inputs (weights 0.15 N(0,1); net = tanh, inp =
    relu, cor of s N(0,1); flow 0.3 s N(0,1)) at activation scale s."""
    rng = np.random.default_rng(seed)

    def a(*shape, sd=0.15):
        return torch.from_numpy((sd * rng.normal(size=shape)).astype(np.float32))

    me = (a(H, H), a(H), a(3, H), a(H), a(2 * H, H - 3), a(H - 3))
    gru = (a(3 * H, H), a(H), a(3 * H, H), a(H), a(3 * H, H), a(H))
    weights = pack_gru_weights(me, gru, H, H)
    net = torch.tanh(a(1, n, H, sd=scale))
    inp = torch.relu(a(1, n, H, sd=scale))
    cor = a(1, n, H, sd=scale)
    flow8 = pad_flow(a(1, n, 3, sd=0.3 * scale)).contiguous()
    return net, inp, cor, flow8, weights


@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_3xtf32_update_is_as_accurate_as_fp32(scale):
    """Against fp64, the 3xTF32 update's max error stays within twice fp32
    ``gru_math``'s own."""
    net, inp, cor, flow8, w = _inputs(scale)
    exact = gru_math(net.double(), inp.double(), cor.double(),
                     flow8.double(), tuple(t.double() for t in w))
    fp32_err = float((gru_math(net, inp, cor, flow8, w).double() - exact)
                     .abs().max())
    tf32x3_err = float((kernel_math(net, inp, cor, flow8, w, THREE).double()
                        - exact).abs().max())
    assert 0 < fp32_err < 1e-4
    assert tf32x3_err <= 2 * fp32_err, (tf32x3_err, fp32_err)


def test_3xtf32_meets_1e5_and_one_tf32_pass_does_not():
    """At activation scale 1 the 3xTF32 update is within the 1e-5 bar of
    fp32 ``gru_math``; a single TF32 pass (11 significant bits) is more
    than 1e-3 off, which is why the kernel takes three."""
    net, inp, cor, flow8, w = _inputs(1.0)
    want = gru_math(net, inp, cor, flow8, w)
    three = kernel_math(net, inp, cor, flow8, w, THREE)
    one = kernel_math(net, inp, cor, flow8, w, ONE)
    assert float((three - want).abs().max()) <= 1e-5
    assert float((one - want).abs().max()) > 1e-3
