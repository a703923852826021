"""A numpy model of K2's error-compensated TF32 products (csrc/stem_grad.cu).

K2 runs its data gradient (dpre1, K = 9 taps x 64 channels) and its dw2
weight gradient (K = the pixels of one chunk) on the tensor cores as
"3xTF32": each fp32 operand a is cut into hi = cvt.rna.tf32(a) and
lo = cvt.rna.tf32(a - hi), and each product takes a_lo*b_hi, a_hi*b_lo and
a_hi*b_hi, in that order, into an fp32 accumulator, 8 values of K per mma.
The accumulator runs for one tap (dpre1) or one 32-pixel step (dw2) and is
then added to a second fp32 sum. The model here does the same in numpy and
shows:

1. on the small-integer recipe of the bit-exact tests every operand is its
   own hi (or hi + lo, for the dw1 job's dpre1), so the products stay exact;
2. on float inputs, at K = 576 and at one chunk of a 1200x1600 image, the
   3xTF32 model is within 1e-5 of the peak of the float64 product, the
   bound of the card's check on K2's own routing;
3. a plain 1xTF32 model misses that bound on the same inputs, so the card's
   check would catch a missing split; and if the tensor cores round each
   sum toward zero, one accumulator over a whole chunk would miss it too,
   while the per-step sums hold it;
4. composed with the plain stem's routing at (2, 32, 128, 3), the model's
   dpre1 and dw2 match ``fused_stem_grad_products`` within the same bound.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.models.layers import zero_outside
from smallhardface_tpu_torch.ops import stem

SHAPE, VALID = (2, 32, 128, 3), (24, 96)
BOUND = 1e-5                    # max |err| / peak |product|, the card's check
CHUNK = 1200 * 1600 // stem.GRAD_CHUNKS      # 7,500 pixels


def tf32_rna(a):
    """cvt.rna.tf32.f32 for finite fp32 values: round the 13 low bits off,
    to nearest with ties away from zero."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    a = np.asarray(a, np.float32)
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def round_nearest(s):
    return s.astype(np.float32)


def round_to_zero(s):
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_product(a, b, terms=3, fold=None, rounding=round_nearest):
    """a (..., M, K) @ b (..., K, N) as K2 computes it: K in steps of 8, each
    step one mma per term, the 8 exact products and the accumulator summed
    and rounded to fp32 (``rounding``); ``terms`` 3 takes lo*hi, hi*lo,
    hi*hi, 1 takes hi*hi alone. Every ``fold`` steps the accumulator is
    added to an fp32 sum (rounded to nearest) and restarted."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    k = a.shape[-1]
    pad = -k % 8
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), np.float32)],
                           -1)
        b = np.concatenate([b, np.zeros(b.shape[:-2] + (pad, b.shape[-1]),
                                        np.float32)], -2)
    (ahi, alo), (bhi, blo) = split(a), split(b)
    pairs = [(alo, bhi), (ahi, blo), (ahi, bhi)][3 - terms:]
    shape = a.shape[:-1] + (b.shape[-1],)
    acc, total = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    steps = a.shape[-1] // 8
    for s in range(steps):
        sl = slice(8 * s, 8 * s + 8)
        for x, y in pairs:
            acc = rounding(acc.astype(np.float64) + np.matmul(
                x[..., sl].astype(np.float64), y[..., sl, :].astype(
                    np.float64)))
        if fold and ((s + 1) % fold == 0 or s + 1 == steps):
            total = (total + acc).astype(np.float32)
            acc = np.zeros(shape, np.float32)
    return total if fold else acc


def rel_err(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


def test_cvt_rna_model():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)          # TF32's spacing at 1
    cases = {1.0: 1.0, 1 + 2.0 ** -11: 1 + 2.0 ** -10,     # tie: away from 0
             -(1 + 2.0 ** -11): -(1 + 2.0 ** -10), 1 + 2.0 ** -12: 1.0,
             1 + 3 * 2.0 ** -12: 1 + 2.0 ** -10, 2049.0: 2050.0,
             -2049.0: -2050.0, 2047.0: 2047.0, 0.0: 0.0}
    for a, want in cases.items():
        assert tf32_rna(np.float32(a)) == np.float32(want), a
    x = np.random.RandomState(0).randn(10000).astype(np.float32) * 100
    hi, lo = split(x)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all()
    assert (lo.view(np.uint32) & 0x1FFF == 0).all()
    assert (np.abs(x - hi) <= np.abs(hi) * ulp / 2 / one).all()
    # hi + lo keeps about 22 bits: what lo's rounding drops
    assert (np.abs(x.astype(np.float64) - hi - lo)
            <= np.abs(x) * 2.0 ** -21).all()


def test_split_is_exact_on_the_integer_recipe():
    """x, dy, w1, b in ±3, w2 in ±2, c1 ≤ 246 are their own hi; the dw1
    job's dpre1 (up to 3456 in magnitude) is hi + lo exactly; and products
    at the recipe's worst magnitudes, with sums below 2^24, stay exact."""
    small = np.arange(-246, 247, dtype=np.float32)
    hi, lo = split(small)
    assert np.array_equal(hi, small) and not lo.any()
    big = np.arange(-3456, 3457, dtype=np.float32)
    hi, lo = split(big)
    assert np.array_equal(hi.astype(np.float64) + lo, big)
    rng = np.random.RandomState(1)
    # data gradient: dpre2 in ±3 against w2f in ±2, K = 576, all of one sign
    a = np.full((4, 576), 3.0, np.float32)
    a[1:] = rng.randint(-3, 4, (3, 576))
    b = np.full((576, 64), 2.0, np.float32)
    b[:, 1:] = rng.randint(-2, 3, (576, 63))
    want = a.astype(np.float64) @ b
    assert np.abs(want).max() == 3456
    assert np.array_equal(tc_product(a, b, fold=8), want)
    # dw2: c1 up to 246 against dpre2 in ±3 over one chunk
    a = np.full((4, CHUNK), 246.0, np.float32)
    a[1:] = rng.randint(0, 247, (3, CHUNK))
    b = np.full((CHUNK, 8), 3.0, np.float32)
    b[:, 1:] = rng.randint(-3, 4, (CHUNK, 7))
    want = a.astype(np.float64) @ b
    assert np.abs(want).max() == 246 * 3 * CHUNK < 2 ** 24
    assert np.array_equal(tc_product(a, b, fold=4), want)


def _data_grad_operands(rng, m=1024):
    """dpre2 rows (a quarter nonzero, as the pool routes them) against
    w2f at He scale: the data gradient's product, K = 576."""
    a = rng.randn(m, 576) * (rng.rand(m, 576) < 0.25)
    b = rng.randn(576, 64) * np.sqrt(2 / 576)
    return a.astype(np.float32), b.astype(np.float32)


def _weight_grad_operands(rng, k=CHUNK):
    """c1 (after a ReLU) against dpre2 over one chunk: dw2's product."""
    a = np.maximum(rng.randn(64, k) * 3 + 1, 0)
    b = rng.randn(k, 64) * (rng.rand(k, 64) < 0.25)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("which,fold", [("data", 8), ("weight", 4)])
def test_3xtf32_meets_the_bound_and_1xtf32_misses_it(which, fold):
    rng = np.random.RandomState(2)
    a, b = (_data_grad_operands if which == "data"
            else _weight_grad_operands)(rng)
    want = a.astype(np.float64) @ b.astype(np.float64)
    three = rel_err(tc_product(a, b, 3, fold), want)
    one = rel_err(tc_product(a, b, 1, fold), want)
    assert three <= BOUND / 4, three
    assert one > 10 * BOUND, one


def test_per_step_sums_hold_the_bound_if_sums_round_toward_zero():
    """Were each mma's sum rounded toward zero, one accumulator over a
    whole chunk would drift past the bound; K2's 32-pixel accumulators,
    added to a sum rounded to nearest, stay within it."""
    a, b = _weight_grad_operands(np.random.RandomState(3))
    want = a.astype(np.float64) @ b.astype(np.float64)
    chain = rel_err(tc_product(a, b, rounding=round_to_zero), want)
    folded = rel_err(tc_product(a, b, fold=4, rounding=round_to_zero), want)
    assert chain > 2 * BOUND, chain
    assert folded <= BOUND / 4, folded


def _plain_routing(x, dy, w1, b1, w2, b2, valid_hw):
    """The plain stem's c1 and dpre2, NHWC, from autograd (fp32)."""
    h = zero_outside(x.permute(0, 3, 1, 2), *valid_hw)
    c1 = zero_outside(F.relu(F.conv2d(h, w1, b1, padding=1)), *valid_hw)
    with torch.enable_grad():
        pre2 = F.conv2d(c1, w2, b2, padding=1).requires_grad_(True)
        out = F.max_pool2d(F.relu(pre2), 2, 2, ceil_mode=True)
        d = zero_outside(dy.permute(0, 3, 1, 2), (valid_hw[0] + 1) // 2,
                         (valid_hw[1] + 1) // 2)
        (dpre2,) = torch.autograd.grad(out, pre2, d)
    return c1.permute(0, 2, 3, 1), dpre2.permute(0, 2, 3, 1)


def test_products_reference_on_plain_routing_is_the_plain_backward():
    """fused_stem_grad_products on the plain routing gives the plain
    backward's grads (float64), so it can judge K2's products."""
    rng = np.random.RandomState(4)
    B, H, W, _ = SHAPE
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    x, dy = t(rng.randn(*SHAPE) * 50), t(rng.randn(B, H // 2, W // 2, 64))
    ws = [t(rng.randn(64, 3, 3, 3) * 0.27), t(rng.randn(64) * 0.5),
          t(rng.randn(64, 64, 3, 3) * 0.06), t(rng.randn(64) * 0.5)]
    c1, dpre2 = _plain_routing(x, dy, *ws, VALID)
    got = stem.fused_stem_grad_products(x, c1, dpre2, ws[2], VALID)[1:]
    want = stem.fused_stem_grad_reference(x, dy, *ws, VALID)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_model_on_plain_routing_matches_the_products_reference():
    """The 3xTF32 model of K2's dpre1 (an implicit GEMM over 9 taps x 64
    channels per pixel) and dw2 (the wrapper's pixel chunks, summed in
    chunk order) on the plain stem's routing, against
    fused_stem_grad_products in float64."""
    rng = np.random.RandomState(5)
    B, H, W, _ = SHAPE
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x, dy = t(rng.randn(*SHAPE) * 50), t(rng.randn(B, H // 2, W // 2, 64))
    ws = [t(rng.randn(64, 3, 3, 3) * np.sqrt(2 / 27)), t(rng.randn(64) * 0.5),
          t(rng.randn(64, 64, 3, 3) * np.sqrt(2 / 576)),
          t(rng.randn(64) * 0.5)]
    c1, dpre2 = _plain_routing(x, dy, *ws, VALID)
    want = stem.fused_stem_grad_products(x.double(), c1.double(),
                                         dpre2.double(), ws[2].double(),
                                         VALID)
    c1, dpre2 = c1.numpy(), dpre2.numpy()
    w2 = ws[2].numpy()

    # dpre1: A[pixel][tap, co] = dpre2 at pixel + tap - 1, B = w2f
    pad = np.pad(dpre2, ((0, 0), (1, 1), (1, 1), (0, 0)))
    a = np.concatenate([pad[:, ky:ky + H, kx:kx + W] for ky in range(3)
                        for kx in range(3)], -1).reshape(-1, 576)
    w2f = w2[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).reshape(576, 64)
    dc1 = tc_product(a, w2f, fold=8).reshape(B, H, W, 64)
    dpre1 = np.where(c1 > 0, dc1, np.float32(0))
    assert rel_err(dpre1, want[0].numpy()) <= BOUND

    # dw2 tap (ky, kx): c1 shifted by the tap against dpre2, per chunk
    n_pix = B * H * W
    chunk = -(-n_pix // stem.GRAD_CHUNKS)
    chunk = -(-chunk // 32) * 32
    n_chunk = -(-n_pix // chunk)
    cpad = np.pad(c1, ((0, 0), (1, 1), (1, 1), (0, 0)))
    d2 = np.zeros((n_chunk * chunk, 64), np.float32)
    d2[:n_pix] = dpre2.reshape(-1, 64)
    dw2 = np.zeros((64, 64, 3, 3), np.float32)
    for ky in range(3):
        for kx in range(3):
            sh = np.zeros((n_chunk * chunk, 64), np.float32)
            sh[:n_pix] = cpad[:, ky:ky + H, kx:kx + W].reshape(-1, 64)
            part = tc_product(sh.reshape(n_chunk, chunk, 64).transpose(0, 2, 1),
                              d2.reshape(n_chunk, chunk, 64), fold=4)
            total = np.zeros((64, 64), np.float32)
            for p in part:                                   # chunk order
                total = (total + p).astype(np.float32)
            dw2[:, :, ky, kx] = total.T                      # (co, ci)
    assert rel_err(dw2, want[3].numpy()) <= BOUND
