"""A torch model of the int8 convolution kernel Q1's schedule
(``smallhardface_tpu_torch/csrc/conv_int8.cu``) on the CPU, held to the bit
against its plain version ``conv3x3_int8_reference`` and, at one shape,
against the JAX package's ``conv2d_int8_chain``.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``
holds it to the same shapes there). What it computes around the tensor
cores is modelled here with the wrapper's own tile constants
(``ops/conv_int8.plan``, ``TILE_M``, ``TILE_SHAPES``):

- an output tile is TH×TW pixels of one image by ``block_n`` channels;
- for tap (ky, kx) the A tile is one box of ``k_chunk`` channels at the
  shifted coordinates (x0 + (kx−1)d, y0 + (ky−1)d), zero where a
  coordinate lies outside the image (TMA's fill, negative coordinates
  included), and the weight tile the matching K columns;
- the int32 sums over every K step, then the epilogue on one scale row per
  tile, writing only the pixels inside H×W (each exactly once); an int8
  output is requantized by the product with fl(1 / s_out) wherever that
  provably rounds as the division does (``link_byte``), and near a
  half-integer by exact sign tests in float64 (``requantize_near``), both
  held alone against the division on ties, near ties and a spread of
  magnitudes;
- the persistent grid's walk over the tiles and its ring of stages with
  full/empty barriers and phase parities, for blocks with unequal tile
  counts (the tail).

Everything is integer or one IEEE fp32 operation a step, so the tolerance
is none: equal to the bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallhardface_tpu.models import layers as jl
from smallhardface_tpu_torch.models import layers as tl
from smallhardface_tpu_torch.ops import conv_int8
import torch_threads  # noqa: F401

EPILOGUES = {"link": (True, True), "end": (True, False),
             "dynamic": (False, False)}
S_OUT = 0.0371


def _inputs(seed, B, H, W, C, O, per_image, extreme=False):
    """int8 NCHW-shaped channels_last activations, (O, 3, 3, C) weights, a
    positive scale row (or one per image), a bias; from a numpy seed."""
    rng = np.random.RandomState(seed)
    if extreme:
        x = rng.choice(np.array([-128, -127, 0, 127], np.int8), (B, H, W, C))
        w = rng.choice(np.array([-127, 0, 127], np.int8), (O, 3, 3, C))
    else:
        x = rng.randint(-128, 128, (B, H, W, C)).astype(np.int8)
        w = rng.randint(-127, 128, (O, 3, 3, C)).astype(np.int8)
    spread = 40.0 / (np.sqrt(9 * C) * 74.0 * 74.0)
    scale = ((0.5 + rng.rand(B if per_image else 1, O)) * spread).astype(
        np.float32)
    bias = (rng.randn(O) * 5).astype(np.float32)
    return (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
            torch.from_numpy(scale), torch.from_numpy(bias))


# the steps link_byte and requantize_near take; the kernel divides
# every element of a link whose step lies outside
STEP_RANGE = (2.0 ** -60, 2.0 ** 60)


def link_byte(t, s_out):
    """The kernel's division-free requantize of fp32 t (csrc/conv_int8.cu
    link_byte): (n, unsure), n = clamp(rint(t · fl(1 / s_out))), the value
    of the byte it writes, and unsure where that may differ from
    clamp(rint(t / s_out)). The kernel rounds by adding and subtracting
    1.5·2^23, which is rint wherever |q| < 2^22 and past ±127 beyond."""
    r_out = np.float32(1) / np.float32(s_out)
    q = t * torch.tensor(r_out, dtype=torch.float32)
    n = torch.round(q)
    edge = 0.5 - (q - n).abs()
    unsure = ~((edge > q.abs() * 2.0 ** -20 + 2.0 ** -24) | (q.abs() >= 128))
    return n.clamp(-127, 127), unsure


def requantize_near(t, s_out):
    """The kernel's requantize of an element link_byte was unsure of
    (csrc/conv_int8.cu requantize_near): the half-integer m next to q, and
    the signs of t − hi·s_out and t − lo·s_out in float64 for the
    midpoints hi and lo of m and its neighbouring floats (t / s_out never
    equals one: a midpoint's odd part has 25 bits)."""
    r_out = np.float32(1) / np.float32(s_out)
    q = t * torch.tensor(r_out, dtype=torch.float32)
    n = torch.round(q)
    m = torch.where(q > n, n + 0.5, n - 0.5)
    bits = m.view(torch.int32)
    up_bits = torch.where(m > 0, bits + 1, bits - 1)
    down_bits = torch.where(m > 0, bits - 1, bits + 1)
    up, down = up_bits.view(torch.float32), down_bits.view(torch.float32)
    hi = 0.5 * (m.double() + up.double())
    lo = 0.5 * (m.double() + down.double())
    s = float(np.float32(s_out))
    above, below = t.double() - hi * s, t.double() - lo * s
    assert not ((above == 0) | (below == 0)).any()
    v = torch.where(above > 0, m + 0.5,
                    torch.where(below < 0, m - 0.5, torch.round(m)))
    v = torch.where(torch.isnan(q), torch.tensor(-127.0), v)
    return v.clamp(-127, 127)


def requantize(t, s_out):
    """The kernel's requantize: link_byte where it is sure,
    requantize_near elsewhere; the division for a step out of range."""
    if not STEP_RANGE[0] <= np.float32(s_out) <= STEP_RANGE[1]:
        v = torch.round(conv_int8.fdiv(t, s_out))
        return torch.where(torch.isnan(v), torch.tensor(-127.0), v).clamp(
            -127, 127).to(torch.int8)
    n, unsure = link_byte(t, s_out)
    return torch.where(unsure, requantize_near(t, s_out), n).to(torch.int8)


def _box(xn, b, y, x, c0, th, tw, kc):
    """The TMA box at (c0, x, y, b): th×tw×kc, zero outside the image."""
    _, H, W, _ = xn.shape
    box = torch.zeros((th, tw, kc), dtype=torch.int64)
    ya, yb = max(y, 0), min(y + th, H)
    xa, xb = max(x, 0), min(x + tw, W)
    if ya < yb and xa < xb:
        box[ya - y:yb - y, xa - x:xb - x] = xn[b, ya:yb, xa:xb,
                                               c0:c0 + kc].long()
    return box


def kernel_model(x, qw, scale, bias, *, dilation=1, relu=True, s_out=None,
                 tile=None):
    """Q1's schedule on the CPU (arguments as ``conv3x3_int8``; ``tile``
    overrides the wrapper's (TH, TW)). Returns (out, writes): writes
    counts the stores each output pixel got."""
    B, C, H, W = x.shape
    O = qw.shape[0]
    th, tw, bn, kc = conv_int8.plan(H, W, C, O)
    if tile is not None:
        th, tw = tile
    assert th * tw == conv_int8.TILE_M and C % kc == 0 and O % bn == 0
    xn = x.permute(0, 2, 3, 1)
    wk = qw.reshape(O, 9 * C).long()
    out = torch.zeros((B, H, W, O), dtype=torch.float32 if s_out is None
                      else torch.int8)
    writes = torch.zeros((B, H, W, O), dtype=torch.int32)
    rows = torch.arange(conv_int8.TILE_M)
    ry, rx = rows // tw, rows % tw
    for b, ty, tx, nt in itertools.product(range(B), range(-(-H // th)),
                                           range(-(-W // tw)), range(O // bn)):
        y0, x0, n0 = ty * th, tx * tw, nt * bn
        acc = torch.zeros((conv_int8.TILE_M, bn), dtype=torch.int64)
        for k in range(9 * C // kc):
            tap, c0 = divmod(k, C // kc)
            c0 *= kc
            ky, kx = divmod(tap, 3)
            a = _box(xn, b, y0 + (ky - 1) * dilation,
                     x0 + (kx - 1) * dilation, c0, th, tw, kc)
            acc += a.reshape(-1, kc) @ wk[n0:n0 + bn,
                                          tap * C + c0:tap * C + c0 + kc].T
        assert acc.abs().max() < 2 ** 31
        t = acc.to(torch.int32).float() * scale[b if scale.shape[0] > 1
                                                else 0, n0:n0 + bn]
        t = t + bias[n0:n0 + bn]
        if relu:
            t = torch.relu(t)
        if s_out is not None:
            t = requantize(t, s_out)
        y, xx = y0 + ry, x0 + rx
        keep = (y < H) & (xx < W)
        out[b, y[keep], xx[keep], n0:n0 + bn] = t[keep]
        writes[b, y[keep], xx[keep], n0:n0 + bn] += 1
    return out.permute(0, 3, 1, 2), writes


def _check(B, H, W, C, O, dilation, epilogue, seed=0, tile=None,
           extreme=False):
    relu, int8_out = EPILOGUES[epilogue]
    x, w, scale, bias = _inputs(seed, B, H, W, C, O, epilogue == "dynamic",
                                extreme)
    kw = dict(dilation=dilation, relu=relu,
              s_out=S_OUT if int8_out else None)
    got, writes = kernel_model(x, w, scale, bias, tile=tile, **kw)
    want = conv_int8.conv3x3_int8_reference(x, w, scale, bias, **kw)
    assert torch.equal(writes, torch.ones_like(writes))
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    # the wrapper on the CPU is the plain version itself
    assert torch.equal(conv_int8.conv3x3_int8(x, w, scale, bias, **kw), want)


@pytest.mark.parametrize("B,H,W,C,O,dilation,epilogue", [
    (2, 19, 23, 64, 128, 1, "link"),        # ragged H and W
    (2, 19, 23, 64, 128, 2, "end"),
    (2, 19, 23, 64, 128, 4, "dynamic"),
    (2, 40, 5, 64, 128, 2, "link"),         # W smaller than a tile
    (1, 1, 37, 64, 128, 1, "link"),         # H = 1
    (1, 1, 37, 32, 64, 4, "end"),
    (1, 3, 3, 128, 128, 4, "end"),          # dilation 4 beyond the image
    (1, 3, 3, 64, 128, 4, "link"),
    (3, 17, 30, 64, 128, 1, "dynamic"),     # B = 3, a scale row per image
    (3, 5, 9, 256, 256, 2, "dynamic"),
])
def test_kernel_model_edges(B, H, W, C, O, dilation, epilogue):
    _check(B, H, W, C, O, dilation, epilogue)


@pytest.mark.parametrize("C,O", [(32, 64), (64, 128), (512, 512), (512, 128)])
@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_kernel_model_channel_counts(C, O, epilogue):
    """Every K chunk (32, 64, 128 bytes) and channel block the plan takes."""
    _check(1, 3, 10, C, O, 1, epilogue, seed=C + O)


@pytest.mark.parametrize("tile", conv_int8.TILE_SHAPES)
def test_kernel_model_every_tile_shape(tile):
    _check(2, 21, 45, 64, 128, 2, "link", seed=7, tile=tile, extreme=True)


def test_kernel_model_matches_jax_chain():
    """One calibrated link through the model against JAX conv2d_int8_chain
    on the same int8 values and prebaked weights: equal to the bit."""
    rng = np.random.RandomState(3)
    w = rng.randn(3, 3, 64, 128).astype(np.float32) * 0.1
    b = rng.randn(128).astype(np.float32) * 0.1
    q = rng.randint(-128, 128, (2, 9, 21, 64)).astype(np.int8)
    s_in, s_out = np.float32(0.0371), np.float32(0.0496)
    jqw, js = jl.quantize_weights_int8(jnp.asarray(w))
    want = np.asarray(jl.conv2d_int8_chain(
        jnp.asarray(q), jqw, s_in, js, jnp.asarray(b), dilation=2, padding=2,
        s_out=s_out))
    tqw, ts = tl.quantize_weights_int8(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    got, _ = kernel_model(
        torch.from_numpy(q).permute(0, 3, 1, 2), tl.kernel_weights(tqw),
        (ts * float(s_in))[None], torch.from_numpy(b), dilation=2,
        s_out=float(s_out))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("s_out", [0.0371, 0.0496, 0.5, 1.0, 3.0, 2.0 ** -60,
                                   1e-30])
def test_requantize_rounds_as_the_division(s_out):
    """On ties (t = (k + ½)·s exactly where s is a power of two), on values
    a few ulps either side of fl((k + ½)·s), on random magnitudes from 1e-8
    to 1e4 and on ±inf and NaN: where link_byte claims to be sure it
    gives the division's integer, requantize_near gives it wherever
    link_byte is unsure, and the two together (or the division, for
    a step out of range) equal the plain version's requantize; the near
    path is needed rarely."""
    rng = np.random.RandomState(int(s_out * 1e4) % 2 ** 31)
    s = np.float32(s_out)
    half = ((np.arange(-3, 140) + np.float32(0.5)) * s).astype(np.float32)
    near = np.concatenate([np.nextafter(half, np.float32(np.inf) * d)
                           for d in (-1, 1)] + [half])
    for _ in range(3):
        near = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                               np.nextafter(near, np.float32(-np.inf))])
    spread = (10.0 ** rng.uniform(-8, 4, 200000)).astype(np.float32)
    spread[::2] = rng.uniform(0, 128, 100000) * s          # q in [0, 128)
    t = torch.from_numpy(np.concatenate([
        near, spread, -spread[:1000], np.float32([0, np.inf, -np.inf]),
        np.float32([np.nan])]))
    want = torch.round(conv_int8.fdiv(t, s_out))
    want = torch.where(torch.isnan(want), torch.tensor(-127.0), want).clamp(
        -127, 127)
    assert torch.equal(requantize(t, s_out), want.to(torch.int8))
    if STEP_RANGE[0] <= s <= STEP_RANGE[1]:
        n, unsure = link_byte(t, s_out)
        assert torch.equal(n[~unsure], want[~unsure])
        assert torch.equal(requantize_near(t[unsure], s_out), want[unsure])
        assert unsure[len(near):-4].float().mean() < 5e-4
        assert unsure[:len(near)].any() and unsure[-1]


def _level_shapes(h, w):
    """(H, W, C, O) of the int8 convolutions of one pyramid level (h, w the
    network input), as the calibrated chain runs them: stages 2-5, then
    the fusion convs and the head at stride 8."""
    h, w, c, rows = h // 2, w // 2, 64, []
    for stage, (o, n) in enumerate(((128, 2), (256, 3), (512, 3),
                                    (512, 3))):
        for _ in range(n):
            rows.append((h, w, c, o))
            c = o
        if stage == 2:                       # conv4, at stride 8
            h8, w8 = h, w
        h, w = -(-h // 2), -(-w // 2)
    return rows + [(h8, w8, 512, 512), (h8, w8, 512, 128)] + [
        (h8, w8, 128, 128)] * 3


@pytest.mark.parametrize("hw", [(112, 144), (304, 400), (608, 800),
                                (1008, 1344), (1408, 1872), (16, 16)])
def test_plan_covers_every_level(hw):
    """The plan's tile is one of the kernel's, covers H×W with the fewest
    padded pixels of any of them, and its K chunk and channel block divide
    C and O, at every int8 layer of the pyramid levels of a 768×1024
    image."""
    for H, W, C, O in _level_shapes(*hw):
        th, tw, bn, kc = conv_int8.plan(H, W, C, O)
        assert (th, tw) in conv_int8.TILE_SHAPES and th * tw == 128
        assert tw >= 8 and tw & (tw - 1) == 0
        assert kc in conv_int8.K_CHUNKS and C % kc == 0
        assert kc == max(k for k in conv_int8.K_CHUNKS if C % k == 0)
        assert bn == max(n for n in conv_int8.BLOCK_NS if O % n == 0)
        padded = -(-H // th) * th * -(-W // tw) * tw
        assert padded == min(-(-H // a) * a * -(-W // b) * b
                             for a, b in conv_int8.TILE_SHAPES)


def _ring(total, grid, nk, stages):
    """The persistent grid's producer and consumers on one block's ring, as
    the kernel runs them: each side walks its tiles (blockIdx.x, +grid, …)
    and K steps with its own (stage, phase) counters; the producer waits on
    empty[s] at parity phase^1, the consumers on full[s] at phase, and a
    barrier passes a wait at parity P once its phase count's parity is not
    P. Interleaved one step at a time; returns, per block, the (tile, k)
    each consumer step read."""
    reads = {}
    for blk in range(min(grid, total)):
        work = [(t, k) for t in range(blk, total, grid) for k in range(nk)]
        full, empty = [0] * stages, [0] * stages     # completed phases
        slot = [None] * stages
        prod = {"i": 0, "s": 0, "ph": 0}
        cons = {"i": 0, "s": 0, "ph": 0, "held": None}
        got = []
        while cons["i"] < len(work) or cons["held"] is not None:
            moved = False
            if prod["i"] < len(work) and empty[prod["s"]] % 2 != \
                    prod["ph"] ^ 1:
                assert slot[prod["s"]] is None      # never overwrite
                slot[prod["s"]] = work[prod["i"]]
                full[prod["s"]] += 1
                prod["i"] += 1
                prod["s"] = (prod["s"] + 1) % stages
                prod["ph"] ^= prod["s"] == 0
                moved = True
            if cons["i"] < len(work) and full[cons["s"]] % 2 != cons["ph"]:
                got.append(slot[cons["s"]])
                # the step before this one retires: its stage is released
                if cons["held"] is not None and work[cons["i"]][1] > 0:
                    slot[cons["held"]] = None
                    empty[cons["held"]] += 1
                    cons["held"] = None
                if work[cons["i"]][1] == nk - 1:    # the tile's last step
                    slot[cons["s"]] = None
                    empty[cons["s"]] += 1
                else:
                    cons["held"] = cons["s"]
                cons["i"] += 1
                cons["s"] = (cons["s"] + 1) % stages
                cons["ph"] ^= cons["s"] == 0
                moved = True
            assert moved, "the ring deadlocked"
        reads[blk] = (got, work)
    return reads


@pytest.mark.parametrize("total,grid,nk,stages", [
    (132 * 2 + 5, 132, 18, 7),     # unequal tile counts: the tail blocks
    (7, 132, 36, 4),               # fewer tiles than SMs
    (300, 132, 9, 8),              # nk shorter than the ring
    (133, 132, 1, 3),              # one K step a tile
])
def test_persistent_ring_reads_every_step_in_order(total, grid, nk, stages):
    for got, work in _ring(total, grid, nk, stages).values():
        assert got == work
    counts = [len(range(b, total, grid)) for b in range(min(grid, total))]
    assert sum(counts) == total
