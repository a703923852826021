"""The port's layers (smallhardface_tpu_torch/models/layers.py) against the
JAX package's (smallhardface_tpu/models/layers.py) on the same seeded
inputs. Both are true fp32 on the CPU: rtol 1e-5, atol 1e-5·max|ref|."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.models import layers as jl
from smallhardface_tpu_torch.models import layers as tl
import torch_threads  # noqa: F401

RTOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_conv2d_dilations(dilation):
    rng = np.random.RandomState(dilation)
    x = rng.randn(2, 20, 24, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(jl.conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), dilation=dilation,
                                padding=dilation))
    got = tl.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                    torch.from_numpy(b), dilation=dilation,
                    padding=dilation)
    assert got.shape == (2, 5, 20, 24)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("hw", [(11, 13), (10, 12), (1, 3)])
def test_max_pool_ceil_mode(hw):
    rng = np.random.RandomState(sum(hw))
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jl.max_pool_2x2(jnp.asarray(x)))
    got = _nhwc(tl.max_pool_2x2(_nchw(x)))
    assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 3)
    np.testing.assert_array_equal(got, want)


def test_bilinear_kernel_is_the_jax_kernel():
    np.testing.assert_array_equal(tl.bilinear_kernel(2, 7),
                                  jl.bilinear_kernel(2, 7))


@pytest.mark.parametrize("kernel", ["bilinear", "random"])
def test_upsample2x_bilinear(kernel):
    """The grouped transposed conv equals the JAX fractionally-strided conv,
    for the symmetric bilinear kernel and for an asymmetric one."""
    rng = np.random.RandomState(5)
    c = 6
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    w = (jl.bilinear_kernel(2, c) if kernel == "bilinear"
         else rng.randn(4, 4, 1, c).astype(np.float32))
    want = np.asarray(jl.upsample2x_bilinear(jnp.asarray(x), jnp.asarray(w)))
    got = _nhwc(tl.upsample2x_bilinear(
        _nchw(x), torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1)))))
    assert got.shape == want.shape == (2, 10, 14, c)
    _close(got, want)


@pytest.mark.parametrize("dilation,hw", [
    (1, (20, 24)), (2, (20, 24)), (4, (20, 24)), (4, (3, 5)), (1, (1, 1))])
def test_conv3x3_taps_matches_jax(dilation, hw, monkeypatch):
    """The nine-product form of a 3×3 convolution (the route of large
    detection convolutions, models/layers.py:conv3x3) equals the JAX conv,
    also where the dilation exceeds the image, keeps channels_last, and
    gives the same when its scratch budget takes one image at a time."""
    rng = np.random.RandomState(10 + dilation + hw[0])
    x = rng.randn(2, *hw, 8).astype(np.float32) * 10
    w = rng.randn(3, 3, 8, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(jl.conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), dilation=dilation,
                                padding=dilation))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tl.conv3x3_taps(xt, wt, torch.from_numpy(b), dilation=dilation)
    assert got.shape == (2, 5, *hw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(_nhwc(got), want)
    again = tl.conv3x3_taps(xt, wt, torch.from_numpy(b), dilation=dilation)
    assert torch.equal(got, again)
    monkeypatch.setattr(tl, "TAPS_SCRATCH_BYTES", 1)
    _close(_nhwc(tl.conv3x3_taps(xt, wt, torch.from_numpy(b),
                                 dilation=dilation)), want)


def test_conv3x3_route(monkeypatch):
    """conv3x3 takes the nine products only without autograd and from
    TAPS_MIN_FLOP up, otherwise cuDNN's conv2d. Where autograd records an
    fp32 call (x, w or b needs a gradient) the forward is still conv2d's
    and the backward the adjoint's (Conv3x3Adjoint); a bf16 call stays on
    conv2d's bf16 product, and cuDNN's backward, under autograd. Each
    backward counts on its route."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, 6, 7).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 8, 3, 3).astype(np.float32))
    b = torch.zeros(4)
    taps = tl.conv3x3_taps(x, w, b, dilation=2)
    plain = tl.conv2d(x, w, b, dilation=2, padding=2)
    flop = 18.0 * 6 * 7 * 8 * 4
    for threshold, grad, want in ((flop, False, taps), (flop + 1, False,
                                                        plain),
                                  (0, True, plain)):
        monkeypatch.setattr(tl, "TAPS_MIN_FLOP", threshold)
        with torch.set_grad_enabled(grad):
            assert torch.equal(tl.conv3x3(x, w, b, dilation=2), want)
    monkeypatch.setattr(tl.conv3x3, "adjoint_backwards", 0)
    monkeypatch.setattr(tl.conv3x3, "cudnn_backwards", 0)
    for xi, wi, bi in ((x, w.clone().requires_grad_(), b),
                       (x.clone().requires_grad_(), w, b),
                       (x, w, b.clone().requires_grad_())):
        y = tl.conv3x3(xi, wi, bi, dilation=2)
        assert torch.equal(y, plain)
        assert type(y.grad_fn).__name__ == "Conv3x3AdjointBackward"
        y.sum().backward()
    assert (tl.conv3x3.adjoint_backwards, tl.conv3x3.cudnn_backwards) == (
        3, 0)
    x16 = x.to(torch.bfloat16).requires_grad_()
    y16 = tl.conv3x3(x16, w, b, dilation=2)
    assert y16.dtype == torch.bfloat16
    assert type(y16.grad_fn).__name__ != "Conv3x3AdjointBackward"
    assert torch.equal(y16, tl.conv2d(x.to(torch.bfloat16), w, b,
                                      dilation=2, padding=2))
    y16.float().sum().backward()
    assert (tl.conv3x3.adjoint_backwards, tl.conv3x3.cudnn_backwards) == (
        3, 1)


def _tf32_rna_model(a):
    """NumPy model of ``cvt.rna.tf32.f32`` in float64: a normal a rounded
    to 11 significant bits (10 fraction bits), a subnormal one to the grid
    of 2^-136 (TF32's own subnormal step), to nearest, ties away from
    zero."""
    a = np.asarray(a, np.float64)
    mant, exp = np.frexp(a)                 # |mant| in [0.5, 1)
    step = np.where(np.abs(a) >= 2.0 ** -126, np.ldexp(1.0, exp - 11),
                    2.0 ** -136)
    q = a / step                            # exact: a power-of-two scaling
    return np.sign(q) * np.floor(np.abs(q) + 0.5) * step


@pytest.mark.parametrize("kind", ["normal", "ties", "wide", "subnormal"])
def test_tf32_split_matches_a_numpy_model(kind):
    """``ops/conv_fp32``'s plain TF32 rounding (C1's split of x in
    registers and of w in its scratch) against a NumPy model of
    ``cvt.rna.tf32.f32``: hi is the model's rounding of a and a TF32
    pattern (its 13 low fraction bits 0), lo the model's rounding of
    a - hi, and hi + lo is a to 2^-22 of |a| where a - hi is no subnormal
    (whose TF32 step is coarser)."""
    from smallhardface_tpu_torch.ops import conv_fp32
    rng = np.random.RandomState(["normal", "ties", "wide",
                                 "subnormal"].index(kind))
    if kind == "ties":          # exactly half a TF32 step above a pattern
        bits = (rng.randint(0x0c000000, 0x7e000000, 4096) & ~0x1fff) | 0x1000
        a = bits.astype(np.uint32).view(np.float32)
    elif kind == "wide":
        a = (rng.randn(4096) * 2.0 ** rng.randint(-90, 90, 4096))
    elif kind == "subnormal":
        a = rng.randn(4096) * 2.0 ** -130
    else:
        a = rng.randn(4096)
    a = (np.asarray(a, np.float32) * np.where(rng.rand(4096) < 0.5, -1, 1)
         ).astype(np.float32)
    hi, lo = conv_fp32.tf32_split(torch.from_numpy(a))
    hi, lo = hi.numpy(), lo.numpy()
    assert not (hi.view(np.uint32) & 0x1fff).any()
    assert not (lo.view(np.uint32) & 0x1fff).any()
    np.testing.assert_array_equal(hi.astype(np.float64), _tf32_rna_model(a))
    rest = a.astype(np.float64) - hi
    assert np.array_equal(rest.astype(np.float32).astype(np.float64), rest)
    np.testing.assert_array_equal(lo.astype(np.float64),
                                  _tf32_rna_model(rest))
    if kind != "subnormal":
        a64 = a.astype(np.float64)
        assert (np.abs(a64 - hi - lo) <= 2.0 ** -22 * np.abs(a64)).all()
    if kind == "ties":          # away from zero: the magnitude goes up
        assert (np.abs(hi) > np.abs(a)).all()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("halo", [(0, 0), (2, 0), (0, 2), (2, 2)])
def test_conv3x3_fp32_route_on_cpu(halo, relu, monkeypatch):
    """From TAPS_MIN_FLOP up under no_grad, conv3x3 goes to
    ``conv3x3_fp32``, whose CPU path is its plain version: the nine
    products (``conv3x3_taps``), then the ReLU where asked; no kernel
    launches. At any channel count: the CPU path takes what C1 refuses."""
    from smallhardface_tpu_torch.ops import conv_fp32
    rng = np.random.RandomState(20 + sum(halo) + relu)
    x = torch.from_numpy(rng.randn(2, 8, 9, 7).astype(np.float32)
                         ).contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randn(6, 8, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(6).astype(np.float32))
    want = tl.conv3x3_taps(x, w, b, dilation=2, halo=halo)
    if relu:
        want = torch.relu(want)
    monkeypatch.setattr(tl, "TAPS_MIN_FLOP", 0.0)
    monkeypatch.setattr(conv_fp32.conv3x3_fp32, "launches", 0)
    with torch.no_grad():
        got = tl.conv3x3(x, w, b, dilation=2, halo=halo, relu=relu)
    assert got.shape == (2, 6, 9 - sum(halo), 7)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert torch.equal(conv_fp32.conv3x3_fp32(x, w, b, dilation=2, halo=halo,
                                              relu=relu), want)
    assert conv_fp32.conv3x3_fp32.launches == 0
    monkeypatch.setattr(tl, "TAPS_MIN_FLOP", float("inf"))
    with torch.no_grad():
        cudnn = tl.conv3x3(x, w, b, dilation=2, halo=halo, relu=relu)
    _close(_nhwc(cudnn), _nhwc(want))


@pytest.mark.parametrize("C,O", [(96, 64), (64, 96), (32, 128), (64, 3)])
def test_conv3x3_fp32_refuses_channel_counts(C, O):
    """Off the CPU the wrapper launches C1 or raises: C and O must be
    multiples of 64 (its K steps and channel blocks). The check comes
    before any launch, so a tensor without data (device "meta") shows it
    here."""
    from smallhardface_tpu_torch.ops import conv_fp32
    before = conv_fp32.conv3x3_fp32.launches
    x = torch.empty((1, C, 8, 8), device="meta")
    w = torch.empty((O, C, 3, 3), device="meta")
    with pytest.raises(ValueError, match="multiples of 64"):
        conv_fp32.conv3x3_fp32(x, w, torch.empty(O, device="meta"))
    with pytest.raises(ValueError, match="float32 CUDA tensors"):
        conv_fp32.conv3x3_fp32(torch.empty((1, 64, 8, 8), device="meta"),
                               torch.empty((64, 64, 3, 3), device="meta"),
                               torch.empty(64, device="meta"))
    assert conv_fp32.conv3x3_fp32.launches == before


def _conv3x3_vjp_jax(x, w, b, dy, dilation, halo):
    """(y, dx, dw, db) of the JAX package's conv2d at padding ``dilation``
    with a shard's halo rows: the own rows of the symmetric convolution
    (a halo side reads real rows where the zero padding would be), and
    its vjp, on NHWC / HWIO arrays."""
    top, bottom = halo
    H = x.shape[1]

    def f(x, w, b):
        return jl.conv2d(x, w, b, dilation=dilation,
                         padding=dilation)[:, top:H - bottom]
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return (np.asarray(y), *(np.asarray(g) for g in vjp(jnp.asarray(dy))))


@pytest.mark.parametrize("need_x", [True, False])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("halo", ["none", "bottom", "top", "both"])
@pytest.mark.parametrize("dilation,hw", [
    (1, (20, 24)), (2, (20, 24)), (4, (20, 24)), (4, (9, 5))])
def test_conv3x3_adjoint_matches_jax(dilation, hw, halo, batch, need_x):
    """conv3x3 under autograd (Conv3x3Adjoint): the forward equals cuDNN's
    conv2d path to the bit, and the backward (the nine products'
    adjoint, conv3x3_taps_grad) gives JAX's vjp of its conv2d, for dx
    (the halo rows included, channels_last), dw and db; at dilations 1, 2,
    4 and one wider than the image, with halos (0, 0), (0, d), (d, 0),
    (d, d), batch 1 and 2, with x taking a gradient or not (then none is
    computed); the same bits twice."""
    d = dilation
    top, bottom = {"none": (0, 0), "bottom": (0, d), "top": (d, 0),
                   "both": (d, d)}[halo]
    rng = np.random.RandomState(20 + d + hw[0] + 3 * top + bottom + batch)
    x = rng.randn(batch, hw[0] + top + bottom, hw[1], 8).astype(
        np.float32) * 10
    w = rng.randn(3, 3, 8, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    dy = rng.randn(batch, *hw, 5).astype(np.float32)
    y_j, dx_j, dw_j, db_j = _conv3x3_vjp_jax(x, w, b, dy, d, (top, bottom))

    def run():
        xt = _nchw(x).contiguous(
            memory_format=torch.channels_last).requires_grad_(need_x)
        wt = torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1))).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        y = tl.conv3x3(xt, wt, bt, dilation=d, halo=(top, bottom))
        assert type(y.grad_fn).__name__ == "Conv3x3AdjointBackward"
        with torch.no_grad():
            assert torch.equal(y, tl.conv3x3_cudnn(xt, wt, bt, d,
                                                   (top, bottom)))
        y.backward(_nchw(dy))
        return y, xt.grad, wt.grad, bt.grad

    y, dx, dw, db = run()
    assert y.shape == (batch, 5, *hw)
    _close(_nhwc(y.detach()), y_j)
    if need_x:
        assert dx.is_contiguous(memory_format=torch.channels_last)
        _close(_nhwc(dx), dx_j)
    else:
        assert dx is None
    _close(dw.permute(2, 3, 1, 0).numpy(), dw_j)
    _close(db.numpy(), db_j)
    again = run()
    for g, g2 in zip((dx, dw, db), again[1:]):
        assert g is g2 is None or torch.equal(g, g2)


def test_conv3x3_adjoint_gradcheck():
    """Conv3x3Adjoint's backward is the Jacobian's transpose of its
    forward (torch.autograd.gradcheck in float64), with a halo on one
    side, at a small shape."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 3, 7, 6)).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    w = torch.from_numpy(rng.randn(4, 3, 3, 3)).requires_grad_()
    b = torch.from_numpy(rng.randn(4)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w, b: tl.Conv3x3Adjoint.apply(x, w, b, 2, (0, 2)),
        (x, w, b))
