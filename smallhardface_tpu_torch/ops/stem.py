"""Fused VGG stem: conv1_1 + ReLU + conv1_2 + ReLU + 2×2/2 max pool, and
its backward.

Counterpart of ``smallhardface_tpu/ops/pallas_stem.py``: the TPU kernel
``_kernel`` (pallas_stem.py:69), reached through ``_stem_call`` /
``_stem_op`` / ``fused_stem``, becomes the CUDA C++ kernel ``csrc/stem.cu``
(K1), and its backward ``_grad_kernel`` (pallas_stem.py:460, reached through
``_stem_grad_call`` / ``_stem_op_bwd``) becomes ``csrc/stem_grad.cu`` (K2),
both for Hopper (sm_90a). Each source's header says what bounds it on an
H100 and what the design does about that.

- ``fused_stem_reference``: the plain PyTorch forward (two ``F.conv2d``,
  the masks, ``max_pool2d``). The CPU path and K1's oracle.
- ``fused_stem``: the differentiable wrapper. On a CPU tensor it is the
  plain version and autograd differentiates it. On a CUDA tensor it runs
  ``StemFunction``: the forward launches K1, the backward launches K2
  (only when a weight needs a gradient), or it raises; it never falls
  back. ``fused_stem.launches`` counts K1's launches.
- ``fused_stem_grad_reference``: the plain backward, ``torch.autograd.grad``
  through ``fused_stem_reference`` with dy zeroed beyond the pooled valid
  extent. K2's oracle.
- ``fused_stem_grad``: K2's wrapper, d(w1, b1, w2, b2) given dy; the image
  gets no gradient (pallas_stem.py:753-756). ``fused_stem_grad.launches``
  counts K2's launches.
- ``fused_stem_grad_products``: K2's products in plain PyTorch on a given
  routing (conv1_1's activations and the routed gradient dpre2, K2's own
  scratch on the card): the check of K2's tensor-core arithmetic alone,
  with no pool or ReLU flip in it.
- ``STEM`` / ``STEM_GRAD``: the two kernel libraries, built with ``nvcc`` at
  first use into ``csrc/build/`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.models.layers import zero_outside
from smallhardface_tpu_torch.ops.cuda_build import CI, VP, CudaLibrary

STEM = CudaLibrary("stem", "stem.cu",
                   {"shf_stem_forward": [VP] * 6 + [CI] * 5 + [VP]})
STEM_GRAD = CudaLibrary("stem_grad", "stem_grad.cu",
                        {"shf_stem_grad": [VP] * 13 + [CI] * 7 + [VP]})
GRAD_CHUNKS = 256       # pixel chunks of K2's weight gradient (fixed order)
_KT = 32                # pixels per step of that gradient (stem_grad.cu)
_W2F_SPLIT = 9 * 64 * 64 * 2   # w2f as TF32 hi/lo fragments (stem_grad.cu)


def fused_stem_reference(x, w1, b1, w2, b2, valid_hw=None):
    """Plain PyTorch stem. x: NHWC (B, H, W, 3) fp32; w1 (64, 3, 3, 3) and
    w2 (64, 64, 3, 3) OIHW. With ``valid_hw=(vh, vw)`` the input and the
    conv1_1 activations are zero outside [0, vh) × [0, vw) before each conv
    reads them (pallas_stem.py:98-104, :120-123). Pooling keeps Caffe's
    ceil mode, so odd sizes work here. Returns NHWC (B, ⌈H/2⌉, ⌈W/2⌉, 64)."""
    h = x.permute(0, 3, 1, 2)
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    h = F.relu(F.conv2d(h, w1, b1, padding=1))
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    h = F.relu(F.conv2d(h, w2, b2, padding=1))
    h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    return h.permute(0, 2, 3, 1).contiguous()


def fused_stem_grad_reference(x, dy, w1, b1, w2, b2, valid_hw=None):
    """Plain backward: (dw1, db1, dw2, db2), OIHW like the weights, of
    sum(fused_stem_reference(x, w…) * dy), with dy zero at pooled
    positions (q, p) with 2q >= vh or 2p >= vw (pallas_stem.py:520-525).
    max_pool2d's backward sends each window's gradient to its first
    maximal element in row-major order and ReLU's where the activation is
    > 0, the semantics of the TPU kernel."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in (w1, b1, w2, b2)]
        out = fused_stem_reference(x.detach(), *ws, valid_hw=valid_hw)
        if valid_hw is not None:
            dy = zero_outside(dy.permute(0, 3, 1, 2), (valid_hw[0] + 1) // 2,
                              (valid_hw[1] + 1) // 2).permute(0, 2, 3, 1)
        return tuple(torch.autograd.grad(out, ws, dy))


def _check(t, name, shape, what="fused_stem"):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be a CUDA float32 tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                         "aligned")


def _kernel_shapes(x, what):
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"{what}: x must be (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    B, H, W, _ = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"{what}: the kernel needs even H and W, got "
                         f"{H}x{W}")
    return B, H, W


def _hwio(w1, w2):
    """OIHW → the kernels' HWIO: w1 as (27, 64) rows (dy, dx, ci), w2 as 9
    taps of (ci, co), the JAX package's layout."""
    return (w1.detach().permute(2, 3, 1, 0).contiguous(),
            w2.detach().permute(2, 3, 1, 0).contiguous())


def _valid(H, W, valid_hw):
    return (H, W) if valid_hw is None else (int(valid_hw[0]),
                                            int(valid_hw[1]))


def _stem_kernel(x, w1, b1, w2, b2, valid_hw):
    """Launch K1 on the current stream."""
    B, H, W = _kernel_shapes(x, "fused_stem")
    w1k, w2k = _hwio(w1, w2)
    b1, b2 = b1.detach(), b2.detach()
    _check(x, "x", (B, H, W, 3))
    _check(w1k, "w1", (3, 3, 3, 64))
    _check(b1, "b1", (64,))
    _check(w2k, "w2", (3, 3, 64, 64))
    _check(b2, "b2", (64,))
    vh, vw = _valid(H, W, valid_hw)
    lib = STEM.load()
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    STEM.check(lib.shf_stem_forward(
        x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, H, W, vh, vw, stream),
        "fused_stem")
    fused_stem.launches += 1
    return out


class StemFunction(torch.autograd.Function):
    """The stem on the card: K1 forward, K2 backward. The image carries no
    gradient (conv1_1 reads the input; pallas_stem.py:753-756)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, valid_hw):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.valid_hw = valid_hw
        return _stem_kernel(x, w1, b1, w2, b2, valid_hw)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        grads = fused_stem_grad(x, dy.contiguous(), w1, b1, w2, b2,
                                ctx.valid_hw)
        return (None, *grads, None)


def fused_stem(x, w1, b1, w2, b2, valid_hw=None):
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2) → 2×2/2 max pool,
    with exact valid-extent masking (see ``fused_stem_reference``).

    x: NHWC (B, H, W, 3) float32, contiguous; weights OIHW as the port
    keeps them. On a CPU tensor this is the plain version. On a CUDA
    tensor it launches K1 on the current stream (H and W must be even) or
    raises, and its gradient with respect to the weights launches K2; it
    never falls back. Returns NHWC (B, H/2, W/2, 64).
    """
    if x.device.type != "cuda":
        return fused_stem_reference(x, w1, b1, w2, b2, valid_hw)
    return StemFunction.apply(x, w1, b1, w2, b2, valid_hw)


fused_stem.launches = 0


def fused_stem_grad_products(x, c1, dpre2, w2, valid_hw=None):
    """K2's products on a given routing, in plain PyTorch: from c1 (conv1_1
    after its ReLU and mask) and dpre2 (the gradient routed through the
    pool and conv1_2's ReLU), both NHWC (B, H, W, 64), returns
    (dpre1 NHWC, dw1, db1, dw2, db2), the grads OIHW:
    dpre1 = (the data gradient of conv1_2) * (c1 > 0), dw2 and db2 from c1
    and dpre2, dw1 and db1 from the masked x and dpre1. Computes in the
    inputs' dtype."""
    h = x.permute(0, 3, 1, 2)
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    c = c1.permute(0, 3, 1, 2)
    d2 = dpre2.permute(0, 3, 1, 2)
    dc1 = torch.nn.grad.conv2d_input(c.shape, w2, d2, padding=1)
    d1 = torch.where(c > 0, dc1, torch.zeros_like(dc1))
    dw2 = torch.nn.grad.conv2d_weight(c, w2.shape, d2, padding=1)
    dw1 = torch.nn.grad.conv2d_weight(h, (c.shape[1], h.shape[1], 3, 3), d1,
                                      padding=1)
    return (d1.permute(0, 2, 3, 1), dw1, d1.sum((0, 2, 3)), dw2,
            d2.sum((0, 2, 3)))


def _grad_scratch(B, H, W, device):
    """K2's scratch: c1, dpre2, dpre1 NHWC (B, H, W, 64), w2f split into
    TF32 fragments, the chunk partials and the summed output, and the
    chunking of the weight gradient's pixels."""
    n_pix = B * H * W
    chunk_len = -(-n_pix // GRAD_CHUNKS)
    chunk_len = -(-chunk_len // _KT) * _KT
    n_chunk = -(-n_pix // chunk_len)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=device)
    return {"c1": new(B, H, W, 64), "dpre2": new(B, H, W, 64),
            "dpre1": new(B, H, W, 64),
            "w2f_split": torch.empty(_W2F_SPLIT, dtype=torch.int32,
                                     device=device),
            "partial": new(10, n_chunk, 64, 64), "out": new(10, 64, 64),
            "n_chunk": n_chunk, "chunk_len": chunk_len}


def _stem_grad_launch(x, dy, w1, b1, w2, b2, valid_hw=None):
    """Launch K2 on the current stream; counts nothing. Returns
    ((dw1, db1, dw2, db2) OIHW, its scratch from ``_grad_scratch``)."""
    B, H, W = _kernel_shapes(x, "fused_stem_grad")
    w1k, w2k = _hwio(w1, w2)
    # data-gradient weights: w2 flipped in both spatial axes, ci ↔ co
    w2f = w2.detach().flip(2, 3).permute(2, 3, 0, 1).contiguous()
    b1, b2 = b1.detach(), b2.detach()
    what = "fused_stem_grad"
    _check(x, "x", (B, H, W, 3), what)
    _check(dy, "dy", (B, H // 2, W // 2, 64), what)
    _check(w1k, "w1", (3, 3, 3, 64), what)
    _check(b1, "b1", (64,), what)
    _check(w2k, "w2", (3, 3, 64, 64), what)
    _check(b2, "b2", (64,), what)
    vh, vw = _valid(H, W, valid_hw)
    lib = STEM_GRAD.load()
    s = _grad_scratch(B, H, W, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    STEM_GRAD.check(lib.shf_stem_grad(
        x.data_ptr(), dy.data_ptr(), w1k.data_ptr(), b1.data_ptr(),
        w2k.data_ptr(), b2.data_ptr(), w2f.data_ptr(),
        s["w2f_split"].data_ptr(), s["c1"].data_ptr(), s["dpre2"].data_ptr(),
        s["dpre1"].data_ptr(), s["partial"].data_ptr(), s["out"].data_ptr(),
        B, H, W, vh, vw, s["n_chunk"], s["chunk_len"], stream), what)
    out = s["out"]
    dw2 = out[:9].reshape(3, 3, 64, 64).permute(3, 2, 0, 1).contiguous()
    dw1 = out[9, :27].reshape(3, 3, 3, 64).permute(3, 2, 0, 1).contiguous()
    return (dw1, out[9, 27].clone(), dw2, out[9, 28].clone()), s


def fused_stem_grad(x, dy, w1, b1, w2, b2, valid_hw=None):
    """(dw1, db1, dw2, db2), OIHW like the weights: the stem's weight
    gradients given dy (B, H/2, W/2, 64) NHWC. On a CPU tensor this is
    ``fused_stem_grad_reference``; on a CUDA tensor it launches K2 on the
    current stream or raises. The result is the same to the bit from run
    to run: K2 sums across blocks in a fixed order."""
    if x.device.type != "cuda":
        return fused_stem_grad_reference(x, dy, w1, b1, w2, b2, valid_hw)
    grads, _ = _stem_grad_launch(x, dy, w1, b1, w2, b2, valid_hw)
    fused_stem_grad.launches += 1
    return grads


fused_stem_grad.launches = 0
