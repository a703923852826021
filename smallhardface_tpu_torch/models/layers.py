"""Primitive NN ops for the detector, on NCHW-shaped tensors (the detector
keeps them in ``torch.channels_last`` memory format).

Counterpart of ``smallhardface_tpu/models/layers.py``: ``conv2d`` (:17-49),
the int8 mode's ``quantize_weights_int8``, ``conv2d_int8`` and
``conv2d_int8_chain`` (:52-157), ``max_pool_2x2`` (:159-178), also on int8
carriers, ``bilinear_kernel`` (:181-192) and ``upsample2x_bilinear``
(:195-213). Weights are OIHW, the PyTorch layout; ``io/weights.py``
converts from the JAX package's HWIO. The fp32 convolutions are cuDNN's,
or for the large 3×3 ones of detection nine cuBLAS products
(``conv3x3``): the JAX package leaves them to XLA outside any Pallas
kernel. The int8 3×3 products run through ``ops/conv_int8.conv3x3_int8``
(the kernel Q1 on the card).

On a bfloat16 input, ``conv2d``, ``conv3x3`` and ``upsample2x_bilinear``
compute what the JAX functions compute with ``compute_dtype=bfloat16``
(:29-46, :208-213): x and w rounded to bf16, exact products summed in
fp32, the sum rounded to bf16 once, and only then the bias, itself
rounded to bf16, added in bf16 (``bf16_product``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.ops.conv_int8 import conv3x3_int8, fdiv


def conv2d(x, w, b=None, *, dilation=1, padding=0):
    """Conv with explicit symmetric zero padding and dilation. For a 3×3
    kernel at dilation d the Caffe templates pad by d. On a bf16 x, the
    product rounds once to bf16 and the bf16 bias is added after it."""
    if x.dtype != torch.bfloat16:
        return F.conv2d(x, w, b, padding=padding, dilation=dilation)
    out = bf16_product(F.conv2d, x, w, padding=padding, dilation=dilation)
    if b is None:
        return out
    # in place on the product, which nothing else holds: no second output
    return out.add_(b.to(torch.bfloat16)[:, None, None])


def bf16_product(fn, x, w, **kwargs):
    """fn(x, w, **kwargs), a convolution, with x and w rounded to bf16, the
    products summed in fp32 and the sum rounded to bf16 once (the JAX
    package's ``preferred_element_type=float32`` then ``.astype(bf16)``),
    with no bias: a bias fused into the product would be added before the
    rounding. On the card fn runs on the bf16 tensors (cuDNN sums bf16 in
    fp32 and rounds its output once); on the CPU it runs in fp32 on the
    rounded values, whose products are exact in fp32, and the sum is
    rounded after it."""
    w = w.to(torch.bfloat16)
    if x.is_cuda:
        return fn(x, w, **kwargs)
    return fn(x.float(), w.float(), **kwargs).to(torch.bfloat16)


# From this many FLOP up, a 3×3 convolution of detection runs as nine
# channel products (conv3x3_taps): over the pyramid levels of WIDER-sized
# images, cuDNN's heuristic picks FFT algorithms for some convolutions
# above it, which took up to 0.53 s and 38 GB of workspace a call, while
# below it cuDNN is the faster of the two and picked none (PERF.md §5).
# 1.34e10 FLOP is 0.2 ms at the fp32 peak of an H100.
TAPS_MIN_FLOP = 1.34e10
# conv3x3_taps works through the batch a few images at a time, so that its
# padded input and output take at most this much beyond its output
TAPS_SCRATCH_BYTES = 2 ** 31


def conv3x3(x, w, b, *, dilation=1):
    """The forward's 3×3 convolutions, zero padding ``dilation``: under
    no_grad / inference_mode, those of at least TAPS_MIN_FLOP run as
    ``conv3x3_taps``, the rest (and all of training, where autograd runs
    cuDNN's backward) as cuDNN's ``conv2d``. Both are deterministic. A
    bf16 x always runs as ``conv2d``'s bf16 product."""
    B, C, H, W = x.shape
    if (x.dtype != torch.bfloat16 and not torch.is_grad_enabled()
            and 18.0 * B * H * W * C * w.shape[0] >= TAPS_MIN_FLOP):
        return conv3x3_taps(x, w, b, dilation=dilation)
    return conv2d(x, w, b, dilation=dilation, padding=dilation)


def conv3x3_taps(x, w, b, *, dilation=1):
    """A 3×3 convolution with zero padding ``dilation``, as nine channel
    products (``torch.addmm``) summed in a fixed order. x: (B, C, H, W) in
    channels_last memory; w: (O, C, 3, 3). Returns (B, O, H, W) in
    channels_last memory.

    The input is zero-padded by d = dilation and flattened to rows, one
    per pixel of the padded grid; the output is computed on the same grid.
    On that grid tap (ky, kx) reads the row s = (ky-1)·d·(W+2d) + (kx-1)·d
    away, so each tap is one product of a contiguous block of input rows,
    added in place to a contiguous block of output rows (beta = 1). Rows
    of the padding ring read across an edge and are cut away; every inner
    output reads only its own image's padded rows. The bias and the centre
    tap come first, then the other taps in row-major order, so the result
    is the same from run to run. The images go through in groups whose
    padded input and output fit TAPS_SCRATCH_BYTES (at least one image)."""
    B, C, H, W = x.shape
    O = w.shape[0]
    d = dilation
    Hp, Wp = H + 2 * d, W + 2 * d
    step = max(1, int(TAPS_SCRATCH_BYTES
                      // (x.element_size() * Hp * Wp * (C + O))))
    taps = w.permute(2, 3, 1, 0)                    # (3, 3, C, O)
    out = torch.empty((B, O, H, W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    for b0 in range(0, B, step):
        xb = x[b0:b0 + step].permute(0, 2, 3, 1)
        rows = F.pad(xb, (0, 0, d, d, d, d)).reshape(-1, C)
        acc = torch.addmm(b, rows, taps[1, 1])
        n = acc.shape[0]
        for ky in range(3):
            for kx in range(3):
                s = (ky - 1) * d * Wp + (kx - 1) * d
                if s:
                    lo, hi = max(0, -s), n - max(0, s)
                    acc[lo:hi].addmm_(rows[lo + s:hi + s], taps[ky, kx])
        out[b0:b0 + step] = acc.view(-1, Hp, Wp, O)[
            :, d:d + H, d:d + W].permute(0, 3, 1, 2)
    return out


def quantize_weights_int8(w):
    """Per-output-channel symmetric int8 quantization of OIHW weights:
    s_w = max(max|w|, 1e-12) / 127 over (I, H, W), qw = clip(round(w /
    s_w), -127, 127). Returns (qw int8 OIHW, s_w float32 (O,)), w ≈ qw·s_w;
    every division is a correctly rounded fp32 one, as in JAX."""
    s_w = fdiv(w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12), 127.0)
    qw = torch.round(torch.div(w, s_w[:, None, None, None]))
    return qw.clamp(-127, 127).to(torch.int8), s_w


def kernel_weights(qw):
    """OIHW int8 weights in the layout ``conv3x3_int8`` reads: (O, 3, 3,
    C), each output channel's K contiguous."""
    return qw.permute(0, 2, 3, 1).contiguous()


def quantize_int8(x, s):
    """The int8 carrier of x on the grid of step s (a number holding a
    float32, or a tensor broadcasting against x): clip(round(x / s), -127,
    127), a symmetric saturating clip."""
    return torch.round(fdiv(x, s)).clamp(-127, 127).to(torch.int8)


def dynamic_scales(x, groups=None):
    """The dynamic mode's activation step of each item of x (B, C, H, W):
    max(max|x|, 1e-12) / 127 over everything one JAX forward call of the
    item's group sees. ``groups`` (B,) int tensor: items with one id share
    one step; None: the whole batch shares one, as one JAX call over it
    does. Returns (B,) float32."""
    amax = x.abs().amax(dim=(1, 2, 3))
    if groups is None:
        amax = amax.amax().expand(x.shape[0])
    else:
        same = groups[:, None] == groups[None, :]
        amax = torch.where(same, amax[None, :], 0.0).amax(dim=1)
    return fdiv(amax.clamp_min(1e-12), 127.0)


def conv2d_int8(x, w, b, *, dilation=1, groups=None):
    """The dynamic int8 mode's 3×3 convolution, zero padding ``dilation``:
    fp32 x is quantized with its dynamic step s_x (``dynamic_scales``), w
    per output channel, the product runs in int8, and the result is
    float(acc)·(s_x·s_w) + b in fp32, without a ReLU (the caller applies
    it, as the JAX forward does). x: (B, C, H, W) channels_last."""
    s_x = dynamic_scales(x, groups)
    q = quantize_int8(x, s_x[:, None, None, None])
    qw, s_w = quantize_weights_int8(w)
    return conv3x3_int8(q, kernel_weights(qw), s_x[:, None] * s_w[None, :],
                        b, dilation=dilation, relu=False)


def conv2d_int8_chain(q, qw, s_in, s_w, b, *, dilation=1, s_out=None):
    """One link of the calibrated int8 chain: the int8 carrier q on the
    grid of step s_in (a number holding a float32), prebaked (O, 3, 3, C)
    weights qw with steps s_w (O,); the epilogue dequantizes, adds b and
    applies the ReLU, then requantizes onto the step s_out (int8 out), or
    ends the chain in fp32 when s_out is None."""
    return conv3x3_int8(q, qw, (s_w * s_in)[None], b, dilation=dilation,
                        relu=True, s_out=s_out)


def max_pool_2x2(x):
    """2×2/2 max pool with Caffe's ceil-mode output size
    ceil((H-2)/2)+1: an odd edge row/column pools alone. An int8 carrier
    pools as int8 (max commutes with its positive step), an odd edge
    padded with -128 as JAX pads with the dtype's minimum."""
    if x.dtype != torch.int8:
        return F.max_pool2d(x, 2, 2, ceil_mode=True)
    B, C, H, W = x.shape
    h = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, W % 2, 0, H % 2), value=-128)
    h = h.reshape(B, (H + 1) // 2, 2, (W + 1) // 2, 2, C).amax(dim=(2, 4))
    return h.permute(0, 3, 1, 2)


def per_item(v):
    """Whether a valid extent is given per batch item: a (B,) tensor, not
    one number for the whole batch."""
    return isinstance(v, torch.Tensor) and v.dim() == 1


def zero_outside(h, vh, vw):
    """h (N, C, H, W) with every position outside rows [0, vh) and columns
    [0, vw) set to exactly 0 (NaN and inf included): the reference
    network's implicit zero padding around a valid extent. vh and vw are
    numbers, or (N,) int tensors giving each item its own extent (the JAX
    ``"where"`` mode under ``vmap``)."""
    rows = torch.arange(h.shape[2], device=h.device)[:, None]
    cols = torch.arange(h.shape[3], device=h.device)[None, :]
    if per_item(vh):
        # in place on a copy, which keeps h's memory format
        inside = ((rows < vh.to(h.device)[:, None, None, None])
                  & (cols < vw.to(h.device)[:, None, None, None]))
        return h.clone().masked_fill_(~inside, 0.0)
    return h.masked_fill(~((rows < vh) & (cols < vw)), 0.0)


def bilinear_kernel(factor: int, channels: int, dtype=np.float32):
    """Caffe 'bilinear' filler weights for a depthwise upsampling deconv,
    in the JAX package's HWIO layout (k, k, 1, channels):
    k = 2f - f%2, c = (2f - 1 - f%2) / (2f)."""
    k = 2 * factor - factor % 2
    c = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    og = np.arange(k, dtype=np.float64)
    v = 1.0 - np.abs(og / factor - c)
    kern2d = np.outer(v, v)
    w = np.zeros((k, k, 1, channels), dtype=dtype)
    w[:, :, 0, :] = kern2d[:, :, None]
    return w


def upsample2x_bilinear(x, w):
    """Depthwise transposed conv, kernel 4, stride 2, pad 1: (C, H, W) →
    (C, 2H, 2W), Caffe Deconvolution(group=C). ``w`` is (C, 1, 4, 4).

    The JAX version correlates the 2-dilated input with ``w``; a transposed
    conv correlates it with the spatially flipped kernel, so the flip here
    makes the two agree for any kernel (the bilinear one is symmetric).
    On a bf16 x it is a bf16 product, rounded once (JAX :208-213)."""
    def deconv(x, w):
        return F.conv_transpose2d(x, torch.flip(w, (2, 3)), stride=2,
                                  padding=1, groups=x.shape[1])
    if x.dtype == torch.bfloat16:
        return bf16_product(deconv, x, w)
    return deconv(x, w)
