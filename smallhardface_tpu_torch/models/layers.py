"""Primitive NN ops for the detector, on NCHW-shaped tensors (the detector
keeps them in ``torch.channels_last`` memory format).

Counterpart of ``smallhardface_tpu/models/layers.py``: ``conv2d`` (:17-49),
``max_pool_2x2`` (:159-178), ``bilinear_kernel`` (:181-192) and
``upsample2x_bilinear`` (:195-213). Weights are OIHW, the PyTorch layout;
``io/weights.py`` converts from the JAX package's HWIO. The convolutions
are cuDNN's, or for the large 3×3 ones of detection nine cuBLAS products
(``conv3x3``): the JAX package leaves them to XLA outside any Pallas
kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x, w, b=None, *, dilation=1, padding=0):
    """Conv with explicit symmetric zero padding and dilation. For a 3×3
    kernel at dilation d the Caffe templates pad by d."""
    return F.conv2d(x, w, b, padding=padding, dilation=dilation)


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
    cuDNN's backward) as cuDNN's ``conv2d``. Both are deterministic."""
    B, C, H, W = x.shape
    if (not torch.is_grad_enabled()
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


def max_pool_2x2(x):
    """2×2/2 max pool with Caffe's ceil-mode output size
    ceil((H-2)/2)+1: an odd edge row/column pools alone."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


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
    makes the two agree for any kernel (the bilinear one is symmetric)."""
    return F.conv_transpose2d(x, torch.flip(w, (2, 3)), stride=2, padding=1,
                              groups=x.shape[1])
