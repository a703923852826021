"""Primitive NN ops for the detector, on NCHW-shaped tensors (the detector
keeps them in ``torch.channels_last`` memory format).

Counterpart of ``smallhardface_tpu/models/layers.py``: ``conv2d`` (:17-49),
``max_pool_2x2`` (:159-178), ``bilinear_kernel`` (:181-192) and
``upsample2x_bilinear`` (:195-213). Weights are OIHW, the PyTorch layout;
``io/weights.py`` converts from the JAX package's HWIO. These stay cuDNN
convolutions: the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x, w, b=None, *, dilation=1, padding=0):
    """Conv with explicit symmetric zero padding and dilation. For a 3×3
    kernel at dilation d the Caffe templates pad by d."""
    return F.conv2d(x, w, b, padding=padding, dilation=dilation)


def max_pool_2x2(x):
    """2×2/2 max pool with Caffe's ceil-mode output size
    ceil((H-2)/2)+1: an odd edge row/column pools alone."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def zero_outside(h, vh, vw):
    """h (N, C, H, W) with every position outside rows [0, vh) and columns
    [0, vw) set to exactly 0 (NaN and inf included): the reference
    network's implicit zero padding around a valid extent."""
    rows = torch.arange(h.shape[2], device=h.device) < vh
    cols = torch.arange(h.shape[3], device=h.device) < vw
    return h.masked_fill(~(rows[:, None] & cols[None, :]), 0.0)


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
