"""The fp32 3×3 convolution of detection: y = conv3x3(x, w) + b, zero
padding ``dilation``, an optional fused ReLU and a shard's ``halo`` as
``models/layers.conv3x3`` defines them, in error-compensated TF32
(3xTF32) on the tensor cores.

It replaces no Pallas kernel: the JAX package leaves these convolutions to
XLA (``smallhardface_tpu/models/layers.py:17``), and the port ran those of
at least ``layers.TAPS_MIN_FLOP`` as nine cuBLAS products in plain fp32
(``layers.conv3x3_taps``). On the card they become the CUDA C++ kernel
``csrc/conv_fp32.cu`` (C1) for Hopper (sm_90a): an implicit GEMM on the
TF32 tensor cores (``wgmma`` on tiles that TMA brings in, x cut into hi and
lo halves in registers, w by a small kernel before it), Q1's persistent
warp-specialised grid. Its header says what bounds it on an H100 and what
the design does about that.

- ``conv3x3_fp32``: the wrapper. On CPU tensors it is the plain version,
  ``layers.conv3x3_taps``; on CUDA tensors it launches C1 on the current
  stream or raises, and never falls back. ``conv3x3_fp32.launches``
  counts the launches.
- ``tf32_rna`` and ``tf32_split``: the plain TF32 rounding (``cvt.rna``:
  to nearest, ties away from zero, 10 fraction bits) and the hi/lo cut C1
  makes of x in registers and of w in a scratch, at every call.
- ``plan``: the kernel's tile for a layer shape.
- ``CONV_FP32``: the kernel library, built with ``nvcc`` at first use
  without fused multiply-adds, so that each sum is one fp32 addition.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from smallhardface_tpu_torch.ops.conv_int8 import TILE_SHAPES
from smallhardface_tpu_torch.ops.cuda_build import CI, VP, CudaLibrary

LL = ctypes.c_longlong
# (x, its W, H and B strides, w, its four strides, wsplit, bias, out, B,
#  H, W, C, O, dilation, row0, Ho, relu, tile_h, tile_w, block_n, stream)
CONV_FP32 = CudaLibrary(
    "conv_fp32", "conv_fp32.cu",
    {"shf_conv3x3_fp32": [VP] + [LL] * 3 + [VP] + [LL] * 4 + [VP] * 3
     + [CI] * 12 + [VP]},
    extra_flags=("-fmad=false", "-ftz=false"))
# the kernel's K step is 32 channels of one tap; its channel blocks are
# 128 or 64 outputs: C and O in steps of 64
CHANNEL_STEP = 64
BLOCK_NS = (128, 64)
# TF32 keeps 10 of fp32's 23 fraction bits
_TF32_DROP = 13


def tf32_rna(a):
    """a (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest pattern whose 13 low fraction bits are 0, ties away from
    zero; NaN stays NaN. A float32 tensor of TF32 values."""
    bits = a.view(torch.int32)
    half = 1 << (_TF32_DROP - 1)
    # the sign bit rides along: adding half to the magnitude's pattern and
    # clearing the dropped bits rounds the magnitude, ties away from zero
    r = ((bits + half) & ~((1 << _TF32_DROP) - 1)).view(torch.float32)
    return torch.where(torch.isnan(a), a, r)


def tf32_split(a):
    """(hi, lo) of a (float32): hi = tf32_rna(a), lo = tf32_rna(a - hi).
    a - hi is exact, and hi + lo is a to about 2^-22 of |a|."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


@functools.lru_cache(maxsize=None)
def plan(H, W, O):
    """The kernel's tile for (H, W) outputs with O channels: (tile_h,
    tile_w, block_n). The TH×TW rectangle of 128 pixels covers H×W with
    the fewest padded pixels (the wider one on a tie), as Q1's does; the
    channel block is the widest that divides O."""
    th, tw = min(TILE_SHAPES, key=lambda s: (
        -(-H // s[0]) * s[0] * (-(-W // s[1])) * s[1], -s[1]))
    return th, tw, next(n for n in BLOCK_NS if O % n == 0)


def conv3x3_fp32(x, w, b, *, dilation=1, halo=(0, 0), relu=False):
    """A 3×3 convolution with zero padding ``dilation`` in fp32, as
    ``layers.conv3x3`` defines it: x (B, C, H, W), w (O, C, 3, 3), b
    (O,); ``halo`` (top, bottom): the rows x carries above and below its
    own, which take no zero padding; ``relu``: apply the ReLU. Returns (B,
    O, H - top - bottom, W) in channels_last memory. On the card C and O
    must be multiples of 64, and x is read where its channels are
    contiguous (else from a channels_last copy)."""
    if x.device.type == "cpu":
        # the plain version lives with the other routes of conv3x3
        from smallhardface_tpu_torch.models.layers import conv3x3_taps
        y = conv3x3_taps(x, w, b, dilation=dilation, halo=halo)
        return y.relu_() if relu else y
    B, C, H, W = x.shape
    O = w.shape[0]
    if C % CHANNEL_STEP or O % CHANNEL_STEP:
        raise ValueError(f"conv3x3_fp32: C={C} and O={O} must be multiples "
                         f"of {CHANNEL_STEP}")
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or w.dtype != torch.float32 or tuple(w.shape) != (O, C, 3, 3)
            or w.device != x.device or b.dtype != torch.float32
            or tuple(b.shape) != (O,) or b.device != x.device):
        raise ValueError(
            f"conv3x3_fp32: needs float32 CUDA tensors x (B, C, H, W), w "
            f"(O, C, 3, 3) and b (O,) on one device, got x {x.dtype} on "
            f"{x.device}, w {w.dtype} {tuple(w.shape)} on {w.device}, b "
            f"{b.dtype} {tuple(b.shape)} on {b.device}")
    top, bottom = halo
    Ho = H - top - bottom
    nhwc = x.permute(0, 2, 3, 1)
    if (nhwc.stride(3) != 1 or nhwc.data_ptr() % 16
            or any(s % 4 for s in nhwc.stride()[:3])):
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
    wsplit = torch.empty((2 * O, 9 * C), device=x.device)
    bias = b.detach().contiguous()
    out = torch.empty((B, O, Ho, W), device=x.device,
                      memory_format=torch.channels_last)
    lib = CONV_FP32.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    CONV_FP32.check(lib.shf_conv3x3_fp32(
        nhwc.data_ptr(), nhwc.stride(2), nhwc.stride(1), nhwc.stride(0),
        w.data_ptr(), *w.stride(), wsplit.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, H, W, C, O, int(dilation), int(top), Ho,
        int(bool(relu)), *plan(Ho, W, O), stream), "conv3x3_fp32")
    conv3x3_fp32.launches += 1
    return out


conv3x3_fp32.launches = 0
