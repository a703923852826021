"""The int8 serving mode's 3×3 convolution: int8 activations and weights,
int32 sums, and a fused fp32 epilogue (dequantize, bias, optional ReLU,
then fp32 out or a requantize onto the next layer's int8 grid).

Counterpart of the XLA int8 convolutions of the JAX package's int8 mode,
``smallhardface_tpu/models/layers.py``: ``conv2d_int8`` (:63, the dynamic
mode) and ``conv2d_int8_chain`` (:117, one link of the calibrated chain),
which the JAX forward runs outside any Pallas kernel. They become the CUDA
C++ kernel ``csrc/conv_int8.cu`` (Q1) for Hopper (sm_90a): an implicit GEMM
on the int8 tensor cores (``wgmma`` s8 on tiles that TMA brings in, a
persistent warp-specialised grid) whose epilogue writes int8 or fp32. Its
header says what bounds it on an H100 and what the design does about that.

- ``conv3x3_int8_reference``: the plain version. ``F.conv2d`` in float64
  on the int8 values (exact: every sum is below 2^53), cast to int32, then
  the epilogue as separate fp32 PyTorch ops in the JAX functions' order.
  The CPU path and Q1's oracle: Q1 equals it to the bit.
- ``conv3x3_int8``: the wrapper. On CPU tensors it is the plain version;
  on CUDA tensors it launches Q1 on the current stream or raises, and
  never falls back. ``conv3x3_int8.launches`` counts the launches.
- ``plan``: the kernel's tile for a layer shape (pixels a tile as TH×TW of
  one image, output channels and K bytes a step), from the constants
  below; ``tests/test_torch_port_conv_int8_tiles.py`` models the kernel's
  schedule with them.
- ``CONV_INT8``: the kernel library, built with ``nvcc`` at first use
  without fused multiply-adds and with IEEE division, so that the
  epilogue's fp32 operations are the plain version's.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.ops.cuda_build import CI, VP, CudaLibrary

# (x, w, scale, scale_stride, bias, B, H, W, C, O, dilation, epilogue,
#  s_out, out, tile_h, tile_w, block_n, k_chunk, stream)
CONV_INT8 = CudaLibrary(
    "conv_int8", "conv_int8.cu",
    {"shf_conv3x3_int8": [VP] * 3 + [CI] + [VP] + [CI] * 7
     + [ctypes.c_float, VP] + [CI] * 4 + [VP]},
    extra_flags=("-fmad=false", "-prec-div=true", "-ftz=false"))
# the kernel's tiles: C in steps of 32 channels, O in blocks of 64
C_STEP, O_STEP = 32, 64
# pixels a tile, and the (TH, TW) rectangles of one image it may take
TILE_M = 128
TILE_SHAPES = ((1, 128), (2, 64), (4, 32), (8, 16), (16, 8))
# K bytes a step (one chunk of channels of one tap, with the swizzle of the
# same width), and output channels a tile, in order of preference
K_CHUNKS = (128, 64, 32)
BLOCK_NS = (128, 64)
# the kernel's epilogue instances (csrc/conv_int8.cu)
_EPILOGUE = {(True, True): 0, (True, False): 1, (False, False): 2}


def fdiv(t, s):
    """t / s as a correctly rounded fp32 division, s a number or a tensor.
    A number becomes a 0-d tensor on t's device: on the card PyTorch
    divides by a number, or by a 0-d CPU tensor, as a product with its
    rounded reciprocal, which can miss the quotient by one ulp."""
    if not isinstance(s, torch.Tensor) or s.device != t.device:
        s = torch.full((), float(s), dtype=torch.float32, device=t.device)
    return torch.div(t, s)


def conv3x3_int8_reference(x, qw, scale, bias, *, dilation=1, relu=True,
                           s_out=None):
    """Plain version of ``conv3x3_int8`` (same arguments): the int32 sums
    in float64, then ``t = float(acc) * scale``, ``t + bias``, the ReLU,
    and ``clamp(round(t / s_out), -127, 127)`` as int8 when ``s_out`` is
    given, each as one fp32 op."""
    acc = F.conv2d(x.double(), qw.permute(0, 3, 1, 2).double(),
                   padding=dilation, dilation=dilation).to(torch.int32)
    t = acc.float() * scale[:, :, None, None]
    t = t + bias[None, :, None, None]
    if relu:
        t = torch.relu(t)
    if s_out is not None:
        t = torch.round(fdiv(t, s_out)).clamp(-127, 127).to(torch.int8)
    return t.contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def plan(H, W, C, O):
    """The kernel's tile for (H, W) images with C in and O out channels:
    (tile_h, tile_w, block_n, k_chunk). The TH×TW rectangle covers H×W
    with the fewest padded pixels (the wider one on a tie); the K step and
    the channel block are the widest that divide C and O. Cached: the
    wrapper asks for it on every launch."""
    th, tw = min(TILE_SHAPES, key=lambda s: (
        -(-H // s[0]) * s[0] * (-(-W // s[1])) * s[1], -s[1]))
    k_chunk = next(k for k in K_CHUNKS if C % k == 0)
    block_n = next(n for n in BLOCK_NS if O % n == 0)
    return th, tw, block_n, k_chunk


def _check(t, name, shape, dtype, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"conv3x3_int8: {name} must be a contiguous, 16-byte aligned "
            f"{dtype} tensor of shape {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def conv3x3_int8(x, qw, scale, bias, *, dilation=1, relu=True, s_out=None):
    """A 3×3 convolution with zero padding ``dilation`` of int8 carriers.

    x: (B, C, H, W) int8 in channels_last memory (NHWC), C a multiple of
    32; qw: (O, 3, 3, C) int8 weights, O a multiple of 64; scale: (1, O)
    or (B, O) float32, s_in·s_w (one row per image in the dynamic mode);
    bias: (O,) float32; ``relu``: apply the ReLU; ``s_out``: None for fp32
    out, else the next grid's step (a number holding a float32) for int8
    out. Returns (B, O, H, W) in channels_last memory. The epilogues are a
    chain link (ReLU, int8), the chain's end (ReLU, fp32) and the dynamic
    mode (no ReLU, fp32)."""
    if (relu, s_out is not None) not in {(True, True), (True, False),
                                         (False, False)}:
        raise ValueError("conv3x3_int8: an int8 output needs the ReLU")
    if x.device.type != "cuda":
        return conv3x3_int8_reference(x, qw, scale, bias, dilation=dilation,
                                      relu=relu, s_out=s_out)
    B, C, H, W = x.shape
    O = qw.shape[0]
    if C % C_STEP or O % O_STEP:
        raise ValueError(f"conv3x3_int8: C={C} must be a multiple of "
                         f"{C_STEP} and O={O} of {O_STEP}")
    nhwc = x.permute(0, 2, 3, 1)
    _check(nhwc, "x (as NHWC)", (B, H, W, C), torch.int8, x.device)
    _check(qw, "qw", (O, 3, 3, C), torch.int8, x.device)
    if scale.shape[0] not in (1, B):
        raise ValueError(f"conv3x3_int8: scale has {scale.shape[0]} rows "
                         f"for a batch of {B}")
    _check(scale, "scale", (scale.shape[0], O), torch.float32, x.device)
    _check(bias, "bias", (O,), torch.float32, x.device)
    out = torch.empty((B, O, H, W), device=x.device,
                      dtype=torch.float32 if s_out is None else torch.int8,
                      memory_format=torch.channels_last)
    lib = CONV_INT8.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    CONV_INT8.check(lib.shf_conv3x3_int8(
        nhwc.data_ptr(), qw.data_ptr(), scale.data_ptr(),
        O if scale.shape[0] > 1 else 0, bias.data_ptr(), B, H, W, C, O,
        int(dilation), _EPILOGUE[(relu, s_out is not None)],
        float(s_out) if s_out is not None else 1.0, out.data_ptr(),
        *plan(H, W, C, O), stream), "conv3x3_int8")
    conv3x3_int8.launches += 1
    return out


conv3x3_int8.launches = 0
