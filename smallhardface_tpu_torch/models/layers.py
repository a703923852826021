"""Primitive NN ops for the detector, on NCHW-shaped tensors (the detector
keeps them in ``torch.channels_last`` memory format).

Counterpart of ``smallhardface_tpu/models/layers.py``: ``conv2d`` (:17-49),
the int8 mode's ``quantize_weights_int8``, ``conv2d_int8`` and
``conv2d_int8_chain`` (:52-157), ``max_pool_2x2`` (:159-178), also on int8
carriers, ``bilinear_kernel`` (:181-192) and ``upsample2x_bilinear``
(:195-213). Weights are OIHW, the PyTorch layout; ``io/weights.py``
converts from the JAX package's HWIO. The fp32 convolutions are cuDNN's,
or for the large 3×3 ones of detection ``ops/conv_fp32.conv3x3_fp32``
(``conv3x3``: the kernel C1 on the card, 3xTF32 on the tensor cores, with
the nine channel products of ``conv3x3_taps`` as its plain version); in
training the 3×3 ones keep cuDNN's forward, and their backward is the
nine products' adjoint (``Conv3x3Adjoint``), cuBLAS products: the JAX
package leaves them to XLA outside any Pallas kernel. The int8 3×3
products run through ``ops/conv_int8.conv3x3_int8`` (the kernel Q1 on the
card).

The spatial ops also take a shard of an H-sharded image
(``parallel/spatial``): ``halo=(top, bottom)`` gives the rows the input
carries from the shards above and below (``spatial.halo``), and the
output holds the shard's own rows. The 3×3 convolutions pad the columns by
the dilation and the rows only where no halo stands (the image's edges);
the upsample and the int8 convolutions crop; ``zero_outside`` takes the
shard's global row offset. 1×1 convolutions and the 2×2 pool need no halo
once the shards are aligned.

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
from torch.autograd.function import once_differentiable

from smallhardface_tpu_torch.ops.conv_fp32 import conv3x3_fp32
from smallhardface_tpu_torch.ops.conv_int8 import conv3x3_int8, fdiv


def conv2d(x, w, b=None, *, dilation=1, padding=0, stride=1):
    """Conv with explicit symmetric zero padding, dilation and stride. For
    a 3×3 kernel at dilation d the Caffe templates pad by d. On a bf16 x,
    the product rounds once to bf16 and the bf16 bias is added after it."""
    if x.dtype != torch.bfloat16:
        return F.conv2d(x, w, b, stride=stride, padding=padding,
                        dilation=dilation)
    out = bf16_product(F.conv2d, x, w, stride=stride, padding=padding,
                       dilation=dilation)
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


# From this many FLOP up, a 3×3 convolution of detection runs as C1
# (conv3x3_fp32) on the card, as conv3x3_taps on the CPU; below it, as
# cuDNN's conv2d. Over the 393 shapes of tools/conv_map.py's map below the
# nine products' old threshold (1.34e10, above which cuDNN's heuristic had
# picked FFT algorithms of up to 0.53 s and 38 GB a call), C1 took at most
# 0.67× cuDNN's device time at every shape from 5e9 FLOP up, and lost only
# at shapes of at most 2.42e9 FLOP, few tiles of 512 channels (`conv_map
# --threshold`, PERF.md §6). One threshold for every model: it reads only
# the call's work.
TAPS_MIN_FLOP = 5e9
# conv3x3_taps works through the batch a few images at a time, so that its
# padded input and output take at most this much beyond its output
TAPS_SCRATCH_BYTES = 2 ** 31


def conv3x3(x, w, b, *, dilation=1, halo=(0, 0), relu=False):
    """The forward's 3×3 convolutions, zero padding ``dilation``, followed
    by a ReLU where ``relu``. Under no_grad / inference_mode, those of at
    least TAPS_MIN_FLOP run as ``conv3x3_fp32`` (C1 on the card, the ReLU
    fused; ``conv3x3_taps`` on the CPU), the rest as cuDNN's ``conv2d``.
    Where autograd records the call (x, w or b needs a gradient) it runs
    as ``Conv3x3Adjoint``: cuDNN's forward, and as backward the nine
    products' adjoint (``conv3x3_taps_grad``): with cudnn.deterministic
    at batch 1, cuDNN's data gradient takes FFT algorithms (a memory-bound
    gemv per frequency) at 27 of the 64 shapes of training's buckets, from
    6·10⁹ FLOP up, at up to 5× the adjoint's time; cuDNN's backward wins
    only where it has no data gradient to compute (conv3_1, by at most 0.9
    ms a call) or at small shapes (by at most 0.18 ms; PERF.md §5). All
    are deterministic. A bf16 x always runs as ``conv2d``'s bf16 product,
    with cuDNN's backward. ``halo``: the rows x carries above and below
    its own (each 0 or ``dilation``); those sides take no zero padding,
    and the output has x's own rows.

    ``conv3x3.adjoint_backwards`` and ``conv3x3.cudnn_backwards`` count
    the backward calls of the recorded convolutions by route."""
    B, C, H, W = x.shape
    if x.dtype != torch.bfloat16:
        if torch.is_grad_enabled():
            if any(t is not None and t.requires_grad for t in (x, w, b)):
                y = Conv3x3Adjoint.apply(x, w, b, dilation, halo)
                return F.relu(y) if relu else y
        elif (18.0 * B * (H - halo[0] - halo[1]) * W * C * w.shape[0]
              >= TAPS_MIN_FLOP):
            return conv3x3_fp32(x, w, b, dilation=dilation, halo=halo,
                                relu=relu)
    y = conv3x3_cudnn(x, w, b, dilation, halo)
    if y.requires_grad:
        y.register_hook(_count_cudnn_backward)
        return F.relu(y) if relu else y
    # in place on the convolution's own output, which nothing else holds
    return y.relu_() if relu else y


conv3x3.adjoint_backwards = 0
conv3x3.cudnn_backwards = 0


def _count_cudnn_backward(grad):
    conv3x3.cudnn_backwards += 1


def conv3x3_cudnn(x, w, b, dilation, halo):
    """cuDNN's 3×3 convolution (``conv2d``) with ``conv3x3``'s padding: d,
    less the halo on a shard's row sides."""
    d = dilation
    pt, pb = d - halo[0], d - halo[1]
    if pt == pb:
        return conv2d(x, w, b, dilation=d, padding=(pt, d))
    return conv2d(F.pad(x, (0, 0, pt, pb)), w, b, dilation=d, padding=(0, d))


class Conv3x3Adjoint(torch.autograd.Function):
    """A 3×3 convolution whose forward is cuDNN's (``conv3x3_cudnn``, the
    same call as without it) and whose backward is ``conv3x3_taps_grad``:
    the exact adjoint of ``conv3x3_taps``' nine products, in a fixed order.
    Saves x and w, as cuDNN's own autograd node does; the gradient of x
    is computed only where x needs one."""

    @staticmethod
    def forward(ctx, x, w, b, dilation, halo):
        ctx.save_for_backward(x, w)
        ctx.dilation, ctx.halo = dilation, halo
        return conv3x3_cudnn(x, w, b, dilation, halo)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw = conv3x3_taps_grad(x, w, dy, dilation=ctx.dilation,
                                   halo=ctx.halo, need_x=need_x,
                                   need_w=need_w)
        db = dy.sum(dim=(0, 2, 3)) if need_b else None
        conv3x3.adjoint_backwards += 1
        return dx, dw, db, None, None


def conv3x3_taps(x, w, b, *, dilation=1, halo=(0, 0)):
    """A 3×3 convolution with zero padding ``dilation``, as nine channel
    products (``torch.addmm``) summed in a fixed order: C1's plain version
    (``ops/conv_fp32``), which runs it for CPU tensors. x: (B, C, H, W) in
    channels_last memory; w: (O, C, 3, 3). Returns (B, O, H, W) in
    channels_last memory, or x's own rows under a ``halo`` (as
    ``conv3x3``).

    The input is zero-padded by d = dilation (the rows by d less the halo)
    and flattened to rows, one per pixel of the padded grid; the output is
    computed on the same grid. On that grid tap (ky, kx) reads the row
    s = (ky-1)·d·(W+2d) + (kx-1)·d away, so each tap is one product of a
    contiguous block of input rows, added in place to a contiguous block
    of output rows (beta = 1). Rows of the padding ring read across an
    edge and are cut away; every inner output reads only its own image's
    padded rows. The bias and the centre tap come first, then the other
    taps in row-major order, so the result is the same from run to run.
    The images go through in groups whose padded input and output fit
    TAPS_SCRATCH_BYTES (at least one image)."""
    B, C, H, W = x.shape
    O = w.shape[0]
    d = dilation
    pt, pb = d - halo[0], d - halo[1]
    Ho = H + pt + pb - 2 * d
    Hp, Wp = H + pt + pb, W + 2 * d
    step = max(1, int(TAPS_SCRATCH_BYTES
                      // (x.element_size() * Hp * Wp * (C + O))))
    taps = w.permute(2, 3, 1, 0)                    # (3, 3, C, O)
    out = torch.empty((B, O, Ho, W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    for b0 in range(0, B, step):
        xb = x[b0:b0 + step].permute(0, 2, 3, 1)
        rows = F.pad(xb, (0, 0, d, d, pt, pb)).reshape(-1, C)
        acc = torch.addmm(b, rows, taps[1, 1])
        n = acc.shape[0]
        for ky in range(3):
            for kx in range(3):
                s = (ky - 1) * d * Wp + (kx - 1) * d
                if s:
                    lo, hi = max(0, -s), n - max(0, s)
                    acc[lo:hi].addmm_(rows[lo + s:hi + s], taps[ky, kx])
        out[b0:b0 + step] = acc.view(-1, Hp, Wp, O)[
            :, d:d + Ho, d:d + W].permute(0, 3, 1, 2)
    return out


def conv3x3_taps_grad(x, w, dy, *, dilation=1, halo=(0, 0), need_x=True,
                      need_w=True):
    """The gradients (dx, dw) of a 3×3 convolution (``conv3x3``'s padding
    and ``halo``) at x (B, C, H, W), w (O, C, 3, 3) for dy (B, O, Ho, W):
    the transposes of ``conv3x3_taps``' products on its grid. dy is
    scattered into a zeroed output grid ``dacc`` (its ring stays 0); tap
    (ky, kx) at row offset s gives dw[:, :, ky, kx] = dacc[lo:hi]ᵀ @
    rows[lo+s:hi+s] and, where x needs a gradient, drows[lo+s:hi+s] +=
    dacc[lo:hi] @ w[:, :, ky, kx], the centre tap first, then the others
    in row-major order; dx is drows cut back to x's rows (the halo rows
    included). Each sum is in a fixed order, so the result is the same
    from run to run. Each grid is freed once used. dx (channels_last) or
    dw is None where not asked for."""
    B, C, H, W = x.shape
    O = w.shape[0]
    d = dilation
    pt, pb = d - halo[0], d - halo[1]
    Ho = H + pt + pb - 2 * d
    Hp, Wp = H + pt + pb, W + 2 * d
    # tap t = 3·ky + kx at row offset s[t]; the centre tap first, then
    # the others in row-major order
    order = [4, 0, 1, 2, 3, 5, 6, 7, 8]
    s = [(t // 3 - 1) * d * Wp + (t % 3 - 1) * d for t in range(9)]
    dacc = x.new_zeros((B, Hp, Wp, O))
    dacc[:, d:d + Ho, d:d + W] = dy.permute(0, 2, 3, 1)
    dacc = dacc.view(-1, O)
    n = dacc.shape[0]
    span = [(max(0, -s[t]), n - max(0, s[t])) for t in range(9)]
    dx = dw = None
    if need_w:
        rows = F.pad(x.permute(0, 2, 3, 1),
                     (0, 0, d, d, pt, pb)).reshape(-1, C)
        dw = x.new_empty((O, 9, C))
        dw_t, dacc_t = dw.unbind(1), dacc.t()
        for t in order:
            lo, hi = span[t]
            torch.mm(dacc_t[:, lo:hi], rows[lo + s[t]:hi + s[t]],
                     out=dw_t[t])
        del rows
        dw = dw.view(O, 3, 3, C).permute(0, 3, 1, 2)
    if need_x:
        w_t = w.permute(2, 3, 0, 1).reshape(9, O, C).unbind(0)
        drows = torch.mm(dacc, w_t[4])
        for t in order[1:]:
            lo, hi = span[t]
            drows[lo + s[t]:hi + s[t]].addmm_(dacc[lo:hi], w_t[t])
        del dacc
        dx = drows.view(B, Hp, Wp, C)[:, pt:pt + H, d:d + W].permute(
            0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return dx, dw


def own_rows(y, halo):
    """y (B, C, H, W) without the ``halo`` rows (top, bottom) of a shard's
    input: the shard's own rows (y itself without a halo)."""
    top, bottom = halo
    if not (top or bottom):
        return y
    return y.narrow(2, top, y.shape[2] - top - bottom)


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


def dynamic_amax(x, groups=None):
    """max|x| over everything one JAX forward call of each item's group
    sees, (B,) for x (B, C, H, W). ``groups`` (B,) int tensor: items with
    one id share one maximum; None: the whole batch shares one, as one JAX
    call over it does."""
    amax = x.abs().amax(dim=(1, 2, 3))
    if groups is None:
        return amax.amax().expand(x.shape[0])
    groups = groups.to(x.device)
    same = groups[:, None] == groups[None, :]
    return torch.where(same, amax[None, :], 0.0).amax(dim=1)


def dynamic_step(amax):
    """The dynamic mode's activation step of a maximum: max(amax, 1e-12) /
    127 in fp32."""
    return fdiv(amax.clamp_min(1e-12), 127.0)


def dynamic_scales(x, groups=None):
    """The dynamic mode's activation step of each item of x (B, C, H, W):
    ``dynamic_step`` of ``dynamic_amax``. Returns (B,) float32."""
    return dynamic_step(dynamic_amax(x, groups))


def conv2d_int8(x, w, b, *, dilation=1, groups=None, s_x=None,
                halo=(0, 0)):
    """The dynamic int8 mode's 3×3 convolution, zero padding ``dilation``:
    fp32 x is quantized with its dynamic step s_x (``dynamic_scales``, or
    the (B,) steps given, as a sharded image takes them over every shard),
    w per output channel, the product runs in int8, and the result is
    float(acc)·(s_x·s_w) + b in fp32, without a ReLU (the caller applies
    it, as the JAX forward does). x: (B, C, H, W) channels_last. Under a
    ``halo`` (rows of x from the shards above and below, each 0 or
    ``dilation``) the product runs over every row of x and the output keeps
    x's own rows."""
    if s_x is None:
        s_x = dynamic_scales(x, groups)
    q = quantize_int8(x, s_x[:, None, None, None])
    qw, s_w = quantize_weights_int8(w)
    return own_rows(conv3x3_int8(
        q.contiguous(memory_format=torch.channels_last), kernel_weights(qw),
        s_x[:, None] * s_w[None, :], b, dilation=dilation, relu=False), halo)


def conv2d_int8_chain(q, qw, s_in, s_w, b, *, dilation=1, s_out=None,
                      halo=(0, 0)):
    """One link of the calibrated int8 chain: the int8 carrier q on the
    grid of step s_in (a number holding a float32), prebaked (O, 3, 3, C)
    weights qw with steps s_w (O,); the epilogue dequantizes, adds b and
    applies the ReLU, then requantizes onto the step s_out (int8 out), or
    ends the chain in fp32 when s_out is None. ``halo`` as in
    ``conv2d_int8``."""
    return own_rows(conv3x3_int8(
        q.contiguous(memory_format=torch.channels_last), qw,
        (s_w * s_in)[None], b, dilation=dilation, relu=True, s_out=s_out),
        halo)


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


def zero_outside(h, vh, vw, row0=0):
    """h (N, C, H, W) with every position outside rows [0, vh) and columns
    [0, vw) set to exactly 0 (NaN and inf included): the reference
    network's implicit zero padding around a valid extent. vh and vw are
    numbers, or (N,) int tensors giving each item its own extent (the JAX
    ``"where"`` mode under ``vmap``). ``row0``: the global row of h's first
    row (a shard of an H-sharded image)."""
    rows = torch.arange(row0, row0 + h.shape[2], device=h.device)[:, None]
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


def upsample2x_bilinear(x, w, *, halo=(0, 0)):
    """Depthwise transposed conv, kernel 4, stride 2, pad 1: (C, H, W) →
    (C, 2H, 2W), Caffe Deconvolution(group=C). ``w`` is (C, 1, 4, 4).

    The JAX version correlates the 2-dilated input with ``w``; a transposed
    conv correlates it with the spatially flipped kernel, so the flip here
    makes the two agree for any kernel (the bilinear one is symmetric).
    On a bf16 x it is a bf16 product, rounded once (JAX :208-213).

    ``halo``: the rows x carries above and below its own (one each at
    most): output row o reads only input rows ⌊(o-1)/2⌋ and ⌊(o+1)/2⌋,
    so with a one-row halo the output's 2·(own rows) rows of the shard are
    exact, and only they are kept."""
    def deconv(x, w):
        return F.conv_transpose2d(x, torch.flip(w, (2, 3)), stride=2,
                                  padding=1, groups=x.shape[1])
    if x.dtype == torch.bfloat16:
        y = bf16_product(deconv, x, w)
    else:
        y = deconv(x, w)
    return own_rows(y, (2 * halo[0], 2 * halo[1]))
