"""The detector's forward in plain PyTorch, NHWC, in the precisions the
benchmark compares: fp32 with TF32 off ("fp32"), its control with TF32 on
("tf32"), the calibrated int8 chain ("int8") and its control on a 4-bit
grid ("int4").

Frozen from the port's plain versions: the graph of
``smallhardface_tpu_torch/models/detector.py`` :422-597 (the ``"exact"``
mode without masks, the ``"where"`` mode with one valid extent),
``ops/stem.py`` :72-94 (the plain stem), ``models/layers.py`` :155-307
(the int8 quantizers, the Caffe-mode pool, the bilinear deconv) and
``ops/conv_int8.py`` :53-71 (the int8 product summed exactly in float64,
then the fp32 epilogue op by op), and the calibration of
``detect.py`` :467-501 and ``models/detector.py`` :633-671. Every 3×3
convolution here is nine matrix products over shifted views of the
zero-padded input, bias last; the program sums in other orders.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import arch

# the integer grid of each quantized mode: symmetric, saturating
QMAX = {"int8": 127.0, "int4": 7.0}


@contextlib.contextmanager
def numerics(mode):
    """TF32 off in the library's own products: fp32 with TF32 off is what
    the configurations state (the "tf32" control rounds its operands
    itself, ``TF32Product``, so that it reads the same on any device);
    restored on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest, ties to even), as
    the tensor cores read an fp32 operand."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, fp32 sums; its backward
    rounds its operands the same way."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).t(), tf32(a).t() @ g


def product(a, b, mode):
    """a @ b, in TF32 under the "tf32" control."""
    if mode == "tf32":
        return TF32Product.apply(a, b)
    return a @ b


def fdiv(t, s):
    """t / s, correctly rounded in fp32 (a number becomes a 0-d tensor on
    t's device: the card divides by a host number as a product with its
    reciprocal)."""
    if not isinstance(s, torch.Tensor) or s.device != t.device:
        s = torch.full((), float(s), dtype=torch.float32, device=t.device)
    return torch.div(t, s)


def conv3x3(x, w, b=None, dilation=1, mode="fp32"):
    """x (B, H, W, C), w (O, C, 3, 3): zero padding ``dilation``; nine
    products of shifted views, bias last."""
    B, H, W, C = x.shape
    d = dilation
    xp = F.pad(x, (0, 0, d, d, d, d))
    grad = torch.is_grad_enabled()
    out = None
    for ky in range(3):
        for kx in range(3):
            patch = xp[:, ky * d:ky * d + H, kx * d:kx * d + W].reshape(-1, C)
            wt = w[:, :, ky, kx].t()
            if out is None:
                out = product(patch, wt, mode)
            elif grad or mode == "tf32":
                out = out + product(patch, wt, mode)
            else:
                out.addmm_(patch, wt)
    if b is not None:
        out = out + b
    return out.view(B, H, W, -1)


def conv1x1(x, w, b, mode="fp32"):
    B, H, W, C = x.shape
    return (product(x.reshape(-1, C), w[:, :, 0, 0].t(), mode) + b).view(
        B, H, W, -1)


def pool(x):
    """2×2/2 max pool, Caffe's ceil mode."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2,
                        ceil_mode=True).permute(0, 2, 3, 1)


def upsample(x, w):
    """Depthwise transposed conv, kernel 4, stride 2, pad 1 (Caffe's
    Deconvolution with group = C), w (C, 1, 4, 4)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), torch.flip(w, (2, 3)),
                           stride=2, padding=1, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def quantize(x, step, qmax):
    """The carrier of x on the grid of ``step`` as float values."""
    return torch.round(fdiv(x, step)).clamp(-qmax, qmax)


def quantize_weights(w, qmax):
    """Per output channel: s_w = max(max|w|, 1e-12) / qmax, q = clip(round(
    w / s_w))."""
    s_w = fdiv(w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12), qmax)
    q = torch.round(torch.div(w, s_w[:, None, None, None])).clamp(-qmax, qmax)
    return q, s_w


class Net:
    """The forward over ``params`` ({name: {'w', 'b'}} OIHW fp32 tensors,
    leaves of the caller's). ``mode`` is one of "fp32", "tf32", "int8",
    "int4"; the quantized modes need ``calibrate`` first."""

    def __init__(self, params, mode="fp32", stages=arch.VGG16):
        self.p, self.mode, self.stages = params, mode, stages
        self.q = None

    # -- int8 / int4 ----------------------------------------------------
    def calibrate(self, xs):
        """Static activation steps from fp32 forwards over xs (each (1, H,
        W, 3) mean-subtracted, H and W multiples of 16, no mask): the
        max|input| of every quantized conv over all of them, "head" on the
        input of the dilated heads; then the weights quantized once."""
        qmax = QMAX[self.mode]
        names = arch.int8_layers(self.stages)
        amax = {}
        with torch.no_grad(), numerics("fp32"):
            for x in xs:
                rec = {}
                self._graph(x, None, rec)
                vals = torch.stack([rec[n] for n in names]).cpu().tolist()
                for n, v in zip(names, vals):
                    amax[n] = max(amax.get(n, 0.0), v)
        steps = {n: float(np.float32(amax[n]) / np.float32(qmax))
                 for n in names}
        qw = {n: quantize_weights(self.p[n]["w"].detach(), qmax)
              for n in names}
        self.q = {"amax": amax, "step": steps, "qw": qw}
        return amax

    def _qconv(self, h, name, dilation, s_out):
        """One quantized 3×3 conv: h a float carrier on ``name``'s grid
        (values integers) or fp32 (quantized here); exact sums in float64,
        then dequantize, bias, ReLU, and a requantize onto ``s_out`` (a
        float carrier) or fp32 out."""
        qmax = QMAX[self.mode]
        step = self.q["step"][name]
        if h.dtype == torch.float32:
            h = quantize(h, step, qmax)
        qw, s_w = self.q["qw"][name]
        acc = conv3x3(h.double(), qw.double(), None, dilation)
        t = acc.to(torch.int32).float() * (s_w * step)
        t = torch.relu(t + self.p[name]["b"])
        if s_out is None:
            return t
        return torch.round(fdiv(t, s_out)).clamp(-qmax, qmax).double()

    # -- the graph ------------------------------------------------------
    def __call__(self, x, valid=None):
        """x (B, H, W, 3) fp32 mean-subtracted, H and W multiples of 16.
        valid: None (no mask, the "exact" mode) or the (vh, vw) extent of
        the "where" mode. Returns (cls_logits (B, h, w, A, 2), bbox_deltas
        (B, h, w, A, 4)) at stride 8."""
        with numerics(self.mode):
            return self._graph(x, valid, None)

    def _graph(self, x, valid, rec):
        p, quant = self.p, self.mode in QMAX and rec is None
        # the matrix products' precision: TF32 only in the "tf32" control
        fmode = "tf32" if self.mode == "tf32" and rec is None else "fp32"
        succ = arch.int8_successor(self.stages)
        stride = 1

        def mask(h):
            if valid is None:
                return h
            vh, vw = valid[0] // stride, valid[1] // stride
            rows = torch.arange(h.shape[1], device=h.device) < vh
            cols = torch.arange(h.shape[2], device=h.device) < vw
            inside = (rows[:, None] & cols[None, :])[None, :, :, None]
            return torch.where(inside, h, torch.zeros((), dtype=h.dtype,
                                                      device=h.device))

        def record(name, h):
            if rec is not None:
                a = h.detach().abs().amax()
                rec[name] = torch.maximum(rec[name], a) if name in rec else a

        def step_of(name):
            return None if name is None else self.q["step"][name]

        h = mask(x)
        feats = {}
        last = len(self.stages) - 1
        for si, (stage, _, n) in enumerate(self.stages):
            for i in range(1, n + 1):
                name = f"{stage}_{i}"
                if stage == "conv1":
                    h = mask(torch.relu(conv3x3(h, p[name]["w"],
                                                p[name]["b"], 1, fmode)))
                    continue
                record(name, h)
                if quant:
                    h = mask(self._qconv(h, name, 1, step_of(succ.get(name))))
                else:
                    h = mask(torch.relu(conv3x3(h, p[name]["w"],
                                                p[name]["b"], 1, fmode)))
            feats[stage] = h
            if si < last:
                h = pool(h)
                stride *= 2
                if stage == "conv1":
                    h = mask(h)
        f4 = feats["conv4"]
        if quant:
            # the chain left conv4's last output on conv5_1's grid
            f4 = f4.float() * self.q["step"]["conv5_1"]
        f5 = mask(torch.relu(conv1x1(feats["conv5"], *self._wb("conv5_256"),
                                     fmode)))
        up = upsample(f5, p["conv5_256_up"]["w"])
        stride //= 2
        lat4 = torch.relu(conv1x1(f4, *self._wb("conv4_256"), fmode))
        ff = mask(torch.cat([mask(up), lat4], dim=-1))
        for name in ("conv4_fuse_final", "conv4_fuse_final_dim_red"):
            record(name, ff)
            if quant:
                ff = mask(self._qconv(ff, name, 1, step_of(succ[name])))
            else:
                ff = mask(torch.relu(conv3x3(ff, *self._wb(name), 1, fmode)))
        record("head", ff)
        cls, box = [], []
        for k, d in zip(arch.ANCHOR_SCALES, arch.HEAD_DILATIONS):
            if quant:
                hd = self._qconv(ff, "head", d, None)
            else:
                hd = torch.relu(conv3x3(ff, *self._wb("head"), d, fmode))
            cls.append(conv1x1(hd, *self._wb(f"cls_score_{k}"), fmode))
            box.append(conv1x1(hd, *self._wb(f"bbox_pred_{k}"), fmode))
        return torch.stack(cls, dim=-2), torch.stack(box, dim=-2)

    def _wb(self, name):
        return self.p[name]["w"], self.p[name]["b"]
