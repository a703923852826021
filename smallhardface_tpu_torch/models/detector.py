"""The smallhardface detector in PyTorch: VGG-16 backbone + FPN-lite fusion
+ detection heads.

Counterpart of ``smallhardface_tpu/models/detector.py``: the spec and
shape tables (:32-234), ``init_params`` (:133-163), ``param_multipliers``
(:166-194) and the graph of ``forward`` (:313-649) under the ``"exact"``
and ``"where"`` mask modes; training runs ``"where"``, the
``mask_plan(train=True)`` choice (train_loop.py:147-148).

Layouts follow the JAX package at the public surface: images in are NHWC
``(B, H, W, 3)``, outputs are ``cls_logits (B, h, w, A, 2)`` and
``bbox_deltas (B, h, w, A, 4)``, and parameters are addressed by the names
of ``param_shapes``. Inside, the conv stack runs NCHW-shaped tensors in
``torch.channels_last`` memory, which is the NHWC the stem kernel writes.
Conv weights are OIHW (``io/weights.py`` converts from HWIO).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from smallhardface_tpu_torch.models.layers import (
    bilinear_kernel, conv2d, conv3x3, max_pool_2x2, upsample2x_bilinear,
    zero_outside)
from smallhardface_tpu_torch.ops.stem import fused_stem

# (name, out_channels, n_convs) per VGG stage
VGG_STAGES = (
    ("conv1", 64, 2),
    ("conv2", 128, 2),
    ("conv3", 256, 3),
    ("conv4", 512, 3),
    ("conv5", 512, 3),
)

ANCHOR_SCALES = (1, 2, 4)
HEAD_DILATIONS = (1, 2, 4)
FEAT_STRIDE = 8


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Declarative detector description (the prototxt-template analog)."""
    different_dilation: bool = True
    head_channels: int = 128
    lateral_channels: int = 256
    fuse_channels: int = 512
    dim_red_channels: int = 128
    num_classes: int = 2
    num_anchors: int = len(ANCHOR_SCALES)
    backbone_lr_mult: float = 2.0
    head_lr_mult: float = 1.0


def build_spec(cfg) -> ModelSpec:
    """The spec from the global config (same keys as the JAX package)."""
    return ModelSpec(
        different_dilation=bool(cfg.MODEL.DIFFERENT_DILATION.ENABLE),
        backbone_lr_mult=float(cfg.TRAIN.LR.BACKBONE_MULT),
        head_lr_mult=float(cfg.TRAIN.LR.HEAD_MULT),
    )


def param_shapes(spec: ModelSpec):
    """Shape tree {name: {'w': HWIO, 'b': (O,)}} for every learnable conv,
    plus the fixed bilinear deconv kernel under 'conv5_256_up', in the JAX
    package's (and the checkpoints') HWIO layout. The port's tensors are
    the OIHW transposes (``io/weights.py``)."""
    shapes = {}
    in_c = 3
    for stage, out_c, n in VGG_STAGES:
        for i in range(1, n + 1):
            shapes[f"{stage}_{i}"] = {"w": (3, 3, in_c, out_c), "b": (out_c,)}
            in_c = out_c
    lat = spec.lateral_channels
    stage_out = {stage: out_c for stage, out_c, _ in VGG_STAGES}
    shapes["conv5_256"] = {"w": (1, 1, stage_out["conv5"], lat),
                           "b": (lat,)}
    shapes["conv4_256"] = {"w": (1, 1, stage_out["conv4"], lat),
                           "b": (lat,)}
    shapes["conv5_256_up"] = {"w": (4, 4, 1, lat)}
    shapes["conv4_fuse_final"] = {
        "w": (3, 3, 2 * lat, spec.fuse_channels), "b": (spec.fuse_channels,)}
    head_in = spec.fuse_channels
    if spec.different_dilation:
        shapes["conv4_fuse_final_dim_red"] = {
            "w": (3, 3, spec.fuse_channels, spec.dim_red_channels),
            "b": (spec.dim_red_channels,)}
        head_in = spec.dim_red_channels
        shapes["head"] = {
            "w": (3, 3, head_in, spec.head_channels),
            "b": (spec.head_channels,)}
        for k in ANCHOR_SCALES:
            shapes[f"cls_score_{k}"] = {
                "w": (1, 1, spec.head_channels, spec.num_classes),
                "b": (spec.num_classes,)}
            shapes[f"bbox_pred_{k}"] = {
                "w": (1, 1, spec.head_channels, 4), "b": (4,)}
    else:
        shapes["head"] = {
            "w": (3, 3, head_in, spec.head_channels),
            "b": (spec.head_channels,)}
        shapes["cls_score"] = {
            "w": (1, 1, spec.head_channels,
                  spec.num_anchors * spec.num_classes),
            "b": (spec.num_anchors * spec.num_classes,)}
        shapes["bbox_pred"] = {
            "w": (1, 1, spec.head_channels, spec.num_anchors * 4),
            "b": (spec.num_anchors * 4,)}
    return shapes


def oihw(shape):
    """HWIO shape → the port's OIHW shape."""
    kh, kw, ci, co = shape
    return (co, ci, kh, kw)


def init_params(generator: torch.Generator, spec: ModelSpec):
    """Initial weights, with the JAX package's distributions: He-normal
    (std sqrt(2 / (kh·kw·ci))) backbone convs with zero biases,
    gaussian(0, 0.01) laterals, fuse and heads with zero biases, and the
    fixed bilinear deconv. Draws come from ``generator`` (CPU) in sorted
    name order; torch and jax give different numbers from one seed.
    Returns {name: {'w': OIHW, 'b': (O,)}} float32 CPU tensors."""
    backbone = {f"{stage}_{i}" for stage, _, n in VGG_STAGES
                for i in range(1, n + 1)}
    params = {}
    for name, tree in sorted(param_shapes(spec).items()):
        if name == "conv5_256_up":
            w = bilinear_kernel(2, spec.lateral_channels).transpose(3, 2, 0, 1)
            params[name] = {"w": torch.from_numpy(np.ascontiguousarray(w))}
            continue
        kh, kw, ci, _ = tree["w"]
        std = math.sqrt(2.0 / (kh * kw * ci)) if name in backbone else 0.01
        params[name] = {
            "w": std * torch.randn(oihw(tree["w"]), generator=generator,
                                   dtype=torch.float32),
            "b": torch.zeros(tree["b"], dtype=torch.float32)}
    return params


def param_multipliers(spec: ModelSpec):
    """Per-leaf (lr_mult, decay_mult) trees of the template ParamSpecs after
    ``_apply_mult_lr`` (manipulate.py:154-163):

    - conv1/conv2: frozen (0, 0)
    - conv3..conv5: w (1,1), b (2,1)   [decay_mult defaults to 1 in Caffe]
    - laterals + fuse: w (1,1), b (2,1); dim_red: w (1,1), b (2,1)
    - deconv: (0, 0)
    - head: w (1,1), b (2,0); cls/bbox: w (1,1), b (2,0)
    - then lr_mult ×BACKBONE_MULT for everything before the heads,
      ×HEAD_MULT for head/cls/bbox.
    """
    shapes = param_shapes(spec)
    lr, decay = {}, {}
    head_names = {"head", "cls_score", "bbox_pred"} | {
        f"cls_score_{k}" for k in ANCHOR_SCALES} | {
        f"bbox_pred_{k}" for k in ANCHOR_SCALES}
    for name, tree in shapes.items():
        is_head = name in head_names
        mult = spec.head_lr_mult if is_head else spec.backbone_lr_mult
        if name.startswith(("conv1_", "conv2_")) or name == "conv5_256_up":
            lr[name] = {k: 0.0 for k in tree}
            decay[name] = {k: 0.0 for k in tree}
            continue
        lr[name] = {"w": 1.0 * mult, "b": 2.0 * mult}
        decay[name] = {"w": 1.0, "b": 0.0 if is_head else 1.0}
    return lr, decay


def forward_flops(spec: ModelSpec, h, w, batch=1):
    """Analytic conv FLOPs (2×MACs, biases/activations ignored) of one
    forward pass at input size (h, w)."""
    shapes = param_shapes(spec)

    def cf(name, hs, ws):
        kh, kw, ci, co = shapes[name]["w"]
        return 2.0 * hs * ws * kh * kw * ci * co

    total = 0.0
    s = 1
    for stage, _, n in VGG_STAGES:
        hs, ws = math.ceil(h / s), math.ceil(w / s)
        for i in range(1, n + 1):
            total += cf(f"{stage}_{i}", hs, ws)
        if stage != "conv5":
            s *= 2
    h16, w16 = math.ceil(h / 16), math.ceil(w / 16)
    h8, w8 = math.ceil(h / 8), math.ceil(w / 8)
    total += cf("conv5_256", h16, w16)
    kh, kw, _, co = shapes["conv5_256_up"]["w"]
    total += 2.0 * h8 * w8 * kh * kw * co          # grouped bilinear deconv
    total += cf("conv4_256", h8, w8)
    total += cf("conv4_fuse_final", h8, w8)
    if spec.different_dilation:
        total += cf("conv4_fuse_final_dim_red", h8, w8)
        for k in ANCHOR_SCALES:
            total += cf("head", h8, w8)
            total += cf(f"cls_score_{k}", h8, w8)
            total += cf(f"bbox_pred_{k}", h8, w8)
    else:
        total += cf("head", h8, w8)
        total += cf("cls_score", h8, w8)
        total += cf("bbox_pred", h8, w8)
    return batch * total


def pin_fp32_numerics():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, and make
    cuDNN pick deterministic algorithms. Process-wide PyTorch flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


class Detector(nn.Module):
    """The detector as an ``nn.Module``.

    ``params``: {name: {'w': OIHW, 'b': (O,)}} tensors, as ``init_params``
    or ``io/weights.params_from_numpy`` give them; they move to ``device``.
    With ``trainable=True`` each leaf requires a gradient exactly when its
    lr_mult (``param_multipliers``) is > 0, so conv1_*, conv2_* and
    ``conv5_256_up`` stay frozen and autograd skips them (the stem's
    backward kernel then never runs); otherwise no leaf requires one.

    Building a Detector pins fp32 numerics for the process
    (``pin_fp32_numerics``): ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` become False, because cuDNN
    runs fp32 convolutions in TF32 by default and the JAX reference is true
    fp32; ``torch.backends.cudnn.deterministic`` becomes True so repeated
    detections are identical. ``torch.backends.cudnn.benchmark`` stays off:
    pyramid shapes vary per image.
    """

    def __init__(self, params, spec: ModelSpec, device, trainable=False):
        super().__init__()
        pin_fp32_numerics()
        self.spec = spec
        shapes = param_shapes(spec)
        lr_mults, _ = param_multipliers(spec)
        missing = set(shapes) ^ set(params)
        if missing:
            raise KeyError(f"parameter names differ from param_shapes: "
                           f"{sorted(missing)}")
        self.params = nn.ModuleDict()
        for name, tree in shapes.items():
            leaf = nn.ParameterDict()
            for k, shape in tree.items():
                t = torch.as_tensor(params[name][k], dtype=torch.float32)
                want = oihw(shape) if k == "w" else tuple(shape)
                if tuple(t.shape) != want:
                    raise ValueError(f"{name}/{k}: shape {tuple(t.shape)}, "
                                     f"expected {want}")
                if t.dim() == 4:
                    t = t.contiguous(memory_format=torch.channels_last)
                # a copy: in-place solver steps must not reach the caller
                leaf[k] = nn.Parameter(
                    t.to(device, copy=True),
                    requires_grad=trainable and lr_mults[name][k] > 0)
            self.params[name] = leaf

    def tree(self):
        """The parameters as a {name: {'w'|'b': Parameter}} dict (the
        layout of ``param_shapes``, OIHW), sharing storage."""
        return {name: dict(leaf.items()) for name, leaf in self.params.items()}

    def _w(self, name):
        return self.params[name]["w"], self.params[name]["b"]

    def forward(self, x, valid_hw=None):
        """x: NHWC (B, H, W, 3) float32, BGR mean-subtracted, H and W
        multiples of 16, contiguous. Returns {'cls_logits': (B, h, w, A, 2),
        'bbox_deltas': (B, h, w, A, 4)} at stride 8, anchors ordered as
        ANCHOR_SCALES.

        valid_hw=None is the JAX ``"exact"`` mode: no masking. With
        ``valid_hw=(vh, vw)`` (the ×16 image extent inside a larger
        tensor), every position outside it is exactly zero before each
        spatial conv, the JAX ``"where"`` mode (detector.py:435-446,
        :503-522); outputs beyond (vh/8, vw/8) are not meaningful. vh and
        vw may be (B,) int tensors, one extent per item, as the JAX
        ``"where"`` mode gives each item of a ``vmap`` its own (detection
        of a bucketed batch; the stem then takes no gradient).
        """
        spec = self.spec
        stride = 1

        def mask(h):
            if valid_hw is None:
                return h
            return zero_outside(h, valid_hw[0] // stride,
                                valid_hw[1] // stride)

        def cbr(h, name):
            w, b = self._w(name)
            return mask(F.relu(conv3x3(h, w, b)))

        # VGG-16's stem runs fused (the kernel on the card); it masks its
        # input and conv1_1 itself, and its NHWC output is an NCHW-shaped
        # channels_last tensor through a free permute. Other first stages
        # (the skeletal nets of the tests) run as plain convs like the JAX
        # forward (detector.py:528-530).
        fused = VGG_STAGES[0] == ("conv1", 64, 2)
        if fused:
            w1, b1 = self._w("conv1_1")
            w2, b2 = self._w("conv1_2")
            h = fused_stem(x, w1, b1, w2, b2, valid_hw=valid_hw)
            h = h.permute(0, 3, 1, 2)
            stride *= 2
            h = mask(h)
        else:
            h = mask(x.permute(0, 3, 1, 2))
        feats = {}
        for si, (stage, _, n) in enumerate(VGG_STAGES):
            if fused and stage == "conv1":
                continue
            for i in range(1, n + 1):
                h = cbr(h, f"{stage}_{i}")
            feats[stage] = h
            if si < len(VGG_STAGES) - 1:
                h = max_pool_2x2(h)
                stride *= 2

        w, b = self._w("conv5_256")
        f5 = mask(F.relu(conv2d(feats["conv5"], w, b)))
        up = upsample2x_bilinear(f5, self.params["conv5_256_up"]["w"])
        stride //= 2                       # back to the stride-8 grid
        w, b = self._w("conv4_256")
        lat4 = F.relu(conv2d(feats["conv4"], w, b))
        ff = cbr(mask(torch.cat([mask(up), lat4], dim=1)), "conv4_fuse_final")

        bsz, _, hh, ww = ff.shape
        A = spec.num_anchors
        if spec.different_dilation:
            ff = cbr(ff, "conv4_fuse_final_dim_red")
            hw, hb = self._w("head")
            cls_list, box_list = [], []
            for k, d in zip(ANCHOR_SCALES, HEAD_DILATIONS):
                hd = F.relu(conv3x3(ff, hw, hb, dilation=d))
                cls_list.append(conv2d(hd, *self._w(f"cls_score_{k}")))
                box_list.append(conv2d(hd, *self._w(f"bbox_pred_{k}")))
            # (B, C, h, w) per anchor → (B, h, w, A, C)
            cls_logits = torch.stack(cls_list, dim=-1).permute(0, 2, 3, 4, 1)
            bbox_deltas = torch.stack(box_list, dim=-1).permute(0, 2, 3, 4, 1)
        else:
            hd = cbr(ff, "head")
            raw_cls = conv2d(hd, *self._w("cls_score")).permute(0, 2, 3, 1)
            raw_box = conv2d(hd, *self._w("bbox_pred")).permute(0, 2, 3, 1)
            # cls channels are [bg_a0.. bg_aA, fg_a0.. fg_aA]; bbox channels
            # are anchor-major groups of 4
            cls_logits = raw_cls.reshape(bsz, hh, ww, 2, A).transpose(3, 4)
            bbox_deltas = raw_box.reshape(bsz, hh, ww, A, 4)
        return {"cls_logits": cls_logits.contiguous(),
                "bbox_deltas": bbox_deltas.contiguous()}
