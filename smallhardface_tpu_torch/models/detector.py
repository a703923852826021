"""The smallhardface detector in PyTorch: VGG-16 backbone + FPN-lite fusion
+ detection heads.

Counterpart of ``smallhardface_tpu/models/detector.py``: the spec and
shape tables (:32-234), ``init_params`` (:133-163), ``param_multipliers``
(:166-194), the graph of ``forward`` (:313-649) under the ``"exact"``
and ``"where"`` mask modes, in fp32 and in the int8 serving mode
(``precision="int8"``, :399-419, :456-519, :597-600, :613-621) and in
the bfloat16 mode (``precision="bfloat16"``, :420-421, :547-566,
:649-650; inference only: the JAX package's own bf16 gradient does not
run), and the int8 calibration helpers ``int8_layer_names``,
``make_qstate`` and ``collect_int8_amax`` (:652-702); training runs
``"where"``, the ``mask_plan(train=True)`` choice (train_loop.py:147-148).

Layouts follow the JAX package at the public surface: images in are NHWC
``(B, H, W, 3)``, outputs are ``cls_logits (B, h, w, A, 2)`` and
``bbox_deltas (B, h, w, A, 4)``, and parameters are addressed by the names
of ``param_shapes``. Inside, the conv stack runs NCHW-shaped tensors in
``torch.channels_last`` memory, which is the NHWC the stem kernel writes.
Conv weights are OIHW (``io/weights.py`` converts from HWIO).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from smallhardface_tpu_torch.io import caffemodel, weights
from smallhardface_tpu_torch.models.layers import (
    bilinear_kernel, conv2d, conv2d_int8, conv2d_int8_chain, conv3x3,
    dynamic_amax, dynamic_step, kernel_weights, max_pool_2x2, quantize_int8,
    quantize_weights_int8, upsample2x_bilinear, zero_outside)
from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.ops import decode as decode_mod
from smallhardface_tpu_torch.ops.stem import fused_stem, fused_stem_spatial
from smallhardface_tpu_torch.parallel import spatial

# (name, out_channels, n_convs) per VGG stage
VGG_STAGES = (
    ("conv1", 64, 2),
    ("conv2", 128, 2),
    ("conv3", 256, 3),
    ("conv4", 512, 3),
    ("conv5", 512, 3),
)

ARCH = "smallhardface"
# lib/test.py's detection cut
CONFIDENCE_THRESHOLD = 0.05
ANCHOR_SCALES = (1, 2, 4)
HEAD_DILATIONS = (1, 2, 4)
FEAT_STRIDE = 8
# the anchors of one stride-8 cell, one per scale (x1, y1, x2, y2)
BASE_ANCHORS = anchors_mod.generate_anchors(
    base_size=16, ratios=[1], scales=list(ANCHOR_SCALES), shifts=[0],
    strides=[FEAT_STRIDE] * 3)


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


def scope(name):
    """The forward's per-layer profiler scope: a
    ``torch.profiler.record_function`` range named like the JAX forward's
    ``jax.named_scope`` (detector.py:512-620) while a profiler records on
    this thread, so ``tools/measure.Trace`` groups the kernels by layer;
    otherwise nothing. It changes no bit of any output."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def scope_names(spec: ModelSpec):
    """The forward's scopes in the order it opens them: JAX's names
    ("pallas_stem" for the fused stem: conv1_1, conv1_2 and pool1; each
    conv, conv5_256, conv5_256_up, conv4_256, head_<k> around a dilated
    head and its two 1×1 convs), and ones JAX leaves unscoped: "pool<n>"
    for each pool, and "cls_score" / "bbox_pred" of the single head."""
    names = []
    fused = VGG_STAGES[0] == ("conv1", 64, 2)
    for si, (stage, _, n) in enumerate(VGG_STAGES):
        if fused and stage == "conv1":
            names.append("pallas_stem")     # conv1_1, conv1_2 and pool1
            continue
        names += [f"{stage}_{i}" for i in range(1, n + 1)]
        if si < len(VGG_STAGES) - 1:
            names.append(f"pool{si + 1}")
    names += ["conv5_256", "conv5_256_up", "conv4_256", "conv4_fuse_final"]
    if spec.different_dilation:
        names.append("conv4_fuse_final_dim_red")
        names += [f"head_{k}" for k in ANCHOR_SCALES]
    else:
        names += ["head", "cls_score", "bbox_pred"]
    return names


def build(params, spec: ModelSpec, device):
    """The forward for detection (``models.for_config``)."""
    return Detector(params, spec, device)


def refuse(cfg, path, spatial_devices=None):
    """Nothing: this detector runs every path (``models.for_config``)."""


def load_params(path, spec: ModelSpec, seed):
    """TEST.MODEL (``path``): random init from ``seed`` when empty; a
    ``.caffemodel`` loaded by layer name over that init (JAX
    test_runner.py:31-43); else an ``.npz`` checkpoint of either package."""
    if not path or path.endswith(".caffemodel"):
        params = init_params(torch.Generator().manual_seed(seed), spec)
        if not path:
            return params
        return caffemodel.load_into_params(path, params)
    return weights.load_params(path)


def _per_item(fields, key, reps):
    """Level field ``key`` of each image (``fields``: the level's numbers
    on the device), once per item (image, mirror)."""
    return fields[key].repeat_interleave(reps)


def pin_fp32_numerics():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, keep cuBLAS
    from reducing bf16 sums in bf16 (PyTorch allows it by default; the JAX
    bf16 mode sums in fp32), and make cuDNN pick deterministic algorithms.
    Process-wide PyTorch flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
        # decode's base anchors, held on the device (a few hundred bytes)
        self.base_anchors = torch.as_tensor(
            np.asarray(BASE_ANCHORS, np.float32), device=device)

    def tree(self):
        """The parameters as a {name: {'w'|'b': Parameter}} dict (the
        layout of ``param_shapes``, OIHW), sharing storage."""
        return {name: dict(leaf.items()) for name, leaf in self.params.items()}

    def _w(self, name):
        return self.params[name]["w"], self.params[name]["b"]

    def bf16_tree(self):
        """The weights and biases rounded to bf16, {name: {'w', 'b'}}: the
        JAX forward rounds them at every conv (layers.py:33-34, :46); here
        they are rounded once and kept until a parameter is replaced or
        changed in place (its storage or version counter moves)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if getattr(self, "_bf16_key", None) != key:
            with torch.no_grad():
                self._bf16 = {name: {k: v.to(torch.bfloat16)
                                     for k, v in leaf.items()}
                              for name, leaf in self.params.items()}
            self._bf16_key = key
        return self._bf16

    def _on(self, tree, device):
        """tree ({name: {key: tensor}} or {name: tensor}) with its tensors
        on ``device``: the tree itself when they are there, else copies (a
        shard on another card reads its own copy of the weights). Under
        grad mode with a leaf that needs a gradient the copies keep their
        autograd link, so each shard's weight gradient is summed onto the
        tree's leaves (the JAX step's psum of the replicated parameters),
        and they are made anew at every call; otherwise they are detached
        and kept until a tensor of the tree is replaced or changed in
        place."""
        leaves = [t for v in tree.values()
                  for t in (v.values() if isinstance(
                      v, (dict, nn.ParameterDict)) else [v])]
        if leaves[0].device == device:
            return tree
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return {n: ({k: t.to(device) for k, t in v.items()}
                        if not isinstance(v, torch.Tensor) else v.to(device))
                    for n, v in tree.items()}
        stamp = tuple((t.data_ptr(), t._version) for t in leaves)
        cache = self.__dict__.setdefault("_replicas", {})
        key = (id(tree), device)
        if key not in cache or cache[key][1] != stamp:
            with torch.no_grad():
                copy = {n: ({k: t.detach().to(device) for k, t in v.items()}
                            if not isinstance(v, torch.Tensor)
                            else v.detach().to(device))
                        for n, v in tree.items()}
            # the tree is held so that its id stays its own
            cache[key] = (tree, stamp, copy)
        return cache[key][2]

    def forward(self, x, valid_hw=None, precision="float32", qstate=None,
                int8_amax=None, scale_groups=None):
        """x: NHWC (B, H, W, 3) float32, BGR mean-subtracted, H and W
        multiples of 16, contiguous. Returns {'cls_logits': (B, h, w, A, 2),
        'bbox_deltas': (B, h, w, A, 4)} at stride 8, anchors ordered as
        ANCHOR_SCALES.

        x may also be an H-sharded image (``parallel/spatial``, JAX
        ``forward(spatial_mesh=…)``, detector.py:316, :526-562): a list of
        k NHWC shards of equal rows, the i-th holding global rows
        [i·Hs, (i + 1)·Hs) on its device, Hs a multiple of
        ``spatial.ALIGN`` (``spatial.shard_input`` pads and splits). The
        same body runs per shard: the stem as K4 (``fused_stem_spatial``),
        every other 3×3 convolution and the upsample on a halo of its
        dilation's rows from the neighbours (``spatial.halo``), the masks
        at each shard's global row offset, int8's dynamic steps and the
        calibration's maxima over every shard (``spatial.amax``); the
        outputs are gathered to the first shard's device. Weights are read
        on each shard's device (``_on``); in training their copies carry
        each shard's gradient back to the parameters, and the halos and
        the gather carry their transposes. One shard is the one-device
        forward.

        valid_hw=None is the JAX ``"exact"`` mode: no masking. With
        ``valid_hw=(vh, vw)`` (the ×16 image extent inside a larger
        tensor), every position outside it is exactly zero before each
        spatial conv, the JAX ``"where"`` mode (detector.py:435-446,
        :503-522); outputs beyond (vh/8, vw/8) are not meaningful. vh and
        vw may be (B,) int tensors, one extent per item, as the JAX
        ``"where"`` mode gives each item of a ``vmap`` its own (detection
        of a bucketed batch; the stem then takes no gradient).

        ``precision="int8"`` is the JAX int8 serving mode (inference
        only): the 3×3 convs of stages 2-5, the fusion convs and the
        shared head run as int8 products (``ops/conv_int8``); the stem
        (fp32, ``fused_stem``), the 1×1 laterals and the score/bbox convs
        stay fp32. With a ``qstate`` (``make_qstate``) it is the calibrated
        chain: the carriers between convs are int8 on each successor's
        grid (``_qsucc``); without one, each conv quantizes its fp32 input
        with a dynamic step, shared by the items of one ``scale_groups``
        id ((B,) int tensor; None: by the whole batch, as one JAX forward
        call shares it). ``int8_amax``: a dict to fold max|input| of every
        int8 conv into (0-d tensors; "head" on its input ``ff``), the
        fp32 calibration forward's hook.

        ``precision="bfloat16"`` is the JAX bf16 mode: x is rounded to
        bf16 first (detector.py:420-421); the stem runs in fp32
        (``fused_stem``) on that rounded input, as the JAX forward runs
        the fp32 Pallas kernel, and its output is rounded to bf16; every
        other conv is a bf16 product rounded once, then its bf16 bias
        (``layers.conv2d``), on the weights of ``bf16_tree``; the outputs
        are cast to fp32 (:649-650).
        """
        spec = self.spec
        if precision not in ("float32", "int8", "bfloat16"):
            raise ValueError(f"precision must be 'float32', 'int8' or "
                             f"'bfloat16', got {precision!r}")
        int8 = precision == "int8"
        bf16 = precision == "bfloat16"
        hs = list(x) if isinstance(x, (list, tuple)) else [x]
        k = len(hs)
        if k > 1 and (any(h.shape[1] != hs[0].shape[1] for h in hs)
                      or hs[0].shape[1] % spatial.ALIGN):
            raise ValueError(
                "Detector.forward: the shards need one row count, a "
                f"multiple of {spatial.ALIGN}, got {[h.shape[1] for h in hs]}")
        devs = [h.device for h in hs]
        tree = self.bf16_tree() if bf16 else self.params
        weights = [self._on(tree, d) for d in devs]
        if int8 and qstate is not None:
            qs = [dict(qstate, qw=self._on(qstate["qw"], d),
                       s_w=self._on(qstate["s_w"], d)) for d in devs]
        if bf16:
            hs = [h.to(torch.bfloat16) for h in hs]
        succ = _qsucc(spec) if int8 and qstate is not None else {}
        stride = 1

        def w_b(i, name):
            return weights[i][name]["w"], weights[i][name]["b"]

        def mask(hs):
            if valid_hw is None:
                return hs
            return [zero_outside(h, valid_hw[0] // stride,
                                 valid_hw[1] // stride, row0=i * h.shape[2])
                    for i, h in enumerate(hs)]

        def q_in(h, name):
            """h as an int8 carrier on `name`'s calibrated input grid (an
            int8 carrier is on it already)."""
            if h.dtype == torch.int8:
                return h
            return quantize_int8(h, input_step(qstate, name))

        def q_conv(hs, name, dilation=1):
            """One int8 conv per shard: fp32 post-ReLU out, or int8 on the
            successor's grid inside the calibrated chain."""
            if qstate is None:
                # the dynamic step over every shard of each item's group
                step = dynamic_step(spatial.amax(
                    [dynamic_amax(h, scale_groups) for h in hs]))
            out = []
            for i, (h, rows) in enumerate(spatial.halo(hs, dilation)):
                w, b = w_b(i, name)
                if qstate is None:
                    out.append(F.relu(conv2d_int8(
                        h, w, b, dilation=dilation, groups=scale_groups,
                        s_x=step.to(h.device), halo=rows)))
                    continue
                nxt = succ.get(name)
                out.append(conv2d_int8_chain(
                    q_in(h, name), qs[i]["qw"][name],
                    input_step(qstate, name), qs[i]["s_w"][name], b,
                    dilation=dilation, halo=rows,
                    s_out=None if nxt is None else input_step(qstate, nxt)))
            return out

        def conv_relu(hs, name, dilation=1):
            return [conv3x3(h, *w_b(i, name), dilation=dilation, halo=rows,
                            relu=True)
                    for i, (h, rows) in enumerate(spatial.halo(hs, dilation))]

        def record(name, hs):
            a = spatial.amax([h.detach().abs().amax() for h in hs])
            int8_amax[name] = (torch.maximum(int8_amax[name], a)
                               if name in int8_amax else a)

        def cbr(hs, name):
            with scope(name):
                if not name.startswith("conv1"):
                    if int8:
                        return mask(q_conv(hs, name))
                    if int8_amax is not None:
                        record(name, hs)
                return mask(conv_relu(hs, name))

        # VGG-16's stem runs fused (the kernel on the card), in fp32 in the
        # int8 mode too; it masks its input and conv1_1 itself, and its
        # NHWC output is an NCHW-shaped channels_last tensor through a free
        # permute. Over shards it runs as K4. Other first stages (the
        # skeletal nets of the tests) run as plain convs like the JAX
        # forward (detector.py:528-530).
        fused = VGG_STAGES[0] == ("conv1", 64, 2)
        if fused:
            stem_w = (*self._w("conv1_1"), *self._w("conv1_2"))
            stem_in = [h.float() if bf16 else h for h in hs]
            with scope("pallas_stem"):
                if k == 1:
                    out = [fused_stem(stem_in[0], *stem_w,
                                      valid_hw=valid_hw)]
                else:
                    out = fused_stem_spatial(stem_in, *stem_w,
                                             valid_hw=valid_hw)
                hs = [h.permute(0, 3, 1, 2).to(hs[0].dtype) for h in out]
                stride *= 2
                hs = mask(hs)
        else:
            hs = mask([h.permute(0, 3, 1, 2) for h in hs])
        feats = {}
        for si, (stage, _, n) in enumerate(VGG_STAGES):
            if fused and stage == "conv1":
                continue
            for i in range(1, n + 1):
                hs = cbr(hs, f"{stage}_{i}")
            feats[stage] = hs
            if si < len(VGG_STAGES) - 1:
                with scope(f"pool{si + 1}"):
                    hs = [max_pool_2x2(h) for h in hs]
                stride *= 2

        with scope("conv5_256"):
            f5 = mask([F.relu(conv2d(h, *w_b(i, "conv5_256")))
                       for i, h in enumerate(feats["conv5"])])
        with scope("conv5_256_up"):
            up = [upsample2x_bilinear(h, weights[i]["conv5_256_up"]["w"],
                                      halo=rows)
                  for i, (h, rows) in enumerate(spatial.halo(f5, 1))]
        stride //= 2                       # back to the stride-8 grid
        f4 = feats["conv4"]
        with scope("conv4_256"):
            if f4[0].dtype == torch.int8:
                # the chain left conv4_3's output on conv5_1's grid; the
                # fp32 1×1 lateral reads it dequantized
                f4 = [h.float() * input_step(qstate, "conv5_1") for h in f4]
            lat4 = [F.relu(conv2d(h, *w_b(i, "conv4_256")))
                    for i, h in enumerate(f4)]
        ff = cbr(mask([torch.cat([u, l], dim=1)
                       for u, l in zip(mask(up), lat4)]), "conv4_fuse_final")

        A = spec.num_anchors
        if spec.different_dilation:
            ff = cbr(ff, "conv4_fuse_final_dim_red")
            if int8_amax is not None:
                record("head", ff)
            cls_list, box_list = [], []
            for ks, d in zip(ANCHOR_SCALES, HEAD_DILATIONS):
                with scope(f"head_{ks}"):
                    if int8:
                        hd = q_conv(ff, "head", d)
                    else:
                        hd = conv_relu(ff, "head", d)
                    cls_list.append([conv2d(h, *w_b(i, f"cls_score_{ks}"))
                                     for i, h in enumerate(hd)])
                    box_list.append([conv2d(h, *w_b(i, f"bbox_pred_{ks}"))
                                     for i, h in enumerate(hd)])
            # (B, C, h, w) per anchor → (B, h, w, A, C), per shard
            cls_logits = [torch.stack(c, dim=-1).permute(0, 2, 3, 4, 1)
                          for c in zip(*cls_list)]
            bbox_deltas = [torch.stack(c, dim=-1).permute(0, 2, 3, 4, 1)
                           for c in zip(*box_list)]
        else:
            hd = cbr(ff, "head")
            cls_logits, bbox_deltas = [], []
            for i, h in enumerate(hd):
                with scope("cls_score"):
                    raw_cls = conv2d(h, *w_b(i, "cls_score")).permute(
                        0, 2, 3, 1)
                with scope("bbox_pred"):
                    raw_box = conv2d(h, *w_b(i, "bbox_pred")).permute(
                        0, 2, 3, 1)
                bsz, hh, ww = raw_cls.shape[:3]
                # cls channels are [bg_a0.. bg_aA, fg_a0.. fg_aA]; bbox
                # channels are anchor-major groups of 4
                cls_logits.append(
                    raw_cls.reshape(bsz, hh, ww, 2, A).transpose(3, 4))
                bbox_deltas.append(raw_box.reshape(bsz, hh, ww, A, 4))
        return {"cls_logits": spatial.gather(cls_logits).float().contiguous(),
                "bbox_deltas": spatial.gather(bbox_deltas).float()
                .contiguous()}

    def level_extent(self, lvs, fields, reps, bucketed):
        """What ``forward`` masks a level of N images (metadata ``lvs``,
        F = ``reps`` items each) to: each item's ×16 extent in a shared
        bucket (``bucketed``), from the level's numbers on the device
        (``fields``, the views of ``detect.TorchDetector._level_table``);
        else None."""
        if not bucketed:
            return None
        return (_per_item(fields, "hb", reps), _per_item(fields, "wb", reps))

    def decode_level(self, out, lvs, fields, reps, score_thresh, capacity):
        """One level's rows of N images (``detect._image_rows``): the
        anchor decode clipped to each item's extent, from the level's
        numbers on the device (``fields``) and the base anchors held there;
        w_s (N, 1) and inv_fx (N, 1, 1, 1) views of ``fields``."""
        probs = torch.softmax(out["cls_logits"], dim=-1)[..., 1]
        boxes, scores, counts = decode_mod.decode_proposals_batch(
            probs, out["bbox_deltas"], self.base_anchors,
            feat_stride=FEAT_STRIDE,
            im_h=_per_item(fields, "h_s", reps).float(),
            im_w=_per_item(fields, "w_s", reps).float(),
            valid_h=_per_item(fields, "hb", reps) // FEAT_STRIDE,
            valid_w=_per_item(fields, "wb", reps) // FEAT_STRIDE,
            score_thresh=score_thresh, min_size=0.0, capacity=capacity)
        w_s = fields["w_flip"][:, None] if reps == 2 else None
        return (boxes, scores, counts, w_s,
                fields["inv_fx"][:, None, None, None])


def int8_layer_names(spec: ModelSpec):
    """The convs that run as int8 products under TPU.PRECISION='int8':
    stages 2-5, the fusion conv(s) and the shared dilated head. The stem,
    the 1×1 laterals and the score/bbox convs stay fp32."""
    names = [f"{stage}_{i}" for stage, _, n in VGG_STAGES
             if stage != "conv1" for i in range(1, n + 1)]
    names.append("conv4_fuse_final")
    if spec.different_dilation:
        names.append("conv4_fuse_final_dim_red")
    names.append("head")
    return names


def _qsucc(spec: ModelSpec):
    """The calibrated chain: each int8 conv → the conv whose input grid its
    output is requantized onto; absent (conv5_3, the head), the chain ends
    there in fp32."""
    chain = [f"{stage}_{i}" for stage, _, n in VGG_STAGES
             if stage != "conv1" for i in range(1, n + 1)]
    succ = dict(zip(chain, chain[1:]))
    succ["conv4_fuse_final"] = ("conv4_fuse_final_dim_red"
                                if spec.different_dilation else "head")
    succ["conv4_fuse_final_dim_red"] = "head"
    return succ


def input_step(qstate, name):
    """The step of `name`'s calibrated input grid, amax / 127 divided in
    float32 as JAX divides its float32 scale (a float32 value as a Python
    number)."""
    return float(np.float32(qstate["scales"][name]) / np.float32(127.0))


def make_qstate(params, spec: ModelSpec, amax, device=None):
    """The calibrated int8 state from an amax dict (``collect_int8_amax``):
    {'scales': {name: the amax as a float32 value}, 'qw': {name: (O, 3, 3,
    C) int8}, 's_w': {name: (O,) float32}}, the weights of ``params``
    ({name: {'w': OIHW}}) quantized once per output channel on ``device``
    (theirs when None)."""
    scales, qw, s_w = {}, {}, {}
    for n in int8_layer_names(spec):
        scales[n] = float(np.float32(amax[n]))
        w = params[n]["w"].detach()
        q, s = quantize_weights_int8(w.to(device) if device else w)
        qw[n], s_w[n] = kernel_weights(q), s
    return {"scales": scales, "qw": qw, "s_w": s_w}


def collect_int8_amax(model, xs, devices=None):
    """Calibrate the activation ranges: fp32 forwards of ``model`` (a
    Detector) over xs, each (1, H, W, 3) mean-subtracted, H and W multiples
    of 16, with no valid extent (the zero padding takes part, as in JAX),
    and the per-layer max|input| over all of them, as Python floats. One
    readback per input. ``devices``: a spatial unit to run each input over
    (``spatial.shard_input``; rows it adds are masked, so they read as the
    zero padding)."""
    keys = sorted(int8_layer_names(model.spec))
    device = next(model.parameters()).device
    total = {}
    with torch.inference_mode():
        for x in xs:
            amax = {}
            x = torch.as_tensor(x)
            if devices:
                shards, valid = spatial.shard_input(x, devices)
                model(shards, valid, int8_amax=amax)
            else:
                model(x.to(device), int8_amax=amax)
            vals = torch.stack([amax[k] for k in keys]).cpu().tolist()
            for k, v in zip(keys, vals):
                total[k] = max(total.get(k, 0.0), v)
    return total
