"""RetinaFace with a ResNet-50 body: the port's second detector
(``MODEL.ARCH = "retinaface_r50"``, ``configs/retinaface-r50.toml``).

The architecture of Deng et al., "RetinaFace: Single-stage Dense Face
Localisation in the Wild" (arXiv:1905.00641), as released in
github.com/biubug6/Pytorch_Retinaface (``data/config.py:cfg_re50``,
``models/retinaface.py``, ``models/net.py``): three pyramid levels and no
deformable convolution, every width as published.

- Body: torchvision's ResNet-50 (v1.5, the stride on each first
  bottleneck's 3×3): ``conv1`` 7×7/2 (3 → 64), BN, ReLU, max pool 3×3/2;
  ``layer1``–``layer4`` of [3, 4, 6, 3] bottlenecks of width 64, 128,
  256, 512 and expansion 4 (1×1, BN, ReLU; 3×3/s, BN, ReLU; 1×1, BN; the
  identity or a 1×1/s + BN downsample; ReLU). C3, C4, C5 are ``layer2``,
  ``layer3``, ``layer4`` at strides 8, 16, 32.
- FPN (``in_channels_list`` [512, 1024, 2048], out 256, leaky 0): 1×1 +
  BN + ReLU on C3, C4, C5; o2 = merge2(o2 + nearest(o3)), o1 = merge1(o1 +
  nearest(o2)), each merge a 3×3 + BN + ReLU.
- SSH per level (256 → 256): a = 3×3 (→ 128) + BN; c1 = 3×3 (→ 64) + BN +
  ReLU; b = 3×3 + BN on c1; c2 = 3×3 + BN + ReLU on c1; c = 3×3 + BN on
  c2; the output relu(cat[a, b, c]).
- Heads per level: 1×1 convolutions with bias giving 2 anchors × 2
  classes, 2 × 4 box deltas and 2 × 10 landmark deltas.

Every batch norm runs in inference form, folded into its convolution's
weight and bias when the weights are loaded (``io/retinaface.py``), so a
parameter is one convolution: {name: {'w': OIHW, 'b': (O,)}}, named by the
convolution's module in Pytorch_Retinaface's state dict ("body.conv1",
"body.layer2.0.downsample.0", "fpn.merge1.0", "ssh1.conv3X3.0",
"ClassHead.0.conv1x1", ...). The stride-1 3×3 convolutions run through
``layers.conv3x3`` (C1 in 3xTF32 from ``layers.TAPS_MIN_FLOP`` up, its
ReLU fused, cuDNN below); the 1×1, the strided and the 7×7 convolutions
through ``layers.conv2d`` (cuDNN).

A level may run inside a larger bucket: with ``valid_hw`` = (h, w), the
image's own extent in the input, every position of a map at stride s
outside the first ceil(h / s) rows and ceil(w / s) columns is exactly zero
before each convolution or pool that reads its neighbours, which is the
zero padding the network sees when it runs the image at its own size (as
Pytorch_Retinaface runs it). Outputs beyond each level's valid grid are
not meaningful.

Inference in float32 only; int8, bf16, training, spatial sharding and
batched detection raise (``refuse``, PERF.md §7).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.io import weights
from smallhardface_tpu_torch.models.detector import pin_fp32_numerics, scope
from smallhardface_tpu_torch.models.layers import conv2d, conv3x3
from smallhardface_tpu_torch.ops import anchors, decode

ARCH = "retinaface_r50"
# cfg_re50: the levels' strides, the two anchor sides of each level and the
# decode's variances; test_widerface.py's confidence cut
STEPS = (8, 16, 32)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
VARIANCES = (0.1, 0.2)
CONFIDENCE_THRESHOLD = 0.02
NUM_ANCHORS = 2
# (planes, bottlenecks, stride) of layer1-layer4
RESNET50 = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
FPN_IN = (512, 1024, 2048)
OUT = 256
# each head's outputs an anchor
HEADS = (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10))
BN_EPS = 1e-5


def conv_table():
    """Every convolution in the order of the forward: (name, batch norm
    module or None, cin, cout, k, stride, output stride). ``name`` is the
    convolution's module in Pytorch_Retinaface's state dict; the batch
    norm folded into it is ``bn`` (the heads have a bias instead)."""
    rows = [("body.conv1", "body.bn1", 3, 64, 7, 2, 2)]
    cin, s = 64, 4
    for li, (planes, blocks, stride) in enumerate(RESNET50, 1):
        for i in range(blocks):
            st = stride if i == 0 else 1
            p = f"body.layer{li}.{i}"
            rows += [(f"{p}.conv1", f"{p}.bn1", cin, planes, 1, 1, s),
                     (f"{p}.conv2", f"{p}.bn2", planes, planes, 3, st,
                      s * st),
                     (f"{p}.conv3", f"{p}.bn3", planes, 4 * planes, 1, 1,
                      s * st)]
            if i == 0:
                rows.append((f"{p}.downsample.0", f"{p}.downsample.1", cin,
                             4 * planes, 1, st, s * st))
            cin, s = 4 * planes, s * st
    for k, (c, st) in enumerate(zip(FPN_IN, STEPS), 1):
        rows.append((f"fpn.output{k}.0", f"fpn.output{k}.1", c, OUT, 1, 1,
                     st))
    rows += [("fpn.merge2.0", "fpn.merge2.1", OUT, OUT, 3, 1, 16),
             ("fpn.merge1.0", "fpn.merge1.1", OUT, OUT, 3, 1, 8)]
    for k, st in enumerate(STEPS, 1):
        p = f"ssh{k}"
        rows += [(f"{p}.conv3X3.0", f"{p}.conv3X3.1", OUT, OUT // 2, 3, 1,
                  st),
                 (f"{p}.conv5X5_1.0", f"{p}.conv5X5_1.1", OUT, OUT // 4, 3,
                  1, st),
                 (f"{p}.conv5X5_2.0", f"{p}.conv5X5_2.1", OUT // 4, OUT // 4,
                  3, 1, st),
                 (f"{p}.conv7X7_2.0", f"{p}.conv7X7_2.1", OUT // 4, OUT // 4,
                  3, 1, st),
                 (f"{p}.conv7x7_3.0", f"{p}.conv7x7_3.1", OUT // 4, OUT // 4,
                  3, 1, st)]
    for head, per_anchor in HEADS:
        for k, st in enumerate(STEPS):
            rows.append((f"{head}.{k}.conv1x1", None, OUT,
                         NUM_ANCHORS * per_anchor, 1, 1, st))
    return rows


def param_shapes():
    """{name: {'w': OIHW, 'b': (O,)}} of every (folded) convolution."""
    return {name: {"w": (co, ci, k, k), "b": (co,)}
            for name, _, ci, co, k, _, _ in conv_table()}


def init_params(generator: torch.Generator):
    """Random weights: He-normal convolutions (std sqrt(2 / (k·k·cin)), as
    torchvision draws ResNet's) behind batch norms at their initial state
    (γ = 1, β = 0, mean 0, variance 1, folded: the weight over
    sqrt(1 + eps)), but γ = 0 on each bottleneck's last batch norm
    (torchvision's ``zero_init_residual``, so that the 16 residual sums
    stay bounded without trained statistics); heads at std 0.01 with zero
    biases. Draws come from ``generator`` (CPU) in the order of
    ``conv_table``. Returns {name: {'w', 'b'}} float32 CPU tensors."""
    params = {}
    fold = 1.0 / math.sqrt(1.0 + BN_EPS)
    for name, bn, ci, co, k, _, _ in conv_table():
        std = math.sqrt(2.0 / (k * k * ci)) * fold if bn else 0.01
        if name.endswith(".conv3"):
            std = 0.0
        params[name] = {
            "w": std * torch.randn((co, ci, k, k), generator=generator,
                                   dtype=torch.float32),
            "b": torch.zeros(co, dtype=torch.float32)}
    return params


def build(params, spec, device):
    """The forward for detection (``models.for_config``); no ``spec``."""
    return RetinaFace(params, device)


def refuse(cfg, path, spatial_devices=None):
    """NotImplementedError for training and ``detect_many``; ValueError
    for a detector in any precision but float32, spatially sharded or on
    the host preprocessing path (PERF.md §7)."""
    name = f"MODEL.ARCH={ARCH!r}"
    if path == "train":
        # its multibox and landmark loss is not ported
        raise NotImplementedError(
            f"{name} runs detection only; training is the smallhardface "
            "detector's")
    if path == "detect_many":
        raise NotImplementedError(
            f"detect_many: RetinaFace ({name}) runs one image at a time; "
            "use detect or detect_async")
    precision = str(cfg.TPU.PRECISION)
    if precision != "float32":
        raise ValueError(f"{name} runs in float32 only; TPU.PRECISION="
                         f"{precision!r} is the smallhardface detector's")
    if ((spatial_devices is not None and len(spatial_devices) > 1)
            or int(cfg.TPU.SPATIAL_DEVICES) > 1):
        raise ValueError(f"{name} has no spatially sharded path; set "
                         "TPU.SPATIAL_DEVICES 1")
    if bool(cfg.TPU.HOST_PREPROC):
        raise ValueError(f"{name} has no host preprocessing path; set "
                         "TPU.HOST_PREPROC false")


def load_params(path, spec, seed):
    """TEST.MODEL (``path``): random init from ``seed`` when empty; an
    ``.npz`` checkpoint of the port; else a Pytorch_Retinaface ``.pth``
    (``Resnet50_Final.pth``), its batch norms folded (``io/retinaface``)."""
    if not path:
        return init_params(torch.Generator().manual_seed(seed))
    if path.endswith(".caffemodel"):
        raise ValueError(f"TEST.MODEL={path!r}: RetinaFace loads a "
                         "Pytorch_Retinaface .pth or an .npz checkpoint")
    if path.endswith(".npz"):
        return weights.load_params(path)
    # imported here: io.retinaface reads this module's conv_table
    from smallhardface_tpu_torch.io import retinaface as retinaface_io
    return retinaface_io.load_pth(path)


def forward_flops(h, w, batch=1):
    """Convolution FLOPs (2×MACs) of one forward at an image of (h, w):
    each convolution on its output map, ceil(h / s) × ceil(w / s)."""
    total = 0.0
    for _, _, ci, co, k, _, s in conv_table():
        total += 2.0 * math.ceil(h / s) * math.ceil(w / s) * ci * co * k * k
    return batch * total


class _Masks:
    """Zeros outside the valid extent ``valid`` = (h, w) of the input at
    each stride s, the first ceil(h / s) rows and ceil(w / s) columns: the
    mask of ``layers.zero_outside``, built once per stride and map shape
    and applied in place. With ``valid`` None nothing is masked."""

    def __init__(self, valid):
        self.valid = valid
        self.outside = {}

    def __call__(self, h, s):
        if self.valid is None:
            return h
        H, W = h.shape[2:]
        key = (s, H, W)
        out = self.outside.get(key)
        if out is None:
            vh, vw = -(-int(self.valid[0]) // s), -(-int(self.valid[1]) // s)
            rows = torch.arange(H, device=h.device)[:, None] >= vh
            cols = torch.arange(W, device=h.device)[None, :] >= vw
            out = self.outside[key] = rows | cols
        return h.masked_fill_(out, 0.0)


class RetinaFace:
    """The forward over ``params`` ({name: {'w', 'b'}} as ``param_shapes``,
    batch norms folded), copied to ``device`` as float32 with 4-D weights in
    channels_last memory. Building one pins fp32 numerics for the process
    (``detector.pin_fp32_numerics``: TF32 off, deterministic cuDNN)."""

    def __init__(self, params, device):
        pin_fp32_numerics()
        # the decode's prior grids, by map shape and stride
        self.priors = {}
        shapes = param_shapes()
        missing = set(shapes) ^ set(params)
        if missing:
            raise KeyError("parameter names differ from "
                           f"retinaface.param_shapes: {sorted(missing)}")
        self.params = {}
        for name, tree in shapes.items():
            leaf = {}
            for k, shape in tree.items():
                t = torch.as_tensor(params[name][k], dtype=torch.float32)
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name}/{k}: shape {tuple(t.shape)}, "
                                     f"expected {shape}")
                if t.dim() == 4:
                    t = t.contiguous(memory_format=torch.channels_last)
                leaf[k] = t.to(device, copy=True)
            self.params[name] = leaf

    def _conv(self, h, name, k=1, stride=1, relu=True):
        w, b = self.params[name]["w"], self.params[name]["b"]
        if k == 3 and stride == 1:
            return conv3x3(h, w, b, relu=relu)
        y = conv2d(h, w, b, stride=stride, padding=k // 2)
        return y.relu_() if relu else y

    def _bottleneck(self, x, p, stride, s, mask):
        """One bottleneck of ``p`` ("body.layer<L>.<i>") on x at stride s."""
        h = mask(self._conv(x, f"{p}.conv1"), s)
        h = self._conv(h, f"{p}.conv2", 3, stride)
        h = self._conv(h, f"{p}.conv3", relu=False)
        if f"{p}.downsample.0" in self.params:
            x = self._conv(x, f"{p}.downsample.0", stride=stride, relu=False)
        return h.add_(x).relu_()

    def _ssh(self, x, p, s, mask):
        """The SSH module ``p`` ("ssh<k>") on x at stride s."""
        x = mask(x, s)
        a = self._conv(x, f"{p}.conv3X3.0", 3, relu=False)
        c1 = mask(self._conv(x, f"{p}.conv5X5_1.0", 3), s)
        b = self._conv(c1, f"{p}.conv5X5_2.0", 3, relu=False)
        c2 = mask(self._conv(c1, f"{p}.conv7X7_2.0", 3), s)
        c = self._conv(c2, f"{p}.conv7x7_3.0", 3, relu=False)
        return torch.cat([a, b, c], dim=1).relu_()

    def __call__(self, x, valid_hw=None, precision="float32", qstate=None,
                 scale_groups=None):
        """x: NHWC (B, H, W, 3) float32, BGR mean-subtracted, H and W
        multiples of 32 when ``valid_hw`` = (h, w) gives the image's
        extent in it (numbers); with None, x is the image itself, of any
        size. Returns {'cls_logits', 'bbox_deltas', 'landm_deltas'}: a list
        over the levels (strides 8, 16, 32) of (B, h_k, w_k, 2, C) with C =
        2, 4, 10, anchors ordered as MIN_SIZES. ``qstate`` and
        ``scale_groups`` are the other detector's and must be None."""
        if precision != "float32" or qstate is not None:
            raise ValueError("RetinaFace runs in float32 only, got "
                             f"precision={precision!r}")
        mask = _Masks(valid_hw)
        h = x.permute(0, 3, 1, 2)
        with scope("body.conv1"):
            h = mask(self._conv(h, "body.conv1", 7, 2), 2)
            h = F.max_pool2d(h, 3, 2, padding=1)
        feats, s = [], 4
        for li, (_, blocks, stride) in enumerate(RESNET50, 1):
            with scope(f"body.layer{li}"):
                for i in range(blocks):
                    st = stride if i == 0 else 1
                    h = self._bottleneck(h, f"body.layer{li}.{i}", st, s,
                                         mask)
                    s *= st
            if li > 1:
                feats.append(h)
        with scope("fpn"):
            o1, o2, o3 = (self._conv(f, f"fpn.output{k}.0")
                          for k, f in enumerate(feats, 1))
            o2 = o2.add_(F.interpolate(o3, size=o2.shape[2:],
                                       mode="nearest"))
            o2 = self._conv(mask(o2, 16), "fpn.merge2.0", 3)
            o1 = o1.add_(F.interpolate(o2, size=o1.shape[2:],
                                       mode="nearest"))
            o1 = self._conv(mask(o1, 8), "fpn.merge1.0", 3)
        features = []
        for k, (f, st) in enumerate(zip((o1, o2, o3), STEPS), 1):
            with scope(f"ssh{k}"):
                features.append(self._ssh(f, f"ssh{k}", st, mask))
        out = {"cls_logits": [], "bbox_deltas": [], "landm_deltas": []}
        with scope("heads"):
            for key, (head, per_anchor) in zip(out, HEADS):
                for k, f in enumerate(features):
                    y = self._conv(f, f"{head}.{k}.conv1x1", relu=False)
                    B, _, hh, ww = y.shape
                    out[key].append(y.permute(0, 2, 3, 1).reshape(
                        B, hh, ww, NUM_ANCHORS, per_anchor))
        return out

    def level_extent(self, lvs, fields, reps, bucketed):
        """What the forward masks a level of one image to at every stride:
        its extent (h_s, w_s), host numbers."""
        return lvs[0]["h_s"], lvs[0]["w_s"]

    def decode_level(self, out, lvs, fields, reps, score_thresh, capacity):
        """One level's rows of one image (``detect._image_rows``):
        the priors' variance decode of its three maps over each one's valid
        grid ceil(h_s / step) × ceil(w_s / step) (the extent the image has
        when run at its own size), no clip. The extents are host numbers
        and the priors are built on the device: nothing waits."""
        lv = lvs[0]
        probs = [torch.softmax(c, dim=-1)[..., 1] for c in out["cls_logits"]]
        priors, valid = [], []
        for p, step, sizes in zip(probs, STEPS, MIN_SIZES):
            key = (p.shape[1], p.shape[2], step)
            if key not in self.priors:
                self.priors[key] = anchors.prior_grid(*key, sizes, p.device)
            priors.append(self.priors[key])
            valid.append((-(-lv["h_s"] // step), -(-lv["w_s"] // step)))
        boxes, scores, counts = decode.decode_priors_batch(
            probs, out["bbox_deltas"], priors, valid=valid,
            variances=VARIANCES, score_thresh=score_thresh,
            capacity=capacity)
        return boxes, scores, counts, float(lv["w_s"]), lv["inv_fx"]
