"""RetinaFace with a ResNet-50 body in plain PyTorch, float32: the
reference that the port's ``models/retinaface.py`` and its detection path
are held to.

The modules are Pytorch_Retinaface's (github.com/biubug6/Pytorch_Retinaface,
``models/net.py``: ``conv_bn``, ``conv_bn_no_relu``, ``conv_bn1X1``,
``SSH``, ``FPN``; ``models/retinaface.py``: ``ClassHead``, ``BboxHead``,
``LandmarkHead``, ``RetinaFace`` under ``data/config.py:cfg_re50``) with
their attribute names, so that ``state_dict()`` has the keys of
``Resnet50_Final.pth``; the body is torchvision's ResNet-50 written out
with torchvision's names (``IntermediateLayerGetter`` over layer2-layer4
keeps them). Batch norm is an unfused inference op. Priors
(``layers/functions/prior_box.py``) and ``decode`` (``utils/box_utils.py``)
are computed in pixels instead of in coordinates normalised by the image
size. Nothing here imports JAX, the JAX package or the port: the level
sizes, the linear resize and the vote are the benchmark harness's
(``portbench/reference/detect.py``), as is the TF32 rounding of the
control.

``detect`` is the WIDER protocol as the port runs it, with these
departures from Pytorch_Retinaface's ``test_widerface.py``:

- a pyramid of five short edges with flip, merged across levels, as the
  paper tests (its section 4), where ``test_widerface.py`` runs one scale;
- the port's linear resize (``resize_weights``: cv2's INTER_LINEAR
  convention as a product of weight matrices on the device) instead of
  ``cv2.resize`` on the host;
- per level and item the ``TEST.N_DETS_PER_MODULE`` best rows at or above
  ``TEST.SCORE_THRESH``; then the strict ``> thresh`` cut (0.02, its
  ``--confidence_threshold``), the top ``TPU.VOTE_CAP`` (2,048) rows and the
  score-weighted box vote at ``TEST.NMS_THRESH`` (0.4) instead of its top_k
  5000, NMS at 0.4 and keep_top_k 750;
- boxes and scores only: the landmarks are computed and not decoded.

The benchmark's copy of ``tests/retinaface_ref.py``, frozen with the
harness (``tests/test_torch_port_retinaface.py`` holds the two forwards
equal); ``drivers/eval_retinaface.py`` decides ``correct`` with it and
reads the TF32 control from it.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.detect import levels, resize_weights, vote
from portbench.reference.net import numerics, tf32

# cfg_re50
STEPS = (8, 16, 32)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
VARIANCES = (0.1, 0.2)
IN_CHANNEL, OUT_CHANNEL = 256, 256
HEADS = ("ClassHead", "BboxHead", "LandmarkHead")


def conv_bn(inp, oup, stride=1, leaky=0):
    return nn.Sequential(nn.Conv2d(inp, oup, 3, stride, 1, bias=False),
                         nn.BatchNorm2d(oup),
                         nn.LeakyReLU(negative_slope=leaky, inplace=True))


def conv_bn_no_relu(inp, oup, stride):
    return nn.Sequential(nn.Conv2d(inp, oup, 3, stride, 1, bias=False),
                         nn.BatchNorm2d(oup))


def conv_bn1X1(inp, oup, stride, leaky=0):
    return nn.Sequential(nn.Conv2d(inp, oup, 1, stride, padding=0,
                                   bias=False),
                         nn.BatchNorm2d(oup),
                         nn.LeakyReLU(negative_slope=leaky, inplace=True))


class SSH(nn.Module):
    def __init__(self, in_channel, out_channel):
        super().__init__()
        leaky = 0.1 if out_channel <= 64 else 0
        self.conv3X3 = conv_bn_no_relu(in_channel, out_channel // 2, 1)
        self.conv5X5_1 = conv_bn(in_channel, out_channel // 4, 1, leaky)
        self.conv5X5_2 = conv_bn_no_relu(out_channel // 4, out_channel // 4,
                                         1)
        self.conv7X7_2 = conv_bn(out_channel // 4, out_channel // 4, 1,
                                 leaky)
        self.conv7x7_3 = conv_bn_no_relu(out_channel // 4, out_channel // 4,
                                         1)

    def forward(self, x):
        conv3X3 = self.conv3X3(x)
        conv5X5_1 = self.conv5X5_1(x)
        conv5X5 = self.conv5X5_2(conv5X5_1)
        conv7X7_2 = self.conv7X7_2(conv5X5_1)
        conv7X7 = self.conv7x7_3(conv7X7_2)
        return F.relu(torch.cat([conv3X3, conv5X5, conv7X7], dim=1))


class FPN(nn.Module):
    def __init__(self, in_channels_list, out_channels):
        super().__init__()
        leaky = 0.1 if out_channels <= 64 else 0
        self.output1 = conv_bn1X1(in_channels_list[0], out_channels, 1, leaky)
        self.output2 = conv_bn1X1(in_channels_list[1], out_channels, 1, leaky)
        self.output3 = conv_bn1X1(in_channels_list[2], out_channels, 1, leaky)
        self.merge1 = conv_bn(out_channels, out_channels, leaky=leaky)
        self.merge2 = conv_bn(out_channels, out_channels, leaky=leaky)

    def forward(self, feats):
        output1 = self.output1(feats[0])
        output2 = self.output2(feats[1])
        output3 = self.output3(feats[2])
        up3 = F.interpolate(output3, size=[output2.size(2), output2.size(3)],
                            mode="nearest")
        output2 = self.merge2(output2 + up3)
        up2 = F.interpolate(output2, size=[output1.size(2), output1.size(3)],
                            mode="nearest")
        output1 = self.merge1(output1 + up2)
        return [output1, output2, output3]


class Bottleneck(nn.Module):
    """torchvision's ResNet v1.5 bottleneck: the stride on the 3×3."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Body(nn.Module):
    """torchvision's ``resnet50`` up to layer4 (no pool, no fc), returning
    layer2, layer3 and layer4 as ``IntermediateLayerGetter`` does under
    cfg_re50's ``return_layers``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, blocks, stride) in enumerate(
                ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)), 1):
            down = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4))
            layers = [Bottleneck(inplanes, planes, stride, down)]
            inplanes = planes * 4
            layers += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*layers))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class ClassHead(nn.Module):
    def __init__(self, inchannels=512, num_anchors=3):
        super().__init__()
        self.conv1x1 = nn.Conv2d(inchannels, num_anchors * 2, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1).contiguous()
        return out.view(out.shape[0], -1, 2)


class BboxHead(nn.Module):
    def __init__(self, inchannels=512, num_anchors=3):
        super().__init__()
        self.conv1x1 = nn.Conv2d(inchannels, num_anchors * 4, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1).contiguous()
        return out.view(out.shape[0], -1, 4)


class LandmarkHead(nn.Module):
    def __init__(self, inchannels=512, num_anchors=3):
        super().__init__()
        self.conv1x1 = nn.Conv2d(inchannels, num_anchors * 10, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1).contiguous()
        return out.view(out.shape[0], -1, 10)


class RetinaFace(nn.Module):
    """``RetinaFace(cfg_re50, phase="test")``: ``forward`` gives (box
    deltas (B, N, 4), class probabilities (B, N, 2), landmark deltas
    (B, N, 10)) over the priors of ``priors``; ``logits`` the same with
    the class logits before the softmax."""

    def __init__(self):
        super().__init__()
        self.body = Body()
        self.fpn = FPN([IN_CHANNEL * 2, IN_CHANNEL * 4, IN_CHANNEL * 8],
                       OUT_CHANNEL)
        self.ssh1 = SSH(OUT_CHANNEL, OUT_CHANNEL)
        self.ssh2 = SSH(OUT_CHANNEL, OUT_CHANNEL)
        self.ssh3 = SSH(OUT_CHANNEL, OUT_CHANNEL)
        self.ClassHead = nn.ModuleList(ClassHead(OUT_CHANNEL, 2)
                                       for _ in STEPS)
        self.BboxHead = nn.ModuleList(BboxHead(OUT_CHANNEL, 2)
                                      for _ in STEPS)
        self.LandmarkHead = nn.ModuleList(LandmarkHead(OUT_CHANNEL, 2)
                                          for _ in STEPS)

    def logits(self, x):
        fpn = self.fpn(self.body(x))
        features = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = torch.cat([self.BboxHead[i](f) for i, f in enumerate(features)],
                        dim=1)
        conf = torch.cat([self.ClassHead[i](f)
                          for i, f in enumerate(features)], dim=1)
        landm = torch.cat([self.LandmarkHead[i](f)
                           for i, f in enumerate(features)], dim=1)
        return loc, conf, landm

    def forward(self, x):
        loc, conf, landm = self.logits(x)
        return loc, F.softmax(conf, dim=-1), landm


# γ of each bottleneck's last batch norm (its residual branch's scale).
# With γ = 1 everywhere the random network is chaotic: a rounding grows
# about 1.3× a bottleneck (1e-4 of the features after the 16 of them, in
# fp32 against float64), enough to reorder the near-tied scores that the
# vote reads; at 0.5 it stays near 2e-6, and every branch still carries
# half its output.
RESIDUAL_GAMMA = 0.5


def init_weights(model, seed):
    """Random weights from ``seed``, drawn on the model's device: one
    normal draw for every convolution weight in module order, He-normal
    (std sqrt(2 / (k·k·cin))) but the heads' std 0.01; zero biases; every
    batch norm γ = 1 (``RESIDUAL_GAMMA`` on each bottleneck's bn3), β = 0,
    mean 0, variance 1 (``probe_bn`` then sets its statistics)."""
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, nn.Conv2d)]
    dev = convs[0][1].weight.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    sizes = [m.weight.numel() for _, m in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    off = 0
    with torch.no_grad():
        for (name, m), size in zip(convs, sizes):
            k, ci = m.kernel_size[0], m.in_channels
            std = (0.01 if name.startswith(HEADS)
                   else math.sqrt(2.0 / (k * k * ci)))
            m.weight.copy_(flat[off:off + size].view_as(m.weight) * std)
            if m.bias is not None:
                m.bias.zero_()
            off += size
        for name, m in model.named_modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                if name.endswith(".bn3"):
                    m.weight.fill_(RESIDUAL_GAMMA)


def probe_bn(model, x):
    """Each batch norm's running mean and (biased) variance from one probe
    forward over x (B, 3, H, W), in module order, each set from the batch
    statistics of its input before it normalises it (so later layers see
    normalised inputs), as trained statistics normalise. The model is left
    in eval mode."""
    def hook(bn, args):
        t = args[0]
        bn.running_mean.copy_(t.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(t.var(dim=(0, 2, 3), unbiased=False))

    model.eval()
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, nn.BatchNorm2d)]
    try:
        with torch.no_grad(), numerics("fp32"):
            model(x)
    finally:
        for h in hooks:
            h.remove()


def background_bias(model, x, share, cut):
    """Set the class heads' biases to [+b, −b] an anchor (background,
    face), b such that ``share`` of the priors of the probe x score above
    ``cut`` (face probability sigmoid(l_face − l_bg − 2b)). Returns b."""
    with torch.no_grad(), numerics("fp32"):
        conf = model.logits(x)[1]
        d = (conf[..., 1] - conf[..., 0]).flatten().double()
        b = float((torch.quantile(d, 1.0 - share)
                   - math.log(cut / (1.0 - cut))) / 2)
        for head in model.ClassHead:
            head.conv1x1.bias.copy_(torch.tensor(
                [b, -b] * (head.conv1x1.out_channels // 2)))
    return b


@contextlib.contextmanager
def tf32_control(model):
    """The control: every convolution's operands (input and weight)
    rounded to TF32 (10 mantissa bits, to nearest even, as the tensor
    cores read fp32), products summed in fp32, in the program's place;
    restored on exit."""
    saved, hooks = [], []
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                saved.append((m, m.weight.detach().clone()))
                m.weight.copy_(tf32(m.weight))
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, args: (tf32(args[0]),)))
    try:
        yield
    finally:
        with torch.no_grad():
            for m, w in saved:
                m.weight.copy_(w)
        for h in hooks:
            h.remove()


def priors(h, w, device):
    """The priors of an (h, w) image, in pixels: (N, 4) rows (cx, cy, s, s)
    over the maps ceil(h / step) × ceil(w / step) in (map, row, column,
    min size) order, centre ((j + 0.5)·step, (i + 0.5)·step)."""
    rows = []
    for step, sizes in zip(STEPS, MIN_SIZES):
        fh, fw = -(-h // step), -(-w // step)
        cx = (torch.arange(fw, dtype=torch.float32, device=device)
              + 0.5) * step
        cy = (torch.arange(fh, dtype=torch.float32, device=device)
              + 0.5) * step
        side = torch.tensor(sizes, dtype=torch.float32, device=device)
        A = len(sizes)
        rows.append(torch.stack([cx[None, :, None].expand(fh, fw, A),
                                 cy[:, None, None].expand(fh, fw, A),
                                 side.expand(fh, fw, A),
                                 side.expand(fh, fw, A)], -1).reshape(-1, 4))
    return torch.cat(rows)


def decode(loc, pri, variances=VARIANCES):
    """``utils/box_utils.decode`` in pixels: corners (..., 4)."""
    boxes = torch.cat((pri[..., :2] + loc[..., :2] * variances[0]
                       * pri[..., 2:],
                       pri[..., 2:] * torch.exp(loc[..., 2:] * variances[1])),
                      -1)
    lo = boxes[..., :2] - boxes[..., 2:] / 2
    return torch.cat([lo, boxes[..., 2:] + lo], -1)


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


def detect(model, im, cfg, device, thresh=0.02, control=False, stats=None):
    """(N, 5) float32 detections of one BGR uint8 image ``im`` under the
    configuration ``cfg`` (the TOML as a dict): each level resized as
    ``portbench/reference/detect.py`` resizes it and run unpadded at its
    extent (h_s, w_s) with its mirror; priors, decode, the mirror's boxes
    un-mirrored, the levels merged, the strict ``> thresh`` cut, the top
    ``TPU.VOTE_CAP`` rows and the vote. ``control``: the TF32 control
    (``tf32_control``). ``stats``: a dict that gets the count of merged
    rows above the cut ("above_cut")."""
    test = cfg["TEST"]
    h0, w0 = im.shape[:2]
    H0, W0 = _round_up(h0, 16), _round_up(w0, 16)
    raw = np.pad(im, ((0, H0 - h0), (0, W0 - w0), (0, 0)), mode="edge")
    img = torch.from_numpy(np.ascontiguousarray(raw)).to(device).float()
    mean = torch.tensor(np.asarray(cfg["PIXEL_MEANS"], np.float32)
                        .reshape(3), device=device)
    cap_det = int(test["N_DETS_PER_MODULE"])
    st = float(test["SCORE_THRESH"])
    all_boxes, all_scores = [], []
    ctl = tf32_control(model) if control else contextlib.nullcontext()
    with torch.no_grad(), numerics("fp32"), ctl:
        for scale, inv, h_s, w_s, _, _ in levels(im.shape, test):
            wy = resize_weights(H0, h_s, scale, device)
            wx = resize_weights(W0, w_s, scale, device)
            t = (wy.t() @ img.reshape(H0, W0 * 3)).reshape(h_s, W0, 3)
            res = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1) - mean
            x = torch.stack([res, res.flip(1)]).permute(0, 3, 1, 2)
            loc, conf, _ = model(x.contiguous())
            prob = conf[..., 1]
            boxes = decode(loc, priors(h_s, w_s, device)[None])
            cap = min(cap_det, prob.shape[1])
            n_keep = (prob >= st).sum(1).clamp(1, cap)
            s, order = torch.sort(prob, dim=1, descending=True, stable=True)
            s, order = s[:, :cap], order[:, :cap]
            b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            s = torch.where(torch.arange(cap, device=device)[None]
                            < n_keep[:, None], s, -float("inf"))
            m = b[1]
            ws = torch.tensor(float(w_s), device=device)
            b = torch.stack([b[0], torch.stack([ws - m[:, 2], m[:, 1],
                                                ws - m[:, 0], m[:, 3]], -1)])
            all_boxes.append((b * inv).reshape(-1, 4))
            all_scores.append(s.reshape(-1))
        boxes = torch.cat(all_boxes)
        scores = torch.cat(all_scores)
        keep = scores > thresh
        if stats is not None:
            stats["above_cut"] = int(keep.sum())
        sortable = torch.where(keep, scores, -torch.inf)
        k = min(int(cfg["TPU"]["VOTE_CAP"]), sortable.shape[0])
        top, idx = torch.sort(sortable, descending=True, stable=True)
        n = int(min(int(keep.sum()), k))
        rows = torch.cat([boxes[idx[:n]], top[:n, None]], 1).cpu().numpy()
    dets = vote(rows, float(test["NMS_THRESH"]))
    if len(dets) == 0:
        dets = np.array([[10, 10, 20, 20, 0.0001]], np.float32)
    return dets
