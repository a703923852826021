"""One training iteration of the flagship configuration in plain PyTorch:
the fused resize-and-crop preprocess, the forward in the ``"where"`` mask
mode (``reference/net.py``), anchor targets with OHEM, the softmax and
smooth-L1 losses, autograd's backward, the mean over micro-batches and the
SGD step with Caffe's learning-rate and decay multipliers.

Frozen from the port: ``train/train_loop.py`` :121-199 (the bucket
shapes of ``assemble_batch`` and ``preprocess_image``), :222-288 (the
loss of one micro-batch, ``grad_step``'s mean); ``train/targets.py``
:31-186 (``TargetConfig``, ``anchor_targets``); ``ops/bbox.py`` :50-99
(``bbox_transform``, ``iou_matrix``, ``max_iou_chunked``, the plain max
IoU); ``train/losses.py`` :19-44; ``train/solver.py`` :31-132 (the STEP
rate, SGD with momentum, weight decay folded into the gradient).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import arch
from portbench.reference.detect import anchor_grid, resize_weights
from portbench.reference.net import Net, numerics

BUCKET = 128


def snap(v, bucket):
    return int(math.ceil(max(v, 1) / bucket) * bucket)


def bucket_of(samples):
    """(h0b, w0b, hb, wb) of one iteration's samples (assemble_batch)."""
    hb = snap(snap(max(s["height"] for s in samples), 16), BUCKET)
    wb = snap(snap(max(s["width"] for s in samples), 16), BUCKET)
    h0b = snap(max(s["data"].shape[0] for s in samples), BUCKET)
    w0b = snap(max(s["data"].shape[1] for s in samples), BUCKET)
    return h0b, w0b, hb, wb


def preprocess(sample, h0b, w0b, hb, wb, mean, device):
    """The sample's original, edge-padded to (h0b, w0b), resized by its
    scale and cropped at its offset in one linear resample, mean
    subtracted, zero beyond its final extent: (hb, wb, 3)."""
    d = sample["data"]
    h0, w0 = d.shape[:2]
    pad = np.pad(d, ((0, h0b - h0), (0, w0b - w0), (0, 0)), mode="edge")
    img = torch.from_numpy(np.ascontiguousarray(pad)).to(device).float()
    s, (cy, cx) = float(sample["im_scale"]), sample["crop"]
    wy = resize_weights(h0b, hb, s, device, translation=-float(cy))
    wx = resize_weights(w0b, wb, s, device, translation=-float(cx))
    t = (wy.t() @ img.reshape(h0b, w0b * 3)).reshape(hb, w0b, 3)
    res = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1)
    inside = ((torch.arange(hb, device=device) < sample["height"])[:, None]
              & (torch.arange(wb, device=device) < sample["width"])[None])
    return torch.where(inside[..., None], res - mean, 0.0)


def _iou_matrix(boxes, query):
    b_area = ((boxes[:, 2] - boxes[:, 0] + 1)
              * (boxes[:, 3] - boxes[:, 1] + 1))[:, None]
    q_area = ((query[:, 2] - query[:, 0] + 1)
              * (query[:, 3] - query[:, 1] + 1))[None, :]
    iw = (torch.minimum(boxes[:, 2][:, None], query[None, :, 2])
          - torch.maximum(boxes[:, 0][:, None], query[None, :, 0]) + 1)
    ih = (torch.minimum(boxes[:, 3][:, None], query[None, :, 3])
          - torch.maximum(boxes[:, 1][:, None], query[None, :, 1]) + 1)
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    union = b_area + q_area - inter
    return torch.where(union > 0, inter / union, 0.0)


def max_iou(anchors, gt, mask):
    iou = torch.where(mask[None, :], _iou_matrix(anchors, gt), -1.0)
    best, arg = iou.max(dim=1)
    return best.clamp_min(0.0), arg


def _encode(ex, gt):
    ew, eh = ex[:, 2] - ex[:, 0] + 1.0, ex[:, 3] - ex[:, 1] + 1.0
    ecx, ecy = ex[:, 0] + 0.5 * ew, ex[:, 1] + 0.5 * eh
    gw, gh = gt[:, 2] - gt[:, 0] + 1.0, gt[:, 3] - gt[:, 1] + 1.0
    gcx, gcy = gt[:, 0] + 0.5 * gw, gt[:, 1] + 0.5 * gh
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], dim=1)


def _bottom_k(scores, k, n_select, selectable):
    masked = torch.where(selectable, scores, float("inf"))
    vals, idx = torch.sort(masked, stable=True)
    vals, idx = vals[:k], idx[:k]
    ok = (torch.arange(k, device=scores.device) < n_select) & \
        torch.isfinite(vals)
    return torch.zeros(scores.shape[0], dtype=torch.bool,
                       device=scores.device).index_put((idx,), ok)


def targets(bg_prob, gt, mask, im_h, im_w, valid_h, valid_w, tc):
    """Labels (-1 ignore, 0, 1) with OHEM and the regression targets and
    weights of one image, as the port's ``anchor_targets``."""
    h, w, A = bg_prob.shape
    dev = bg_prob.device
    anchors = anchor_grid(h, w, dev).reshape(-1, 4)
    n = anchors.shape[0]
    scores = bg_prob.reshape(-1)
    gy = torch.arange(h, device=dev)[:, None, None].expand(h, w, A)
    gx = torch.arange(w, device=dev)[None, :, None].expand(h, w, A)
    grid_ok = ((gy < valid_h) & (gx < valid_w)).reshape(-1)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_w) & (anchors[:, 3] < im_h)) & grid_ok
    inside = torch.where(inside.any(), inside, grid_ok)
    best, arg = max_iou(anchors, gt[:, :4], mask)
    cls = torch.where(mask, gt[:, 4], 0.0)
    labels = torch.full((n,), -1.0, device=dev)
    labels = torch.where(inside & (best < tc["neg"]), 0.0, labels)
    fg_cand = inside & (best >= tc["pos"])
    labels = torch.where(fg_cand, cls[arg], labels)
    fg_conf = 1.0 - scores
    k_fg = min(int(tc["fg_fraction"] * tc["per_batch"]), n)
    n_fg_cand = fg_cand.sum()
    if k_fg < n:
        keep = _bottom_k(fg_conf, k_fg, n_fg_cand.clamp_max(k_fg), fg_cand)
        fg_final = torch.where(n_fg_cand > k_fg, keep, fg_cand)
    else:
        fg_final = fg_cand
    labels = torch.where(fg_cand & ~fg_final, -1.0, labels)
    n_bg = tc["per_batch"] - (labels > 0).sum()
    is_bg = labels == 0
    n_bg_cand = is_bg.sum()
    keep = _bottom_k(scores, min(tc["per_batch"], n),
                     torch.minimum(n_bg, n_bg_cand), is_bg)
    labels = torch.where(is_bg & ~torch.where(n_bg_cand > n_bg, keep, is_bg),
                         -1.0, labels)
    reg = inside & (best >= tc["reg"])
    tgt = torch.where(reg[:, None], _encode(anchors, gt[arg, :4]), 0.0)
    in_w = torch.where(reg[:, None], tc["inside_w"], 0.0).expand(n, 4)
    n_reg = reg.sum()
    per = torch.where(n_reg > 0, 1.0 / n_reg.clamp_min(1), 0.0)
    out_w = torch.where(reg[:, None], per, 0.0).expand(n, 4)
    return labels, tgt, in_w, out_w


def losses(logits, deltas, labels, tgt, in_w, out_w, sigma=3.0):
    valid = labels >= 0
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(1, torch.where(valid, labels, 0.0).long()[:, None])
    cnt = valid.sum()
    cls = torch.where(cnt > 0, -torch.where(valid, picked[:, 0], 0.0).sum()
                      / cnt.clamp_min(1), 0.0)
    s2 = sigma * sigma
    diff = in_w * (deltas - tgt)
    ad = diff.abs()
    f = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    return cls, (out_w * f).sum()


def target_config(cfg):
    t = cfg["TRAIN"]
    return {"pos": float(t["ANCHOR_POSITIVE_OVERLAP"]),
            "neg": float(t["ANCHOR_NEGATIVE_OVERLAP"]),
            "reg": float(t["ANCHOR_REGRESSION_OVERLAP"]),
            "per_batch": int(t["ANCHOR_SAMPLING"]["ANCHORS_PER_BATCH"]),
            "fg_fraction": float(t["ANCHOR_SAMPLING"]["ANCHOR_FG_FRACTION"]),
            "inside_w": float(t["BBOX_INSIDE_WEIGHTS"][0])}


def learning_rate(it, cfg):
    t = cfg["TRAIN"]
    return float(t["LR"]["BASELR"]) * float(t.get("GAMMA", 0.1)) ** (
        it // int(t["STEPSIZE"]))


class Trainer:
    """The reference's training state: its own copies of ``params`` (the
    trainable leaves require a gradient) and SGD's momentum slots."""

    def __init__(self, params, cfg, device, mode="fp32", stages=arch.VGG16):
        if cfg["TRAIN"]["LR_POLICY"] != "STEP" or \
                cfg["TRAIN"]["SOLVER_TYPE"] != "SGD":
            raise ValueError("the reference follows the STEP policy and SGD")
        self.cfg, self.device, self.stages = cfg, device, stages
        self.lr, self.decay = arch.multipliers(stages)
        self.p = {n: {k: t.detach().clone().requires_grad_(
            self.lr[n][k] > 0) for k, t in leaf.items()}
            for n, leaf in params.items()}
        self.h1 = {(n, k): torch.zeros_like(t) for n, leaf in self.p.items()
                   for k, t in leaf.items() if self.lr[n][k] > 0}
        self.net = Net(self.p, mode, stages)
        self.tc = target_config(cfg)
        self.mean = torch.tensor(np.asarray(cfg["PIXEL_MEANS"], np.float32)
                                 .reshape(3), device=device)

    def leaves(self):
        return {f"{n}/{k}": self.p[n][k] for n, k in self.h1}

    def step(self, samples, it):
        """One iteration over ``samples`` (its micro-batches). Returns the
        losses [(cls, reg)] and the gradients as the solver takes them
        ({leaf: grad + decay})."""
        h0b, w0b, hb, wb = bucket_of(samples)
        for t in self.leaves().values():
            t.grad = None
        out = []
        for s in samples:
            x = preprocess(s, h0b, w0b, hb, wb, self.mean, self.device)
            vh, vw = snap(s["height"], 16), snap(s["width"], 16)
            logits, deltas = self.net(x[None], valid=(vh, vw))
            logits, deltas = logits[0], deltas[0]
            bg = torch.softmax(logits.detach(), dim=-1)[..., 0]
            gt = torch.as_tensor(s["gt_boxes"], device=self.device)
            mask = torch.ones(gt.shape[0], dtype=torch.bool,
                              device=self.device)
            lab, tgt, iw, ow = targets(bg, gt, mask, float(s["height"]),
                                       float(s["width"]), vh // 8, vw // 8,
                                       self.tc)
            cls, reg = losses(logits.reshape(-1, 2), deltas.reshape(-1, 4),
                              lab, tgt, iw, ow)
            with numerics(self.net.mode):
                (cls + reg).backward()
            out.append((float(cls.detach()), float(reg.detach())))
        rate = learning_rate(it, self.cfg)
        wd = float(self.cfg["TRAIN"]["WEIGHT_DECAY"])
        mom = float(self.cfg["TRAIN"]["MOMENTUM"])
        grads = {}
        with torch.no_grad():
            for (n, k), h in self.h1.items():
                w = self.p[n][k]
                g = w.grad / len(samples) + wd * self.decay[n][k] * w
                grads[f"{n}/{k}"] = g.clone()
                h.mul_(mom).add_(rate * self.lr[n][k] * g)
                w.sub_(h)
        return out, grads
