"""Anchor targets + anchor-level OHEM + easy-image detection.

Counterpart of ``smallhardface_tpu/train/targets.py`` (``TargetConfig``,
``from_cfg``, ``anchor_targets`` at :87-211), the reference's
MultiLayerAnchorLayer (multi_layer_anchor_layer.py:88-338) as a function of
the current forward scores, on the device, with no host round trip:

  - dense anchors over the (possibly bucket-padded) stride-8 grid; positions
    beyond the ×16 grid of the actual image are excluded
  - inside-image test with allowed_border=0 (all of the valid grid when
    nothing is inside, :143-145)
  - max IoU and its argmax against the padded gt boxes through
    ``ops/iou.max_iou``: the CUDA kernel K3 on the card for every gt
    bucket, its plain version on the CPU (the JAX package took the Pallas
    kernel only for ≤ 512 gt on a TPU, an SMEM limit the card does not have)
  - label: fg ≥ ANCHOR_POSITIVE_OVERLAP, bg < ANCHOR_NEGATIVE_OVERLAP, else -1
  - OHEM: keep the hardest positives (lowest fg-confidence) and the hardest
    negatives (lowest bg-probability), fixed k; ties go to the lower anchor
    index first, as ``lax.top_k`` orders them (a stable ascending sort)
  - regression targets for every anchor with IoU ≥ ANCHOR_REGRESSION_OVERLAP,
    outside weights uniform 1/num
  - easy-image flag and the accuracy metric
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from smallhardface_tpu_torch.ops import bbox, iou
from smallhardface_tpu_torch.ops.decode import dense_anchor_grid


@dataclasses.dataclass(frozen=True)
class TargetConfig:
    """Static target-assignment parameters (from cfg)."""
    positive_overlap: float = 0.5
    negative_overlap: float = 0.3
    regression_overlap: float = 0.3
    anchors_per_batch: int = 256
    fg_fraction: float = 0.25
    positive_mining: bool = True
    hard_mining: bool = True            # 'ohem': True in the templates
    allowed_border: float = 0.0
    easy_enable: bool = False
    easy_threshold: float = 1.0
    accuracy_threshold: float = 0.9
    bbox_inside_weight: float = 1.0


def from_cfg(cfg) -> TargetConfig:
    return TargetConfig(
        positive_overlap=float(cfg.TRAIN.ANCHOR_POSITIVE_OVERLAP),
        negative_overlap=float(cfg.TRAIN.ANCHOR_NEGATIVE_OVERLAP),
        regression_overlap=float(cfg.TRAIN.ANCHOR_REGRESSION_OVERLAP),
        anchors_per_batch=int(cfg.TRAIN.ANCHOR_SAMPLING.ANCHORS_PER_BATCH),
        fg_fraction=float(cfg.TRAIN.ANCHOR_SAMPLING.ANCHOR_FG_FRACTION),
        positive_mining=bool(cfg.TRAIN.POSITIVE_MINING),
        easy_enable=bool(cfg.TRAIN.DISABLE_EASY_IMAGE.ENABLE),
        easy_threshold=float(cfg.TRAIN.DISABLE_EASY_IMAGE.THRESHOLD),
        accuracy_threshold=float(cfg.MISC.ACCURACY_THRESHOLD),
        bbox_inside_weight=float(cfg.TRAIN.BBOX_INSIDE_WEIGHTS[0]),
    )


def _bottom_k_mask(scores, k_static, n_select, selectable):
    """Boolean mask choosing the ``n_select`` (a tensor, ≤ k_static)
    smallest ``scores`` among ``selectable`` entries, lower index first
    among equal scores."""
    masked = torch.where(selectable, scores, float("inf"))
    vals, idx = torch.sort(masked, stable=True)
    vals, idx = vals[:k_static], idx[:k_static]
    rank = torch.arange(k_static, device=scores.device)
    rank_ok = (rank < n_select) & torch.isfinite(vals)
    mask = torch.zeros(scores.shape[0], dtype=torch.bool,
                       device=scores.device)
    return mask.index_put((idx,), rank_ok)


def anchor_targets(bg_prob, base_anchors, gt_boxes, gt_mask, *, im_h, im_w,
                   valid_h, valid_w, tc: TargetConfig, feat_stride=8,
                   wait=contextlib.nullcontext):
    """Per-anchor training targets for one image.

    bg_prob: (h, w, A) background probability of the current forward
             (softmaxed, detached by the caller)
    gt_boxes: (G, 5) padded [x1, y1, x2, y2, cls]; gt_mask: (G,) bool
    im_h/im_w: the actual image extent (floats)
    valid_h/valid_w: the ×16-grid extent over the stride (ints)
    wait(): the span around each call that waits for the device

    Returns a dict of flat (N,) / (N, 4) tensors over the (h, w, a) anchor
    order: labels (-1/0/cls), bbox_targets, inside/outside weights, and
    0-dim tensors: easy (bool), accuracy, n_fg, n_bg.
    """
    h, w, A = bg_prob.shape
    dev = bg_prob.device
    anchors = dense_anchor_grid(h, w, base_anchors, feat_stride,
                                device=dev, wait=wait).reshape(-1, 4)
    n = anchors.shape[0]
    scores = bg_prob.reshape(-1)

    gy = torch.arange(h, device=dev)[:, None, None].expand(h, w, A)
    gx = torch.arange(w, device=dev)[None, :, None].expand(h, w, A)
    grid_ok = ((gy < valid_h) & (gx < valid_w)).reshape(-1)

    border = tc.allowed_border
    inside = ((anchors[:, 0] >= -border) & (anchors[:, 1] >= -border) &
              (anchors[:, 2] < im_w + border) &
              (anchors[:, 3] < im_h + border))
    inside = inside & grid_ok
    inside = torch.where(inside.any(), inside, grid_ok)

    max_iou, argmax_gt = iou.max_iou(
        anchors.contiguous(), gt_boxes[:, :4].contiguous(),
        gt_mask.contiguous())
    argmax_gt = argmax_gt.long()
    gt_cls = torch.where(gt_mask, gt_boxes[:, 4], 0.0)

    labels = torch.full((n,), -1.0, device=dev)
    labels = torch.where(inside & (max_iou < tc.negative_overlap), 0.0,
                         labels)
    is_fg_cand = inside & (max_iou >= tc.positive_overlap)
    labels = torch.where(is_fg_cand, gt_cls[argmax_gt], labels)

    fg_conf = 1.0 - scores            # confidence of non-background
    easy = torch.where(is_fg_cand, fg_conf >= tc.easy_threshold, True).all()

    # ---- positive OHEM ----
    num_fg_target = (int(tc.fg_fraction * tc.anchors_per_batch)
                     if tc.fg_fraction >= 0 else n)
    n_fg_cand = is_fg_cand.sum()
    num_fg_target = min(num_fg_target, n)
    if tc.positive_mining and tc.hard_mining and num_fg_target < n:
        keep_fg = _bottom_k_mask(fg_conf, num_fg_target,
                                 n_fg_cand.clamp_max(num_fg_target),
                                 is_fg_cand)
        fg_final = torch.where(n_fg_cand > num_fg_target, keep_fg,
                               is_fg_cand)
    else:
        fg_final = is_fg_cand
    labels = torch.where(is_fg_cand & ~fg_final, -1.0, labels)

    # ---- negative OHEM ----
    n_fg = (labels > 0).sum()
    num_bg = tc.anchors_per_batch - n_fg          # fixed_num method
    is_bg = labels == 0
    n_bg_cand = is_bg.sum()
    if tc.hard_mining:
        keep_bg = _bottom_k_mask(scores, min(tc.anchors_per_batch, n),
                                 torch.minimum(num_bg, n_bg_cand), is_bg)
        bg_final = torch.where(n_bg_cand > num_bg, keep_bg, is_bg)
    else:
        bg_final = is_bg
    labels = torch.where(is_bg & ~bg_final, -1.0, labels)

    # ---- regression targets ----
    if tc.regression_overlap > 0:
        reg_mask = inside & (max_iou >= tc.regression_overlap)
    else:
        reg_mask = labels > 0
    matched_gt = gt_boxes[argmax_gt, :4]
    bbox_targets = bbox.bbox_transform(anchors, matched_gt)
    bbox_targets = torch.where(reg_mask[:, None], bbox_targets, 0.0)
    inside_w = torch.where(reg_mask[:, None], tc.bbox_inside_weight,
                           0.0).expand(n, 4)
    num_reg = reg_mask.sum()
    per_reg = torch.where(num_reg > 0, 1.0 / num_reg.clamp_min(1), 0.0)
    outside_w = torch.where(reg_mask[:, None], per_reg, 0.0).expand(n, 4)

    # ---- accuracy metric (:274-281) ----
    thr = tc.accuracy_threshold
    correct = (((labels > 0) & (scores < (1.0 - thr))).sum() +
               ((labels == 0) & (scores >= thr)).sum())
    n_sampled = (labels >= 0).sum()
    accuracy = torch.where(n_sampled > 0,
                           correct / n_sampled.clamp_min(1), 1.0)

    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "inside_weights": inside_w,
        "outside_weights": outside_w,
        "easy": easy,
        "accuracy": accuracy,
        "n_fg": n_fg,
        "n_bg": bg_final.sum(),
    }
