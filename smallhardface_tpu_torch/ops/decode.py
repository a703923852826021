"""Proposal decode on the device: anchors + deltas → clipped, thresholded,
capacity-capped detections with shapes known on the host.

Counterpart of ``smallhardface_tpu/ops/decode.py``: ``dense_anchor_grid``
(:32-43), ``_decode_fields`` (:75-111) and ``decode_proposals_batch``
(:114-179) without the ``fast_k`` path (it never changed the output).

Tie order: ``lax.top_k`` puts the lower index first among equal scores.
``torch.topk`` promises no order, so the selection is a stable descending
``torch.sort`` cut to the capacity, which keeps that order.
"""

from __future__ import annotations

import numpy as np
import torch

from smallhardface_tpu_torch.ops import bbox


def dense_anchor_grid(h, w, base_anchors, feat_stride, device=None):
    """(h, w, A, 4) float32 anchor grid: base anchors shifted by
    (x, y, x, y) = feat_stride · (col, row, col, row)."""
    a = torch.as_tensor(np.asarray(base_anchors, np.float32), device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device) * feat_stride
    xs = torch.arange(w, dtype=torch.float32, device=device) * feat_stride
    A = a.shape[0]
    shift = torch.stack([
        xs[None, :, None].expand(h, w, A),
        ys[:, None, None].expand(h, w, A),
        xs[None, :, None].expand(h, w, A),
        ys[:, None, None].expand(h, w, A),
    ], dim=-1)
    return a[None, None] + shift


def _per_image(v, device, dtype):
    """A (B,) tensor of per-image values as (B, 1, 1, 1), to broadcast over
    (B, h, w, A); a number as it is."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.to(device=device, dtype=dtype)[:, None, None, None]
    return v


def _decode_fields(fg_scores, bbox_deltas, base_anchors, *, feat_stride,
                   im_h, im_w, valid_h, valid_w, score_thresh, min_size,
                   capacity):
    """Elementwise half of the decode for a batch: decoded and clipped
    boxes (B, hwA, 4), the keepability-masked scores (B, hwA), the keep
    count (B,) (entries >= score_thresh, clamped to [1, capacity]: at least
    one box survives, proposal_layer.py:183-185), and the capacity."""
    _, h, w, A = fg_scores.shape
    dev = fg_scores.device
    anchors = dense_anchor_grid(h, w, base_anchors, feat_stride, device=dev)
    decoded = bbox.bbox_transform_inv(anchors, bbox_deltas)
    if isinstance(im_h, torch.Tensor) and im_h.dim() == 1:
        # per image: x into [0, im_w - 1], y into [0, im_h - 1], as
        # clip_boxes does for one extent (jnp.clip under vmap)
        lo = torch.zeros((), dtype=decoded.dtype, device=dev)
        hi_x = _per_image(im_w, dev, decoded.dtype) - 1
        hi_y = _per_image(im_h, dev, decoded.dtype) - 1
        boxes = torch.stack([
            torch.clamp(decoded[..., 0], lo, hi_x),
            torch.clamp(decoded[..., 1], lo, hi_y),
            torch.clamp(decoded[..., 2], lo, hi_x),
            torch.clamp(decoded[..., 3], lo, hi_y)], dim=-1)
    else:
        boxes = bbox.clip_boxes(decoded, im_h, im_w)
    gy = torch.arange(h, device=dev)[:, None, None]
    gx = torch.arange(w, device=dev)[None, :, None]
    grid_ok = ((gy < _per_image(valid_h, dev, torch.int64))
               & (gx < _per_image(valid_w, dev, torch.int64)))
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    keepable = grid_ok & (ws >= min_size) & (hs >= min_size)
    capacity = min(int(capacity), h * w * A)
    neg_inf = torch.full((), -float("inf"), dtype=fg_scores.dtype,
                         device=fg_scores.device)
    sortable = torch.where(keepable, fg_scores, neg_inf).flatten(1)
    n_above = (sortable >= score_thresh).sum(dim=1)
    n_keep = n_above.clamp(1, capacity).to(torch.int32)
    return boxes.flatten(1, 3), sortable, n_keep, capacity


def decode_proposals_batch(fg_scores, bbox_deltas, base_anchors, *,
                           feat_stride, im_h, im_w, valid_h, valid_w,
                           score_thresh, min_size, capacity):
    """fg_scores (B, h, w, A) foreground probabilities, bbox_deltas
    (B, h, w, A, 4); im_h/im_w the unpadded image extent for clipping,
    valid_h/valid_w the valid grid extent: Python numbers, or (B,) tensors
    giving each image its own (the JAX function under ``vmap``).
    Returns (boxes (B, cap, 4), scores (B, cap), n_keep (B,) int32) with
    cap = min(capacity, h·w·A), rows in descending score order, lower
    index first among ties. Rows at and beyond n_keep are to be ignored."""
    boxes, sortable, n_keep, cap = _decode_fields(
        fg_scores, bbox_deltas, base_anchors, feat_stride=feat_stride,
        im_h=im_h, im_w=im_w, valid_h=valid_h, valid_w=valid_w,
        score_thresh=score_thresh, min_size=min_size, capacity=capacity)
    scores, idx = torch.sort(sortable, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :cap], idx[:, :cap]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return top_boxes, scores, n_keep
