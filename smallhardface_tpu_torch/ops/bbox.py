"""Box geometry on tensors.

Counterpart of ``smallhardface_tpu/ops/bbox_jax.py:17-65``
(``bbox_transform_inv`` with its dw/dh clamp, ``clip_boxes``), with the
+1 pixel width convention and no +1 on x2/y2 at decode.
"""

from __future__ import annotations

import torch


def bbox_transform_inv(boxes, deltas):
    """Decode deltas (..., 4) against boxes (..., 4); dw/dh > 50 clamp to 5
    (the reference's overflow recovery, bbox_jax.py:26-27)."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx, dy = deltas[..., 0], deltas[..., 1]
    five = torch.full((), 5.0, dtype=deltas.dtype, device=deltas.device)
    dw = torch.where(deltas[..., 2] > 50, five, deltas[..., 2])
    dh = torch.where(deltas[..., 3] > 50, five, deltas[..., 3])

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([
        pred_ctr_x - 0.5 * pred_w,
        pred_ctr_y - 0.5 * pred_h,
        pred_ctr_x + 0.5 * pred_w,
        pred_ctr_y + 0.5 * pred_h,
    ], dim=-1)


def clip_boxes(boxes, im_h, im_w):
    """Clip (..., 4) boxes into [0, W-1] × [0, H-1]."""
    x1 = boxes[..., 0].clamp(0, im_w - 1)
    y1 = boxes[..., 1].clamp(0, im_h - 1)
    x2 = boxes[..., 2].clamp(0, im_w - 1)
    y2 = boxes[..., 3].clamp(0, im_h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)
