"""Anchor enumeration: the port's copy of ``smallhardface_tpu/ops/anchors.py``.

Numerically matches the Faster-R-CNN-style enumeration used by the reference
(lib/layers/generate_anchors.py:11-26): a (0,0,base-1,base-1)
window enumerated over aspect ratios, per-ratio scales, and an optional
sub-grid of shifts scaled by the per-scale stride. For the shipped configs
(base 16, ratios [1], scales [1,2,4], shifts [0]) this yields square anchors
of side 16/32/64 px centered at (7.5, 7.5).

These outputs are float64 numpy arrays computed once at setup time.
``prior_grid`` is RetinaFace's: built on the device, per level.
"""

from __future__ import annotations

import numpy as np
import torch


def _wh_to_anchor(ws, hs, x_ctr, y_ctr):
    ws = np.asarray(ws, dtype=np.float64)[:, None]
    hs = np.asarray(hs, dtype=np.float64)[:, None]
    return np.hstack((
        x_ctr - 0.5 * (ws - 1),
        y_ctr - 0.5 * (hs - 1),
        x_ctr + 0.5 * (ws - 1),
        y_ctr + 0.5 * (hs - 1),
    ))


def _anchor_wh_ctr(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def generate_anchors(base_size=16, ratios=(0.5, 1, 2),
                     scales=(8, 16, 32), shifts=(0,), strides=(0,)):
    """Enumerate anchors; rows ordered ratio-major, then scale, then shift."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    shifts = np.asarray(shifts, dtype=np.float64)
    strides = np.asarray(strides, dtype=np.float64)
    base = np.array([0, 0, base_size - 1, base_size - 1], dtype=np.float64)

    w, h, xc, yc = _anchor_wh_ctr(base)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _wh_to_anchor(ws, hs, xc, yc)

    rows = []
    for i in range(ratio_anchors.shape[0]):
        for scale, stride in zip(scales, strides):
            rw, rh, rxc, ryc = _anchor_wh_ctr(ratio_anchors[i])
            scaled = _wh_to_anchor([rw * scale], [rh * scale], rxc, ryc)
            sx, sy = np.meshgrid(shifts * stride, shifts * stride)
            grid = np.stack(
                [sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
            rows.append(scaled + grid)
    return np.vstack(rows)


def dense_anchors(height, width, feat_stride, anchors):
    """All anchors over an H×W grid, rows ordered (h, w, a) — the layout the
    reference builds in proposal/anchor layers
    (lib/layers/proposal_layer.py:103-121)."""
    shift_x = np.arange(width, dtype=np.float64) * feat_stride
    shift_y = np.arange(height, dtype=np.float64) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = anchors[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4)


def prior_grid(h, w, step, min_sizes, device=None):
    """RetinaFace's priors of an (h, w) map at stride ``step``
    (Pytorch_Retinaface ``layers/functions/prior_box.py`` in pixels, not
    normalised by the image size): (h, w, A, 4) float32 rows (cx, cy,
    side, side), centre ((j + 0.5)·step, (i + 0.5)·step), side each of
    ``min_sizes`` (A of them, in that order). Built on ``device`` with no
    copy from the host."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * step
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * step
    A = len(min_sizes)
    side = torch.stack([torch.full((), float(m), device=device)
                        for m in min_sizes]).expand(h, w, A)
    return torch.stack([xs[None, :, None].expand(h, w, A),
                        ys[:, None, None].expand(h, w, A), side, side],
                       dim=-1)
