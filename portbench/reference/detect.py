"""One image's detections under the WIDER protocol, in plain PyTorch and
NumPy: the pyramid levels, the device-style resize, flip, the forward
(``reference/net.py``), softmax, decode, the cross-level merge, the
strict ``> thresh`` cut, the top ``VOTE_CAP`` rows and the score-weighted
box vote.

Frozen from the port: ``detect.py`` :102-173 (``compute_scaling_factor``,
``_pyramid_scales``, ``level_sizes``, ``linear_resize_weights``),
:269-442 (``_prep``'s float32 resize factors, ``_level_batch``,
``_decode_level``), :702-715 (``top_rows``) and :562-565 (the dummy row);
``ops/decode.py`` :17-102 and ``ops/bbox.py`` :16-47 (decode and clip);
``ops/nms_device.py`` :71-119 (the vote's semantics: the head is the
lowest remaining row, its cluster the rows with IoU >= thresh, a cluster
of two or more gives the score-weighted mean box and its best score, a
single row only when nothing remains after it), here a NumPy loop in
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import arch


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


def scaling_factor(shape, target, max_size):
    lo, hi = float(min(shape[:2])), float(max(shape[:2]))
    s = float(target) / lo
    if np.round(s * hi) > max_size:
        s = float(max_size) / hi
    return s


def pyramid_scales(shape, test):
    """Each level's resize factor: relative to the PYRAMID_BASE_SIZE fit
    (several scales) or the short-side rule (one)."""
    scales = list(test["SCALES"])
    if len(scales) == 1:
        return [scaling_factor(shape, scales[0], test["MAX_SIZE"])]
    base = scaling_factor(shape, *test["PYRAMID_BASE_SIZE"])
    return [float(s) / test["PYRAMID_BASE_SIZE"][0] * base for s in scales]


def levels(shape, test, m=16):
    """(scale, inv_fx, h_s, w_s, hb, wb) per level, the scale as float32
    1 / float32(1 / scale), the network input the extent rounded up to
    ×m."""
    h0, w0 = shape[:2]
    out = []
    for s in pyramid_scales(shape, test):
        h_s, w_s = int(round(h0 * s)), int(round(w0 * s))
        inv = float(np.float32(1.0 / s))
        out.append((float(np.float32(1.0) / np.float32(inv)), inv, h_s, w_s,
                    _round_up(max(h_s, 1), m), _round_up(max(w_s, 1), m)))
    return out


def resize_weights(n_in, n_out, scale, device, translation=0.0):
    """(n_in, n_out) float32 weights of a linear resize by ``scale`` (the
    triangle kernel at (o + 0.5) / scale - translation / scale - 0.5,
    columns normalised, zero outside [-0.5, n_in - 0.5])."""
    inv = (1.0 / torch.tensor(scale, dtype=torch.float32)).to(device)
    shift = torch.tensor(translation, dtype=torch.float32).to(device)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv - shift * inv - 0.5)
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (sample[None, :] - pos[:, None]).abs()).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def anchors_base():
    """The three square anchors of side 16, 32, 64 centred at (7.5, 7.5)."""
    return np.array([[7.5 - (16 * s - 1) / 2, 7.5 - (16 * s - 1) / 2,
                      7.5 + (16 * s - 1) / 2, 7.5 + (16 * s - 1) / 2]
                     for s in arch.ANCHOR_SCALES], np.float64)


def anchor_grid(h, w, device):
    a = torch.as_tensor(anchors_base().astype(np.float32), device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device) * arch.FEAT_STRIDE
    xs = torch.arange(w, dtype=torch.float32, device=device) * arch.FEAT_STRIDE
    A = a.shape[0]
    shift = torch.stack([xs[None, :, None].expand(h, w, A),
                         ys[:, None, None].expand(h, w, A),
                         xs[None, :, None].expand(h, w, A),
                         ys[:, None, None].expand(h, w, A)], dim=-1)
    return a[None, None] + shift


def decode_boxes(anchors, deltas):
    """Deltas against anchors, the +1 convention, dw/dh above 50 set to 5."""
    wd = anchors[..., 2] - anchors[..., 0] + 1.0
    ht = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * wd
    cy = anchors[..., 1] + 0.5 * ht
    five = torch.full((), 5.0, device=deltas.device)
    dw = torch.where(deltas[..., 2] > 50, five, deltas[..., 2])
    dh = torch.where(deltas[..., 3] > 50, five, deltas[..., 3])
    px, py = deltas[..., 0] * wd + cx, deltas[..., 1] * ht + cy
    pw, ph = torch.exp(dw) * wd, torch.exp(dh) * ht
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph,
                        px + 0.5 * pw, py + 0.5 * ph], dim=-1)


def vote(dets, thresh):
    """The greedy score-weighted vote over rows (n, 5) sorted by score,
    float32."""
    dets = np.asarray(dets, np.float32)
    n = dets.shape[0]
    x1, y1, x2, y2, sc = (dets[:, i] for i in range(5))
    area = (x2 - x1 + np.float32(1)) * (y2 - y1 + np.float32(1))
    remaining = np.ones(n, bool)
    t = np.float32(thresh)
    out = []
    while remaining.any():
        i = int(np.argmax(remaining))
        w = np.maximum(np.minimum(x2[i], x2) - np.maximum(x1[i], x1)
                       + np.float32(1), np.float32(0))
        h = np.maximum(np.minimum(y2[i], y2) - np.maximum(y1[i], y1)
                       + np.float32(1), np.float32(0))
        inter = w * h
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / (area[i] + area - inter)
        cluster = remaining & (iou >= t)
        cluster[i] = True
        remaining &= ~cluster
        if cluster.sum() > 1:
            cw = sc[cluster]
            box = (dets[cluster, :4] * cw[:, None]).sum(0) / cw.sum()
            out.append(np.append(box, sc[cluster].max()))
        elif not remaining.any():
            out.append(dets[i])
    return np.asarray(out, np.float32).reshape(-1, 5)


def detect(net, im, cfg, device, thresh=0.05):
    """(N, 5) float32 detections of one BGR uint8 image ``im`` by ``net``
    under the configuration ``cfg`` (the TOML as a dict), cut at scores
    above ``thresh``."""
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
    with torch.no_grad():
        for scale, inv, h_s, w_s, hb, wb in levels(im.shape, test):
            wy = resize_weights(H0, hb, scale, device)
            wx = resize_weights(W0, wb, scale, device)
            t = (wy.t() @ img.reshape(H0, W0 * 3)).reshape(hb, W0, 3)
            res = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1) - mean
            inside = ((torch.arange(hb, device=device) < h_s)[:, None]
                      & (torch.arange(wb, device=device) < w_s)[None, :])
            res = torch.where(inside[..., None], res, 0.0)
            idx = (w_s - 1 - torch.arange(wb, device=device)).clamp(0, wb - 1)
            mir = torch.where(inside[..., None], res[:, idx], 0.0)
            x = torch.stack([res, mir]).contiguous()
            logits, deltas = net(x)
            prob = torch.softmax(logits, dim=-1)[..., 1]
            h, w, A = prob.shape[1:]
            boxes = decode_boxes(anchor_grid(h, w, device), deltas)
            lo = torch.zeros((), device=device)
            boxes = torch.stack([boxes[..., 0].clamp(lo, w_s - 1.0),
                                 boxes[..., 1].clamp(lo, h_s - 1.0),
                                 boxes[..., 2].clamp(lo, w_s - 1.0),
                                 boxes[..., 3].clamp(lo, h_s - 1.0)], -1)
            flat = prob.flatten(1)
            cap = min(cap_det, h * w * A)
            n_keep = (flat >= st).sum(1).clamp(1, cap)
            s, order = torch.sort(flat, dim=1, descending=True, stable=True)
            s, order = s[:, :cap], order[:, :cap]
            b = torch.gather(boxes.flatten(1, 3), 1,
                             order[..., None].expand(-1, -1, 4))
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
        sortable = torch.where(keep, scores, -torch.inf)
        k = min(int(cfg["TPU"]["VOTE_CAP"]), sortable.shape[0])
        top, idx = torch.sort(sortable, descending=True, stable=True)
        n = int(min(int(keep.sum()), k))
        rows = torch.cat([boxes[idx[:n]], top[:n, None]], 1).cpu().numpy()
    dets = vote(rows, float(test["NMS_THRESH"]))
    if len(dets) == 0:
        dets = np.array([[10, 10, 20, 20, 0.0001]], np.float32)
    return dets


def calibration_inputs(ims, cfg):
    """Each calibration image resized on the host (cv2 INTER_LINEAR in
    uint8) at every pyramid scale, mean-subtracted, zero-padded to ×16:
    (1, H, W, 3) float32 arrays."""
    import cv2
    mean = np.asarray(cfg["PIXEL_MEANS"], np.float32).reshape(3)
    xs = []
    for im in ims:
        for s in pyramid_scales(im.shape, cfg["TEST"]):
            r = cv2.resize(im, None, fx=s, fy=s,
                           interpolation=cv2.INTER_LINEAR)
            h, w = r.shape[:2]
            x = np.zeros((1, _round_up(h, 16), _round_up(w, 16), 3),
                         np.float32)
            x[0, :h, :w] = r.astype(np.float32) - mean
            xs.append(x)
    return xs
