"""Per-image detection: multi-scale pyramid + flip TTA + merge + vote.

Counterpart of ``smallhardface_tpu/detect.py``: ``compute_scaling_factor``
and ``_pyramid_scales`` (:38-73), and ``TPUDetector``'s device path
(``_build_run``, :159-351) as ``TorchDetector``:

- the raw uint8 image, edge-padded to ×16, is uploaded once;
- every pyramid level is derived on the device: a linear resize with the
  weight matrices ``jax.image.scale_and_translate(method="linear",
  antialias=False)`` builds, mean subtraction, zeros beyond the level's
  extent, and the mirrored copy for flip TTA;
- each level runs at its exact ×16 shape (the JAX ``"exact"`` mask mode),
  image and mirror as a batch of 2, then softmax and decode;
- levels merge in original-image coordinates, the strict ``> thresh`` cut
  applies, and only the kept rows are copied to the host;
- the final BBOX_VOTE / NMS runs on the host in float64 through the shared
  ``smallhardface_tpu.ops.native`` (the JAX package's DEVICE_VOTE=false
  path).

Only ``TPU.PRECISION = "float32"`` is ported. ``TPU.HOST_PREPROC``,
``detect_many``, int8 calibration and spatial meshes wait (ROADMAP).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from smallhardface_tpu.config import cfg
from smallhardface_tpu.ops import anchors as anchors_mod
from smallhardface_tpu.ops import native as nms_host
from smallhardface_tpu.utils.timer import Timer
from smallhardface_tpu_torch.models import detector as detector_mod
from smallhardface_tpu_torch.ops import decode as decode_mod

logger = logging.getLogger(__name__)

# TPU knobs of the shared config that the port reads and ignores, each
# with why (ROADMAP "Not carried over"); TorchDetector logs them.
IGNORED_TPU_KNOBS = {
    "MASK_MODE": "every level runs at its exact x16 shape, the JAX 'exact' "
                 "mode, so there is no bucket padding to mask",
    "TEST_BUCKET": "buckets bounded the number of compiled XLA programs; "
                   "eager PyTorch compiles nothing per shape",
    "S2D_STEM": "a TPU matrix-unit layout trick for conv1_1; the stem is "
                "one fused CUDA kernel",
    "PALLAS_STEM": "the stem always runs through ops/stem.fused_stem: the "
                   "kernel on a CUDA tensor, its plain version on the CPU",
    "LEVEL_SERIAL": "XLA scheduling barriers; eager execution already "
                    "runs the levels in order",
    "FLIP_SPLIT_PX": "a TPU batch-2 efficiency workaround; it never "
                     "changed the output",
    "DECODE_FAST_K": "a faster TPU top-k with identical output; the port "
                     "sorts once per level",
    "SPATIAL_DEVICES": "spatial sharding is not ported yet",
    "EVAL_BATCH": "batched evaluation (detect_many) is not ported yet",
    "DEVICE_VOTE": "the final vote runs on the host in float64 (the JAX "
                   "DEVICE_VOTE=false path); the device vote is not "
                   "ported yet",
    "VOTE_CAP": "it bounds only the device vote, which is not ported",
}


def compute_scaling_factor(im_shape, target_size, max_size):
    """Short side → target_size, long side capped at max_size."""
    if cfg.TEST.ORIG_SIZE:
        return 1.0
    im_size_min = float(np.min(im_shape[0:2]))
    im_size_max = float(np.max(im_shape[0:2]))
    im_scale = float(target_size) / im_size_min
    if np.round(im_scale * im_size_max) > max_size:
        im_scale = float(max_size) / im_size_max
    return im_scale


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


def _pyramid_scales(im_shape):
    """Per-level resize factors under the configured TEST.SCALES
    (single-scale: short-side rule; multi-scale: relative to the
    PYRAMID_BASE_SIZE fit)."""
    scales = list(cfg.TEST.SCALES)
    if len(scales) == 1:
        return [compute_scaling_factor(im_shape, scales[0],
                                       cfg.TEST.MAX_SIZE)]
    base_scale = compute_scaling_factor(
        im_shape, cfg.TEST.PYRAMID_BASE_SIZE[0],
        cfg.TEST.PYRAMID_BASE_SIZE[1])
    return [float(s) / cfg.TEST.PYRAMID_BASE_SIZE[0] * base_scale
            for s in scales]


def linear_resize_weights(in_size, out_size, scale, device=None):
    """(in_size, out_size) float32 weights of a linear resize by ``scale``,
    built as ``jax._src.image.scale.compute_weight_mat`` builds them for
    ``method="linear", antialias=False``: output o samples the input at
    (o + 0.5) / scale - 0.5 with a triangle kernel, each column is
    normalised to sum 1, and a sample outside [-0.5, in_size - 0.5] gets
    zero weight. That is cv2's INTER_LINEAR convention with an explicit fx
    (tests/test_device_preproc.py)."""
    inv_scale = 1.0 / torch.tensor(scale, dtype=torch.float32)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale.to(device) - 0.5)
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    weights = (1.0 - (sample[None, :] - pos[:, None]).abs()).clamp_min(0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0),
                          0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _imread(path):
    import cv2      # host-side image decoding only; not on the GPU path
    im = cv2.imread(path)
    if im is None:
        raise FileNotFoundError(f"could not read image {path!r}")
    return im


class TorchDetector:
    """Full-pyramid detector on one device.

    params: {name: {'w': OIHW, 'b'}} tensors (``models.detector
    .init_params`` or ``io.weights``); spec: ``ModelSpec`` (from the config
    when None); device: where the network runs (``torch.device``).
    """

    def __init__(self, params, spec=None, device="cpu"):
        precision = str(cfg.TPU.PRECISION)
        if precision != "float32":
            raise NotImplementedError(
                f"TPU.PRECISION={precision!r}: the PyTorch port runs "
                "float32 only; bfloat16 and int8 are on ROADMAP queue 1")
        if cfg.TPU.HOST_PREPROC:
            raise NotImplementedError(
                "TPU.HOST_PREPROC is not ported yet (ROADMAP queue 1, "
                "'HOST_PREPROC'); the port preprocesses on the device")
        if int(cfg.TPU.MERGED_DET_CAP) > 0:
            raise NotImplementedError(
                "TPU.MERGED_DET_CAP > 0 is not ported yet; the port keeps "
                "every detection above the threshold (the reference "
                "semantics, MERGED_DET_CAP = -1)")
        for knob, why in IGNORED_TPU_KNOBS.items():
            logger.debug("TPU.%s=%r ignored: %s", knob, cfg.TPU[knob], why)
        self.device = torch.device(device)
        self.spec = spec or detector_mod.build_spec(cfg)
        self.model = detector_mod.Detector(params, self.spec, self.device)
        self.base_anchors = anchors_mod.generate_anchors(
            base_size=16, ratios=[1],
            scales=list(detector_mod.ANCHOR_SCALES),
            shifts=[0],
            strides=[detector_mod.FEAT_STRIDE] * 3)
        cap = int(cfg.TPU.DET_CAPACITY)
        self.capacity = cap if cap > 0 else int(cfg.TEST.N_DETS_PER_MODULE)
        self.mean = torch.tensor(np.asarray(cfg.PIXEL_MEANS, np.float32)
                                 .reshape(3), device=self.device)

    def _prep(self, im):
        """The edge-padded raw image and the per-level metadata, all host
        Python numbers: resize factor, its float32 inverse, the resized
        extent (h_s, w_s) and the ×16 level shape (hb, wb)."""
        if isinstance(im, str):
            im = _imread(im)
        h0, w0 = im.shape[:2]
        H0b = _round_up(h0, cfg.MAX_RESOLUTION)
        W0b = _round_up(w0, cfg.MAX_RESOLUTION)
        padded = np.pad(im, ((0, H0b - h0), (0, W0b - w0), (0, 0)),
                        mode="edge")
        levels = []
        for scale in _pyramid_scales(im.shape):
            h_s = int(round(h0 * scale))
            w_s = int(round(w0 * scale))
            inv_fx = float(np.float32(1.0 / scale))
            levels.append({
                # the JAX program receives inv_fx as float32 and resizes by
                # its float32 reciprocal
                "scale": float(np.float32(1.0) / np.float32(inv_fx)),
                "inv_fx": inv_fx,
                "h_s": h_s, "w_s": w_s,
                "hb": _round_up(max(h_s, 1), cfg.MAX_RESOLUTION),
                "wb": _round_up(max(w_s, 1), cfg.MAX_RESOLUTION)})
        return {"padded": np.ascontiguousarray(padded), "levels": levels}

    def _level_input(self, img, lv):
        """(B, hb, wb, 3) network input of one level from the float image
        (H0b, W0b, 3): B = 2 (image, mirror) under TEST.FLIP, else 1."""
        H0b, W0b, _ = img.shape
        hb, wb, h_s, w_s = lv["hb"], lv["wb"], lv["h_s"], lv["w_s"]
        wy = linear_resize_weights(H0b, hb, lv["scale"], self.device)
        wx = linear_resize_weights(W0b, wb, lv["scale"], self.device)
        t = (wy.T @ img.reshape(H0b, W0b * 3)).reshape(hb, W0b, 3)
        resized = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1) - self.mean
        rows = torch.arange(hb, device=self.device) < h_s
        cols = torch.arange(wb, device=self.device) < w_s
        valid = (rows[:, None] & cols[None, :])[..., None]
        resized = torch.where(valid, resized, 0.0)
        ims = [resized]
        if cfg.TEST.FLIP:
            # mirror about the level's own width w_s, not the padded wb
            idx = (w_s - 1 - torch.arange(wb, device=self.device)).clamp(
                0, wb - 1)
            ims.append(torch.where(valid, resized[:, idx], 0.0))
        return torch.stack(ims, dim=0).contiguous()

    def detect_async(self, im, thresh=0.05, score_thresh=None):
        """Upload one image and enqueue its whole pyramid on the device.
        ``thresh`` is the detect-level cut (probs > thresh). Returns a
        handle for ``finalize_async``; nothing waits for the device here."""
        p = self._prep(im)
        st = float(score_thresh if score_thresh is not None
                   else cfg.TEST.SCORE_THRESH)
        all_boxes, all_scores = [], []
        with torch.inference_mode():
            img = torch.from_numpy(p["padded"]).to(self.device).float()
            for lv in p["levels"]:
                x = self._level_input(img, lv)
                out = self.model(x)
                probs = torch.softmax(out["cls_logits"], dim=-1)[..., 1]
                boxes, scores, counts = decode_mod.decode_proposals_batch(
                    probs, out["bbox_deltas"], self.base_anchors,
                    feat_stride=detector_mod.FEAT_STRIDE,
                    im_h=float(lv["h_s"]), im_w=float(lv["w_s"]),
                    valid_h=lv["hb"] // detector_mod.FEAT_STRIDE,
                    valid_w=lv["wb"] // detector_mod.FEAT_STRIDE,
                    score_thresh=st, min_size=0.0, capacity=self.capacity)
                slot = torch.arange(boxes.shape[1], device=self.device)
                row_ok = slot[None, :] < counts[:, None]
                if cfg.TEST.FLIP:
                    # un-mirror in network-input space, about w_s
                    ws_f = float(lv["w_s"])
                    flipped = torch.stack(
                        [ws_f - boxes[1, :, 2], boxes[1, :, 1],
                         ws_f - boxes[1, :, 0], boxes[1, :, 3]], dim=-1)
                    boxes = torch.stack([boxes[0], flipped], dim=0)
                boxes = boxes * lv["inv_fx"]
                scores = torch.where(row_ok, scores, -float("inf"))
                all_boxes.append(boxes.reshape(-1, 4))
                all_scores.append(scores.reshape(-1))
            cat_scores = torch.cat(all_scores)
            rows = torch.cat([torch.cat(all_boxes), cat_scores[:, None]],
                             dim=1)
            # the strict > of the reference (lib/test.py:163)
            keep = cat_scores > thresh
        return {"rows": rows, "keep": keep}

    def finalize_async(self, handle, thresh=0.05):
        """Compact the kept rows on the device, copy only them to the host,
        and run the float64 host vote (or NMS). Returns cls_dets like
        ``detect``. (``thresh`` was applied in ``detect_async``.)"""
        dets = handle["rows"][handle["keep"]].cpu().numpy()
        if cfg.TEST.NMS_METHOD == "BBOX_VOTE":
            return [nms_host.bbox_vote(dets, cfg.TEST.NMS_THRESH)]
        if cfg.TEST.NMS_METHOD == "NMS":
            keep = nms_host.nms(dets, cfg.TEST.NMS_THRESH)
            return [dets[keep, :]]
        raise NotImplementedError(
            f"Unknown NMS method: {cfg.TEST.NMS_METHOD}")

    def detect(self, im, thresh=0.05, timers=None):
        """Full-pyramid detection on one BGR uint8 image (or path).
        Returns ([(N, 5) x1, y1, x2, y2, score], timers): one array for
        the single 'face' class, like the JAX ``TPUDetector.detect``."""
        if timers is None:
            timers = {"detect": Timer(), "misc": Timer()}
        timers["detect"].tic()
        handle = self.detect_async(im, thresh)
        timers["detect"].toc()
        timers["misc"].tic()
        cls_dets = self.finalize_async(handle, thresh)
        timers["misc"].toc()
        return cls_dets, timers
