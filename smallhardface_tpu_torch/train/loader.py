"""Training data pipeline: per-replica sampling, augmentation, minibatch
building, and the hard-image-mining feedback channel.

Counterpart of ``smallhardface_tpu/train/loader.py`` (``RoIDataLoader``,
``_distortion``, ``_sample_crop``, ``get_minibatch``), the reference's
RoIDataLayer + minibatch (lib/roi_data_layer/layer.py, minibatch.py,
lib/utils/blob.py). It runs without OpenCV, which the card's machine
lacks: the float BGR↔HSV conversions of the photometric distortion are
numpy functions of cv2's formulas (``bgr_to_hsv``, ``hsv_to_bgr``), the
host downscale is a separable resize built from the device resize's own
weights (``detect.linear_resize_weights``, cv2's INTER_LINEAR convention),
and cv2 is imported only to read an image path. A roidb entry's
``"image"`` may also be a decoded uint8 BGR array.

  - aspect-ratio-grouped shuffling with a per-replica permutation
    (layer.py:16-51); epoch reshuffle honoring skip/prob flags written by
    the easy-image miner (layer.py:37-50)
  - single image per replica step; random short-side scale from
    TRAIN.SCALES.SHORT_SIDE capped at MAX_SIZE (blob.py:35-70) — the scale
    index is chosen once per step by the train loop so all replicas share a
    compiled shape bucket
  - photometric distortion (brightness/contrast/saturation/hue in the
    reference's exact order and probability structure, blob.py:73-120)
  - random crop 0.6-1.0 with ≥1-face-center enforcement, 50 tries
    (minibatch.py:100-146)
  - images return unpadded; the train loop pads the global batch to a
    shared bucket shape
  - a sample is its draws (``plan_minibatch``: every RNG draw and state
    change, in order, on one thread) and its pixels (``render_minibatch``:
    no RNG), so the images of one iteration render in parallel

Deviation from the reference: augmentation randomness comes from a
per-replica numpy RandomState(RNG_SEED + rank) instead of the forked global
state, making runs reproducible per replica.
"""

from __future__ import annotations

import logging
import sys
import threading

import numpy as np
import torch

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.detect import linear_resize_weights

logger = logging.getLogger(__name__)

_FLT_EPS = np.float32(np.finfo(np.float32).eps)
# HSV→BGR: which of (v, v(1-s), v(1-sf), v(1-s(1-f))) each of b, g, r takes
# in each 60° sector of hue
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr_to_hsv(im):
    """float32 BGR (…, 3) → HSV with H in [0, 360), S in [0, 1] and V on
    the input's scale: cv2.cvtColor(COLOR_BGR2HSV) on float32 images."""
    b, g, r = im[..., 0], im[..., 1], im[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPS)
    d = (60.0 / (diff + _FLT_EPS).astype(np.float64)).astype(np.float32)
    h = np.where(v == r, (g - b) * d,
                 np.where(v == g, (b - r) * d + np.float32(120),
                          (r - g) * d + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_bgr(hsv):
    """Inverse of ``bgr_to_hsv``: cv2.cvtColor(COLOR_HSV2BGR) on float32."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.mod(h * np.float32(6.0 / 360.0), np.float32(6))
    sector = np.floor(h).astype(np.int64)
    f = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    f = np.where(bad, np.float32(0), f)
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * f),
                    v * (one - s * (one - f))], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    return np.where((s == 0)[..., None], v[..., None], bgr).astype(
        np.float32)


def resize_linear(im, scale):
    """float32 (h, w, 3) resized by ``scale`` to (round(h·scale),
    round(w·scale)) with cv2.resize(fx=fy=scale, INTER_LINEAR)'s sampling,
    as two products with the device resize's weight matrices, built and
    applied in float64 (cv2 places its samples in float64)."""
    h, w, c = im.shape
    oh, ow = int(round(h * scale)), int(round(w * scale))
    wy = linear_resize_weights(h, oh, scale, dtype=torch.float64).numpy()
    wx = linear_resize_weights(w, ow, scale, dtype=torch.float64).numpy()
    t = (wy.T @ im.reshape(h, w * c)).reshape(oh, w, c)
    return np.ascontiguousarray(
        (t.transpose(0, 2, 1) @ wx).transpose(0, 2, 1), dtype=np.float32)


def _read_image(image):
    """A roidb entry's image: a decoded uint8 BGR array, or a path."""
    if isinstance(image, np.ndarray):
        return image
    import cv2      # decoding image files only
    im = cv2.imread(image)
    assert im is not None, f"Failed to read {image}"
    return im


def draw_distortion(rng):
    """Every draw of the photometric augmentation (blob.py:73-120), from
    ``rng`` in the JAX package's order: brightness (the test, then the
    delta), the contrast-first coin, then contrast, saturation and hue
    (each the test, then the value) in the order they apply. A value is
    None where its test failed."""
    aug = cfg.TRAIN.AUGMENT

    def draw(node, lo, hi):
        return rng.uniform(lo, hi) if rng.rand() < node.PROB else None

    def contrast():
        return draw(aug.CONTRAST, aug.CONTRAST.LOWER, aug.CONTRAST.UPPER)

    def saturation_hue():
        sat = draw(aug.SATURATION, aug.SATURATION.LOWER,
                   aug.SATURATION.UPPER)
        return sat, draw(aug.HUE, -aug.HUE.DELTA, aug.HUE.DELTA)

    d = {"brightness": draw(aug.BRIGHTNESS, -aug.BRIGHTNESS.DELTA,
                            aug.BRIGHTNESS.DELTA),
         "contrast_first": bool(rng.randint(2))}
    if d["contrast_first"]:
        d["contrast"] = contrast()
        d["saturation"], d["hue"] = saturation_hue()
    else:
        d["saturation"], d["hue"] = saturation_hue()
        d["contrast"] = contrast()
    return d


def apply_distortion(im, d):
    """The photometric augmentation of the float BGR image with the values
    ``draw_distortion`` drew; touches no RNG."""
    def contrast(x):
        if d["contrast"] is not None:
            x = np.clip(x * d["contrast"], 0.0, 255.0)
        return x

    def saturation_hue(x):
        hsv = bgr_to_hsv(x)
        if d["saturation"] is not None:
            hsv[..., 1] = np.clip(hsv[..., 1] * d["saturation"], 0.0, 1.0)
        if d["hue"] is not None:
            hsv[..., 0] = (hsv[..., 0] + d["hue"]) % 360.0
        return hsv_to_bgr(hsv)

    if d["brightness"] is not None:
        im = np.clip(im + d["brightness"], 0.0, 255.0)
    if d["contrast_first"]:
        im = saturation_hue(contrast(im))
    else:
        im = contrast(saturation_hue(im))
    return np.clip(np.round(im), 0.0, 255.0)


def _distortion(im, rng):
    """Photometric augmentation on the float BGR image (blob.py:73-120),
    with the JAX package's draws from ``rng`` in the same order."""
    return apply_distortion(im, draw_distortion(rng))


def _sample_crop(img_h, img_w, gt_boxes, rng):
    """Sample a random crop window keeping ≥1 face center inside
    (minibatch.py:100-146): box geometry only, no pixels touched (the
    crop fuses into the device resize). Returns
    (hs, ws, height, width, transformed gt) or None when no feasible
    window is found."""
    aug = cfg.TRAIN.AUGMENT.CROP
    found = False
    for _ in range(aug.MAX_TRIES):
        wr = rng.uniform(aug.LOWER, aug.UPPER)
        hr = rng.uniform(aug.LOWER, aug.UPPER)
        height = int(np.clip(np.round(img_h * hr), 0, img_h))
        width = int(np.clip(np.round(img_w * wr), 0, img_w))
        hs = rng.randint(img_h - height + 1)
        ws = rng.randint(img_w - width + 1)
        if aug.KEEP_ONLY_CENTER_INSIDE:
            xc = (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2
            yc = (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2
            inside = np.where((xc >= ws) & (xc < ws + width) &
                              (yc >= hs) & (yc < hs + height))[0]
        else:
            inside = np.where(
                (np.clip(gt_boxes[:, 0], ws, None) <
                 np.clip(gt_boxes[:, 2], None, ws + width)) &
                (np.clip(gt_boxes[:, 1], hs, None) <
                 np.clip(gt_boxes[:, 3], None, hs + height)))[0]
        if (not aug.POSITIVE_ENFORCE) or inside.size > 0:
            found = True
            break
    if not found:
        return None
    gt = gt_boxes[inside].copy()
    gt[:, [0, 2]] = np.clip(gt[:, [0, 2]] - ws, 0.0, width)
    gt[:, [1, 3]] = np.clip(gt[:, [1, 3]] - hs, 0.0, height)
    return hs, ws, height, width, gt


class RoIDataLoader:
    """Per-replica sampler and minibatch assembly with epoch-level skip/prob
    feedback (the RoIDataLayer role)."""

    def __init__(self, roidb, rank=0):
        self.rank = rank
        self._roidb = roidb
        # two independent streams, as in the JAX loader: self.rng feeds
        # the sampling and augmentation draws (plan_minibatch), the
        # feedback stream feeds mark_easy. The port's train loop calls
        # both in one fixed order (the prefetch thread applies the marks
        # it is handed before its first draw), so each stream replays
        # at resume
        self.rng = np.random.RandomState(int(cfg.RNG_SEED) + rank)
        self._feedback_rng = np.random.RandomState(
            int(cfg.RNG_SEED) + rank + 7919)
        # per-replica mining state: the reference forked one process per
        # GPU, so skip/prob flags were rank-private (lib/train.py:249-258);
        # the shared roidb here stays read-only and flags live locally
        self._mining = {}          # im_idx -> {"prob": p} or {"skip": k}
        # the lock guards _perm/_cur/_mining against a caller that plans
        # on one thread while another marks or snapshots
        self._lock = threading.Lock()
        self._shuffle()

    def _shuffle(self):
        roidb = self._roidb
        if cfg.TRAIN.ASPECT_GROUPING:
            widths = np.array([r["width"] for r in roidb])
            heights = np.array([r["height"] for r in roidb])
            horz_inds = np.where(widths >= heights)[0]
            vert_inds = np.where(widths < heights)[0]
            inds = np.hstack((self.rng.permutation(horz_inds),
                              self.rng.permutation(vert_inds)))
            n_pairs = len(inds) // 2
            pairs = inds[:n_pairs * 2].reshape(-1, 2)
            row_perm = self.rng.permutation(np.arange(n_pairs))
            inds = np.concatenate(
                [pairs[row_perm].reshape(-1), inds[n_pairs * 2:]])
            self._perm = list(inds)
        else:
            self._perm = list(self.rng.permutation(len(roidb)))
        skipped = []
        if cfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH:
            for i, m in self._mining.items():
                if "prob" in m and self.rng.rand() < m["prob"]:
                    skipped.append(i)
        else:
            for i, m in self._mining.items():
                if m.get("skip", 0) >= 1:
                    skipped.append(i)
                    m["skip"] -= 1
        if skipped:
            skipset = set(skipped)
            self._perm = [i for i in self._perm if i not in skipset]
            logger.warning("%d images disabled, %d images left, rank: %d",
                           len(skipped), len(self._perm), self.rank)
        self._cur = 0

    def _next_index(self):
        with self._lock:
            if self._cur >= len(self._perm):
                logger.info("New epoch, rank: %d", self.rank)
                self._shuffle()
            idx = self._perm[self._cur]
            self._cur += 1
            return idx

    def state_dict(self):
        """Snapshot the sampler: RNG streams, permutation cursor, and
        mining flags. Together with the weights/optimizer checkpoint this
        makes resume bit-reproducible in the data stream (exceeds the
        reference, which restarted its data layers from scratch).

        Easy-image marks: the train loop drains the in-flight metrics of
        the pipelined iterations BEFORE capturing this snapshot on
        snapshot iterations (train_loop will_snap branch), so the
        captured mining state carries every mark for iterations ≤ the
        snapshot iteration and the replayed stream cannot lose marks at
        resume."""
        import copy
        with self._lock:
            return {
                "rng": self.rng.get_state(),
                "feedback_rng": self._feedback_rng.get_state(),
                "perm": list(self._perm),
                "cur": int(self._cur),
                "mining": copy.deepcopy(self._mining),
            }

    def load_state_dict(self, state):
        with self._lock:
            self.rng.set_state(state["rng"])
            self._feedback_rng.set_state(state["feedback_rng"])
            self._perm = list(state["perm"])
            self._cur = int(state["cur"])
            # the literal keys are interned, so a state saved after a
            # resume pickles to the same bytes as the straight run's
            self._mining = {i: {sys.intern(k): v for k, v in m.items()}
                            for i, m in state["mining"].items()}

    def mark_easy(self, im_idx):
        """Easy-image feedback from the device step
        (multi_layer_anchor_layer.py:329-338). State is rank-private."""
        dei = cfg.TRAIN.DISABLE_EASY_IMAGE
        if not dei.ENABLE:
            return
        with self._lock:
            if dei.SMOOTH:
                self._mining.setdefault(im_idx, {})["prob"] = dei.PROB
            elif self._feedback_rng.rand() <= dei.PROB:
                self._mining.setdefault(im_idx, {})["skip"] = np.inf
                logger.warning("%d ignored at rank: %d", im_idx, self.rank)

    def get_minibatch(self, scale_idx):
        """Build one training sample at the given scale index: its draws
        (``plan_minibatch``), then its pixels (``render_minibatch``).

        Host work stops at the distorted uint8 ORIGINAL: the resize to the
        training scale and the random crop fuse into the device step
        (scale_and_translate with translation = -crop offset), so no
        megapixel cv2.resize runs on the host and the upload is the
        original image. gt boxes ship already transformed to the final
        (resized, cropped) frame.

        Returns dict: data (h0, w0, 3) uint8 original, gt_boxes (G, 5),
        im_scale, crop (hs, ws) in resized coords, im_idx, height, width
        (the FINAL post-crop extent driving bucket/valid shapes)."""
        return render_minibatch(self.plan_minibatch(scale_idx))

    def plan_minibatch(self, scale_idx):
        """Every random draw and every loader-state change of one sample,
        in ``get_minibatch``'s order: the index (and an epoch reshuffle),
        the distortion's values, the scale, the crop and the transformed
        gt, and the ``seen_scale`` record. Reads no pixel: the extent comes
        from the roidb entry's ``height`` and ``width``. Returns the plan
        that ``render_minibatch`` turns into the sample."""
        mode = cfg.TRAIN.SCALES.MODE
        assert mode in ("SHORT_SIDE", "FACE_AREA"), \
            f"Unknown TRAIN.SCALES.MODE: {mode}"
        idx = self._next_index()
        entry = self._roidb[idx]
        h0, w0 = int(entry["height"]), int(entry["width"])
        distortion = (draw_distortion(self.rng) if cfg.TRAIN.AUGMENT.ENABLE
                      else None)
        # NOTE: pixel-mean subtraction happens ON DEVICE (train step), so
        # the batch ships as uint8 (4× less host→device traffic). The
        # reference subtracts before resizing (blob.py:45), but bilinear
        # resize commutes with constant subtraction; the only deviation is
        # ≤0.5-intensity rounding of the resized image, far below the
        # photometric augmentation noise (brightness ±32).

        target_size = cfg.TRAIN.SCALES.SHORT_SIDE[scale_idx]
        size_min, size_max = min(h0, w0), max(h0, w0)
        if cfg.TRAIN.ORIG_SIZE:
            im_scale = 1.0
        else:
            if mode == "SHORT_SIDE":
                im_scale = float(target_size) / size_min
            else:
                # FACE_AREA: median face area → target (blob.py:54-55)
                b = entry["boxes"]
                face_median = float(np.median(
                    (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])))
                if not np.isfinite(face_median) or face_median == 0:
                    im_scale = 1.0
                else:
                    im_scale = float(np.sqrt(target_size / face_median))
            if np.round(im_scale * size_max) > cfg.TRAIN.SCALES.MAX_SIZE:
                im_scale = float(cfg.TRAIN.SCALES.MAX_SIZE) / size_max
        # resized extent with cv2's dst-rounding convention, whether the
        # host downscales (resize_linear's extent) or the device upscales
        # (it samples at 1/im_scale, identical to cv2.resize fx=)
        hr, wr = int(round(h0 * im_scale)), int(round(w0 * im_scale))

        gt_inds = np.where(entry["gt_classes"] != 0)[0]
        gt = np.zeros((len(gt_inds), 5), dtype=np.float32)
        gt[:, :4] = entry["boxes"][gt_inds] * im_scale
        gt[:, 4] = entry["gt_classes"][gt_inds]

        hs = ws = 0
        height, width = hr, wr
        if (cfg.TRAIN.AUGMENT.ENABLE and
                self.rng.rand() < cfg.TRAIN.AUGMENT.CROP.PROB):
            crop = _sample_crop(hr, wr, gt, self.rng)
            if crop is not None:
                hs, ws, height, width, gt = crop

        with self._lock:
            self._mining.setdefault(idx, {}).setdefault(
                "seen_scale", []).append(im_scale)
        return {"image": entry["image"], "flipped": bool(entry["flipped"]),
                "extent": (h0, w0), "distortion": distortion,
                "im_scale": im_scale, "gt_boxes": gt, "crop": (hs, ws),
                "im_idx": idx, "height": height, "width": width}


def render_minibatch(plan):
    """The pixels of a ``plan_minibatch`` plan: read the image (and check
    it against the roidb's extent), flip it, distort it with the drawn
    values, downscale it on the host when the scale is below 1, and round
    to uint8. Touches no RNG and no loader state, so the plans of one
    iteration render in parallel. Returns ``get_minibatch``'s sample."""
    im = _read_image(plan["image"])
    if im.shape[:2] != plan["extent"]:
        raise ValueError(
            f"image {plan['im_idx']} decodes to {im.shape[:2]} but its "
            f"roidb entry says (height, width) = {plan['extent']}")
    if plan["flipped"]:
        im = im[:, ::-1, :]
    im = im.astype(np.float32)
    if plan["distortion"] is not None:
        im = apply_distortion(im, plan["distortion"])
    # Downscales resize on the HOST (the resized image is SMALLER than the
    # original, so shipping it minimizes the upload and keeps the compiled
    # original-shape set bounded by the scale buckets); upscales ship the
    # original and resize on device (the original is the minimal
    # representation). Either way the device step sees (data, ship_scale,
    # crop) with cv2 fx-sampling semantics.
    ship_scale = plan["im_scale"]
    if ship_scale < 1.0:
        im = resize_linear(im, ship_scale)
        ship_scale = 1.0
    data = np.ascontiguousarray(np.clip(np.round(im), 0, 255),
                                dtype=np.uint8)
    return {
        "data": data,
        "gt_boxes": plan["gt_boxes"],
        "im_scale": float(ship_scale),
        "crop": plan["crop"],
        "im_idx": plan["im_idx"],
        "height": plan["height"],
        "width": plan["width"],
    }
