"""Per-image detection: multi-scale pyramid + flip TTA + merge + vote.

Counterpart of ``smallhardface_tpu/detect.py``: ``compute_scaling_factor``
and ``_pyramid_scales`` (:38-73), and ``TPUDetector`` (``_build_run``,
``forward_scale``, ``detect_async``, ``finalize_async``, ``detect``) as
``TorchDetector``:

- the raw uint8 image, edge-padded to ×16, is uploaded once, and so is
  the level table, every number the levels read on the device
  (``_level_table``); both leave from pinned memory without waiting for
  the device, so nothing before the readback waits for it, and the
  readback waits for its own image's work alone (``_after``);
- every pyramid level is derived on the device: a linear resize with the
  weight matrices ``jax.image.scale_and_translate(method="linear",
  antialias=False)`` builds, mean subtraction, zeros beyond the level's
  extent, and the mirrored copy for flip TTA;
- each level runs at its exact ×16 shape (the JAX ``"exact"`` mask mode),
  image and mirror as a batch of 2, then softmax and decode;
- ``detect_many`` (JAX detect.py:586-680) runs the images that share a
  ``_prep`` key as one batch through every level, at level buckets
  rounded up to ``TPU.TEST_BUCKET`` (the only reader of that knob), each
  image with its own resize, mirror and extent (the forward masks each
  one to its own extent, the JAX ``"where"`` mode under ``vmap``), and
  votes all of them in one launch;
- levels merge in original-image coordinates and the strict ``> thresh``
  cut applies;
- under ``TPU.DEVICE_VOTE`` (the default) the top ``TPU.VOTE_CAP`` rows
  above the cut are voted on the device (``ops/nms_device``, the CUDA
  kernel V1 on the card) and only the voted rows are copied to the host;
  otherwise the kept rows (the top ``TPU.MERGED_DET_CAP`` when that is
  > 0) are copied and voted on the host in float64 through ``ops/native``
  (the port's copy of the JAX package's loader for the repo-root
  ``csrc/shf_host.cpp``).

``TPU.HOST_PREPROC`` is the reference-exact parity path: a cv2 resize per
level on the host, one float32 upload per level, and the float64 host
vote.

``TPU.PRECISION = "int8"`` is the JAX int8 serving mode (JAX
detect.py:121-146, :453-500): ``calibrate_int8`` sets ``qstate`` and the
forward runs the calibrated int8 chain; without it each int8 conv takes a
dynamic activation step, shared by exactly the items one JAX forward call
would see (``_scale_groups``). ``TPU.PRECISION = "bfloat16"`` is the JAX
bf16 mode (JAX detect.py:121-123): preprocessing stays fp32, the forward
runs in bf16 (``Detector.forward``) and gives fp32 logits, and softmax,
decode, the merge and the vote run in fp32 as in the other modes.

The network is the model of ``MODEL.ARCH`` (``models.for_config``):
preprocessing, the merge and the vote are shared by every model; the model
answers what it refuses, what its forward masks a level to and one level's
decode into rows in network-input coordinates, and ``_image_rows`` takes
those rows to original-image coordinates for every model alike. Each
level runs at its extent rounded up to ×MAX_RESOLUTION, which the model's
TOML sets (the "×16 shapes" below).

Spatial sharding (``TPU.SPATIAL_DEVICES`` = k > 1, JAX detect.py:92-137,
:366-379, :560-568): the detector runs each level's rows over a unit of k
devices (``spatial_devices``; ``parallel/spatial``). Every device gets the
raw uint8 image and builds its own rows of the level directly (its rows
of the resize's ``wy``); the level's height is padded to
``spatial.padded_height`` and the forward, masked to the level's extent,
runs its shards (the stem as K4), gathers the head outputs to the first
device and crops them to the level, where decode, the merge and the vote
run as on one device. ``TPU.HOST_PREPROC`` with spatial sharding raises
at construction, and ``detect_many`` refuses it, as in JAX.
"""

from __future__ import annotations

import contextlib
import logging
import math

import numpy as np
import torch

from smallhardface_tpu_torch import models
from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.models import detector as detector_mod
from smallhardface_tpu_torch.ops import decode as decode_mod
from smallhardface_tpu_torch.ops import native as nms_host
from smallhardface_tpu_torch.ops import nms_device
from smallhardface_tpu_torch.parallel import spatial
from smallhardface_tpu_torch.utils.device import resolve_device
from smallhardface_tpu_torch.utils.timer import Timer, no_stages

logger = logging.getLogger(__name__)

# TPU knobs of the config schema that the port reads and ignores, each
# with why (ROADMAP "Not carried over"); TorchDetector logs them.
IGNORED_TPU_KNOBS = {
    "MASK_MODE": "detect runs every level at its exact x16 shape (the JAX "
                 "'exact' mode) and detect_many masks each image of a "
                 "bucket to its own extent (the JAX 'where' mode); the "
                 "'band' margin was a TPU speed trick. Under int8 it is "
                 "read: 'band' raises as in JAX, and it picks the level "
                 "area FLIP_SPLIT_PX is compared with",
    "S2D_STEM": "a TPU matrix-unit layout trick for conv1_1; the stem is "
                "one fused CUDA kernel",
    "PALLAS_STEM": "the stem always runs through ops/stem.fused_stem: the "
                   "kernel on a CUDA tensor, its plain version on the CPU",
    "LEVEL_SERIAL": "XLA scheduling barriers; eager execution already "
                    "runs the levels in order",
    "FLIP_SPLIT_PX": "in float32 a TPU batch-2 efficiency workaround that "
                     "never changes the output; the dynamic int8 mode "
                     "reads it, since at levels of at least this many "
                     "pixels JAX runs the image and its mirror as two "
                     "forwards with an activation step each "
                     "(TorchDetector._scale_groups)",
    "DECODE_FAST_K": "a faster TPU top-k with identical output; the port "
                     "sorts once per level",
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


def level_sizes(im_shape):
    """The pyramid levels of an image of ``im_shape`` as ``detect`` sizes
    them: (scale, h_s, w_s, hb, wb) a level, the resized extent
    (h_s, w_s) and the network input (hb, wb), that extent (at least one
    pixel) rounded up to ×MAX_RESOLUTION."""
    h0, w0 = im_shape[:2]
    m = cfg.MAX_RESOLUTION
    sizes = []
    for scale in _pyramid_scales(im_shape):
        h_s, w_s = int(round(h0 * scale)), int(round(w0 * scale))
        sizes.append((scale, h_s, w_s, _round_up(max(h_s, 1), m),
                      _round_up(max(w_s, 1), m)))
    return sizes


def inverse_scale(scale, dtype=torch.float32):
    """fl(1 / scale) in ``dtype``, taken on the host (a 0-d CPU tensor):
    the factor by which ``linear_resize_weights`` places its samples."""
    return 1.0 / torch.tensor(scale, dtype=dtype)


def linear_resize_weights(in_size, out_size, scale, device=None,
                          translation=0.0, dtype=torch.float32,
                          wait=contextlib.nullcontext, inv_scale=None):
    """(in_size, out_size) float32 weights of a linear resize by ``scale``
    and shift by ``translation`` output pixels, built as
    ``jax._src.image.scale.compute_weight_mat`` builds them for
    ``method="linear", antialias=False``: output o samples the input at
    (o + 0.5) / scale - translation / scale - 0.5 with a triangle kernel,
    each column is normalised to sum 1, and a sample outside
    [-0.5, in_size - 0.5] gets zero weight. That is cv2's INTER_LINEAR
    convention with an explicit fx (tests/test_device_preproc.py); a crop
    at offset c of the resized image is translation −c. ``dtype`` is the
    arithmetic's: float32 as on the device, float64 as cv2 computes its
    sample positions.

    ``scale`` and ``translation`` are host numbers: ``inverse_scale(scale)``
    and ``translation`` are copied to ``device``, each under ``wait()``
    (a copy from pageable host memory waits for the device's queue to
    drain). Or ``inv_scale``, a 0-d tensor on ``device`` holding
    ``inverse_scale(scale)``, stands for ``scale`` and ``translation`` is
    a 0-d tensor on ``device`` too (the detector's level table): nothing
    is copied."""
    if inv_scale is None:
        with wait():
            inv_scale = inverse_scale(scale, dtype).to(device)
        with wait():
            translation = torch.tensor(translation, dtype=dtype).to(device)
    sample = ((torch.arange(out_size, dtype=dtype, device=device)
               + 0.5) * inv_scale - translation * inv_scale - 0.5)
    pos = torch.arange(in_size, dtype=dtype, device=device)
    weights = (1.0 - (sample[None, :] - pos[:, None]).abs()).clamp_min(0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0),
                          0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def upload_arrays(arrays, device):
    """Host arrays ({name: numpy array}) on ``device`` as views of one
    buffer that one copy fills. To a CUDA device the copy leaves from
    fresh pinned memory and does not wait for the device: the caching
    host allocator keeps the block until the copy has run, so a call made
    while earlier work is queued overwrites nothing that work reads. On
    the CPU the views are of the host buffer."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(a))
               for k, a in arrays.items()}
    spans, end = {}, 0
    for k, t in tensors.items():
        start = end + -end % 8      # each view at a multiple of 8 bytes
        spans[k], end = (start, start + t.nbytes), start + t.nbytes
    host = torch.empty(end, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")

    def views(buf):
        return {k: buf[a:b].view(tensors[k].dtype).view(tensors[k].shape)
                for k, (a, b) in spans.items()}
    for k, v in views(host).items():
        v.copy_(tensors[k])
    return views(host.to(device, non_blocking=True))


def _imread(path):
    import cv2      # host-side image decoding only; not on the GPU path
    im = cv2.imread(path)
    if im is None:
        raise FileNotFoundError(f"could not read image {path!r}")
    return im


class TorchDetector:
    """Full-pyramid detector on one device, or on a spatial unit.

    params: {name: {'w': OIHW, 'b'}} tensors (``models.detector
    .init_params`` or ``io.weights``); spec: ``ModelSpec`` (from the config
    when None); device: where the network runs, the CUDA card when None
    (raises when there is none; pass "cpu" for the CPU). Under
    TPU.PRECISION = "int8" the forward runs the int8 mode: the calibrated
    chain once ``calibrate_int8`` (or the caller) has set ``qstate``
    (``models.detector.make_qstate``), the dynamic mode while it is None.
    Under "bfloat16" it runs the bf16 mode.

    spatial_devices: the unit that shards every level's rows (JAX
    ``spatial_mesh``), a list of k devices; the first holds the weights
    and gathers the outputs, and ``device`` must name it or be None. When
    None and TPU.SPATIAL_DEVICES = k > 1, the unit is the first k local
    devices of ``device``'s type (k CUDA cards by default; ValueError when
    there are fewer). A list that repeats one device, such as
    ``["cuda:0"] * 2`` or ``["cpu"] * 4``, is allowed: the shards then run
    one after another there, which is how one card runs the path. One
    device is no sharding.
    """

    def __init__(self, params, spec=None, device=None, spatial_devices=None):
        precision = str(cfg.TPU.PRECISION)
        if precision not in ("float32", "int8", "bfloat16"):
            raise ValueError(
                f"TPU.PRECISION={precision!r}: expected 'float32', "
                "'bfloat16' or 'int8'")
        # the model of MODEL.ARCH (models.for_config)
        self.arch = models.for_config(cfg)
        self.arch.refuse(cfg, "detect", spatial_devices)
        if precision == "int8":
            mode = str(cfg.TPU.MASK_MODE)
            if mode not in ("band", "band_margin", "where", "exact"):
                raise ValueError("TPU.MASK_MODE must be 'band', 'where' or "
                                 f"'exact', got {mode!r}")
            if mode in ("band", "band_margin"):
                # JAX detect.py:128-136, one config refused alike
                raise ValueError(
                    "TPU.PRECISION='int8' requires TPU.MASK_MODE 'exact' or "
                    "'where' (dynamic activation scales are global "
                    f"reduces; '{mode}' buckets carry garbage padding)")
        self.precision = precision
        # the calibrated int8 state (calibrate_int8); None = dynamic steps
        self.qstate = None
        for knob, why in IGNORED_TPU_KNOBS.items():
            logger.debug("TPU.%s=%r ignored: %s", knob, cfg.TPU[knob], why)
        k = int(cfg.TPU.SPATIAL_DEVICES)
        if spatial_devices is None and k > 1:
            spatial_devices = spatial.first_devices(resolve_device(device), k)
        self.spatial = None
        if spatial_devices is not None and len(spatial_devices) > 1:
            self.spatial = [_indexed(d) for d in spatial_devices]
            if device is not None and _indexed(device) != self.spatial[0]:
                raise ValueError(
                    f"device {device} is not the spatial unit's first "
                    f"device {self.spatial[0]}")
            device = self.spatial[0]
        self.device = resolve_device(device)
        self.spec = spec or detector_mod.build_spec(cfg)
        self.model = self.arch.build(params, self.spec, self.device)
        cap = int(cfg.TPU.DET_CAPACITY)
        self.capacity = cap if cap > 0 else int(cfg.TEST.N_DETS_PER_MODULE)
        self.mean = torch.tensor(np.asarray(cfg.PIXEL_MEANS, np.float32)
                                 .reshape(3), device=self.device)
        self.host_preproc = bool(cfg.TPU.HOST_PREPROC)
        if self.spatial and self.host_preproc:
            # JAX detect.py:133-137: the host path has no sharded program
            raise ValueError(
                "spatial sharding is incompatible with TPU.HOST_PREPROC "
                "(the reference-exact host path has no sharded program); "
                "unset one of them")
        # the final vote on the device: only voted rows cross to the host
        self.device_vote = bool(cfg.TPU.DEVICE_VOTE) and not self.host_preproc
        self.vote_cap = int(cfg.TPU.VOTE_CAP)
        self.merged_cap = int(cfg.TPU.MERGED_DET_CAP)
        self._warned_host_preproc = False
        # the stage hook (utils.timer.no_stages; tools/pyramid_time sets a
        # tools.measure.Stages): prep, upload, preproc, forward, decode,
        # vote, readback; inside them, "wait_<stage>" around each call that
        # waits for the device
        self.stages = no_stages

    def _prep(self, im):
        """The raw image edge-padded to ×16 (``padded``, the exact-shape
        path of ``detect``), the per-level metadata, all host Python
        numbers (resize factor, its float32 inverse, the resized extent
        (h_s, w_s), the ×16 level shape (hb, wb) and its ``TPU.TEST_BUCKET``
        bucket (bh, bw)), and ``key``: the images of one key share their
        raw shape padded to the bucket (H0b, W0b) and every level's bucket,
        so ``detect_many`` runs them as one batch (JAX detect.py:504-551,
        without its TPU mask-mode and layout knobs)."""
        if isinstance(im, str):
            im = _imread(im)
        h0, w0 = im.shape[:2]
        padded = _pad_to(im, _round_up(h0, cfg.MAX_RESOLUTION),
                         _round_up(w0, cfg.MAX_RESOLUTION))
        bucket = max(int(cfg.TPU.TEST_BUCKET), cfg.MAX_RESOLUTION)
        levels = []
        for scale, h_s, w_s, hb, wb in level_sizes(im.shape):
            inv_fx = float(np.float32(1.0 / scale))
            levels.append({
                # the JAX program receives inv_fx as float32 and resizes by
                # its float32 reciprocal
                "scale": float(np.float32(1.0) / np.float32(inv_fx)),
                "inv_fx": inv_fx, "h_s": h_s, "w_s": w_s, "hb": hb, "wb": wb,
                "bh": _round_up(hb, bucket), "bw": _round_up(wb, bucket)})
        vote = str(cfg.TEST.NMS_METHOD) if self.device_vote else None
        key = (_round_up(h0, bucket), _round_up(w0, bucket),
               tuple((lv["bh"], lv["bw"]) for lv in levels),
               bool(cfg.TEST.FLIP), vote)
        return {"image": im, "padded": np.ascontiguousarray(padded),
                "levels": levels, "key": key}

    def _level_table(self, levels):
        """The numbers that the levels of N images read on the device, as
        host arrays {field: (L, N)}, ``levels[l][i]`` being image i's
        metadata of level l: int64 "h_s", "w_s", "hb", "wb"; in the
        dynamic int8 mode "groups" (L, N·F), each level's step groups
        (``_scale_groups``); float32 "inv_scale" (``inverse_scale`` of the
        level's scale), "shift" (the resize's translation, 0), "w_flip"
        (w_s, the width the mirror's boxes flip about) and "inv_fx"."""
        def field(key, dtype):
            return np.array([[lv[key] for lv in lvs] for lvs in levels],
                            dtype)
        table = {k: field(k, np.int64) for k in ("h_s", "w_s", "hb", "wb")}
        groups = [self._scale_groups(lvs) for lvs in levels]
        if groups[0] is not None:
            table["groups"] = np.stack(groups)
        table["inv_scale"] = np.array(
            [[inverse_scale(lv["scale"]).item() for lv in lvs]
             for lvs in levels], np.float32)
        table["shift"] = np.zeros(table["h_s"].shape, np.float32)
        table["w_flip"] = field("w_s", np.float32)
        table["inv_fx"] = field("inv_fx", np.float32)
        return table

    def _fields(self, lvs, device):
        """One level's numbers of N images (metadata ``lvs``) on
        ``device``: the views of a one-level table (``_level_table``)."""
        return {k: v[0] for k, v in
                upload_arrays(self._level_table([lvs]), device).items()}

    def _level_batch(self, imgs, lvs, hb, wb, rows=None, fields=None):
        """(N·F, hb, wb, 3) network input of one level for N float images
        (N, H0, W0, 3) of one raw shape, each with its own level metadata
        ``lvs[i]``: its own linear resize, the mean subtracted, zeros beyond
        its own extent (h_s, w_s), and under TEST.FLIP (F = 2) its mirror
        about its own w_s right after it. ``rows=(r0, r1)``: only the
        level's rows [r0, r1) (a shard's, on the device of ``imgs``), as
        the product with those rows of the resize's ``wy``; rows past hb
        are zeros like any row beyond h_s. ``fields``: the level's numbers
        on the device of ``imgs`` (views of an uploaded ``_level_table``);
        None copies them from ``lvs`` for this call (``_fields``)."""
        n, H0, W0, _ = imgs.shape
        dev = imgs.device
        if fields is None:
            fields = self._fields(lvs, dev)
        r0, r1 = rows or (0, hb)

        def resize(in_size, out_size):
            return torch.stack([linear_resize_weights(
                in_size, out_size, None, dev, translation=fields["shift"][i],
                inv_scale=fields["inv_scale"][i]) for i in range(n)])
        wy = resize(H0, r1)[:, :, r0:]
        wx = resize(W0, wb)
        t = (wy.transpose(1, 2) @ imgs.reshape(n, H0, W0 * 3)).reshape(
            n, r1 - r0, W0, 3)
        # rows and colours of an image fold into one product with its wx
        t = t.permute(0, 1, 3, 2).reshape(n, (r1 - r0) * 3, W0)
        resized = ((t @ wx).reshape(n, r1 - r0, 3, wb).permute(0, 1, 3, 2)
                   - self.mean.to(dev))
        h_s, w_s = fields["h_s"], fields["w_s"]
        rows = torch.arange(r0, r1, device=dev) < h_s[:, None]
        cols = torch.arange(wb, device=dev) < w_s[:, None]
        valid = (rows[:, :, None] & cols[:, None, :])[..., None]
        resized = torch.where(valid, resized, 0.0)
        if not cfg.TEST.FLIP:
            return resized.contiguous()
        # mirror about each image's own width w_s, not the padded wb
        idx = (w_s[:, None] - 1 - torch.arange(wb, device=dev)).clamp(
            0, wb - 1)
        mirrored = torch.gather(
            resized, 2, idx[:, None, :, None].expand(n, r1 - r0, wb, 3))
        mirrored = torch.where(valid, mirrored, 0.0)
        return torch.stack([resized, mirrored], dim=1).reshape(
            n * 2, r1 - r0, wb, 3)

    def _sharded_level(self, imgs, lvs, hb, wb, fields):
        """One level over the spatial unit: the shards of its batch, each
        built on its device from that device's copy of the raw images
        (``imgs``) and of the level's numbers (``fields``), both {device:
        …}, over ``spatial.padded_height(hb, k)`` rows; and the valid
        extent the forward masks to, None when no rows were added."""
        k = len(self.spatial)
        hp = spatial.padded_height(hb, k)
        hs = hp // k
        shards = [self._level_batch(imgs[dev], lvs, hb, wb,
                                    rows=(i * hs, (i + 1) * hs),
                                    fields=fields[dev])
                  for i, dev in enumerate(self.spatial)]
        return shards, ((hb, wb) if hp != hb else None)

    def _forward_level(self, imgs, lvs, hb, wb, valid_hw, fields, level):
        """The forward of one level's batch: on one device from
        ``_level_batch``, or over the spatial unit, its outputs cropped to
        the level's hb / 8 rows. ``imgs`` and ``fields`` by device."""
        groups = fields[self.device].get("groups")
        if self.spatial is None:
            with self.stages("preproc", level):
                x = self._level_batch(imgs[self.device], lvs, hb, wb,
                                      fields=fields[self.device])
            with self.stages("forward", level):
                return self.model(x, valid_hw, self.precision, self.qstate,
                                  scale_groups=groups)
        with self.stages("preproc", level):
            shards, valid = self._sharded_level(imgs, lvs, hb, wb, fields)
        with self.stages("forward", level):
            out = self.model(shards, valid, self.precision, self.qstate,
                             scale_groups=groups)
            rows = hb // detector_mod.FEAT_STRIDE
            return {k: v[:, :rows] for k, v in out.items()}

    def _pyramid(self, preps, bucketed, score_thresh):
        """Enqueue the whole pyramid of N images on the device: every level
        of all of them as one batch (image and mirror per image), at the
        exact ×16 shapes of one image, or at the shared level buckets of a
        ``_prep`` key with each image's own extents (``bucketed``). Returns
        the merged rows of every level per image, boxes (N, R, 4) in each
        image's original coordinates and scores (N, R), -inf on empty
        slots; nothing waits for the device."""
        n = len(preps)
        reps = 2 if cfg.TEST.FLIP else 1
        st = float(score_thresh if score_thresh is not None
                   else cfg.TEST.SCORE_THRESH)
        levels = [[p["levels"][li] for p in preps]
                  for li in range(len(preps[0]["levels"]))]
        all_boxes, all_scores = [], []
        with self.stages("upload"):
            raw = torch.from_numpy(
                np.stack([p["padded"] for p in preps]) if not bucketed
                else np.stack([_pad_to(p["image"], *p["key"][:2])
                               for p in preps]))
            if self.device.type == "cuda":
                raw = raw.pin_memory()
            table = self._level_table(levels)
            # the raw images and the level table once on every device of
            # the unit, copies that do not wait for the device
            imgs, tables = {}, {}
            for d in dict.fromkeys(self.spatial or [self.device]):
                # the uint8 copy is freed here, not after the pyramid
                imgs[d] = raw.to(d, non_blocking=True).float()
                tables[d] = upload_arrays(table, d)
        for li, lvs in enumerate(levels):
            hb, wb = ((lvs[0]["bh"], lvs[0]["bw"]) if bucketed
                      else (lvs[0]["hb"], lvs[0]["wb"]))
            fields = {d: {k: v[li] for k, v in t.items()}
                      for d, t in tables.items()}
            # the extent the forward masks each item to
            valid = self.model.level_extent(lvs, fields[self.device], reps,
                                            bucketed)
            out = self._forward_level(imgs, lvs, hb, wb, valid, fields, li)
            with self.stages("decode", li):
                rows = self.model.decode_level(
                    out, lvs, fields[self.device], reps, st, self.capacity)
                boxes, scores = _image_rows(*rows, n, reps)
            all_boxes.append(boxes)
            all_scores.append(scores)
        with self.stages("decode"):
            return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)

    def _scale_groups(self, lvs):
        """The dynamic int8 mode's step groups of one level's batch (image
        i's items i·F .. i·F + F - 1): the ids that ``Detector.forward``
        shares one activation step across, an (N·F,) int64 host array, or
        None outside that mode. JAX takes the step over what one forward
        call sees: ``detect_many`` is a ``vmap`` over images, so no step
        spans two images, and a level whose JAX bucket has at least
        TPU.FLIP_SPLIT_PX pixels runs the image and its mirror as two
        forwards (JAX detect.py:248-271), a step each; below it the pair
        shares one. JAX's bucket is the ×16 shape under MASK_MODE "exact",
        else the TEST_BUCKET bucket. Masked padding is zero and takes no
        part in a max, so the bucket the port runs at does not matter."""
        if self.precision != "int8" or self.qstate is not None:
            return None
        reps = 2 if cfg.TEST.FLIP else 1
        exact = str(cfg.TPU.MASK_MODE) == "exact"
        ids = []
        for i, lv in enumerate(lvs):
            area = lv["hb"] * lv["wb"] if exact else lv["bh"] * lv["bw"]
            split = area >= int(cfg.TPU.FLIP_SPLIT_PX)
            ids += [i * reps + (f if split else 0) for f in range(reps)]
        return np.array(ids, np.int64)

    def calibrate_int8(self, images):
        """Calibrate the int8 mode's static activation steps (JAX
        ``TPUDetector.calibrate_int8``, detect.py:453-500). images: BGR
        uint8 arrays or paths. Each is resized on the host with cv2
        INTER_LINEAR at every TEST scale (in uint8, as JAX resizes it),
        mean-subtracted and zero-padded to ×16; an fp32 forward over each
        with no valid extent (the padding takes part, as in JAX) folds
        every int8 conv's max|input| (``collect_int8_amax``, over the
        shards of the spatial unit when there is one); the maxima
        and the int8 weights, quantized once, become ``self.qstate``.
        Returns the amax dict. Values outside the calibrated ranges
        saturate: use representative images."""
        if self.precision != "int8":
            raise ValueError("calibrate_int8 requires TPU.PRECISION='int8'")
        import cv2      # the host resize JAX calibrates with
        mean = np.asarray(cfg.PIXEL_MEANS, np.float32)
        xs = []
        for im in images:
            if isinstance(im, str):
                im = _imread(im)
            for scale in _pyramid_scales(im.shape):
                r8 = cv2.resize(im, None, fx=scale, fy=scale,
                                interpolation=cv2.INTER_LINEAR)
                h, w = r8.shape[:2]
                x = np.zeros((1, _round_up(h, cfg.MAX_RESOLUTION),
                              _round_up(w, cfg.MAX_RESOLUTION), 3),
                             np.float32)
                x[0, :h, :w] = r8.astype(np.float32) - mean
                xs.append(x)
        amax = detector_mod.collect_int8_amax(self.model, xs, self.spatial)
        self.qstate = detector_mod.make_qstate(self.model.tree(), self.spec,
                                               amax)
        logger.info("int8 calibration over %d pyramid inputs: %s", len(xs),
                    {k: round(v, 1) for k, v in sorted(amax.items())})
        return amax

    def merged_candidates(self, im, thresh=0.05, score_thresh=None):
        """Upload one image and enqueue its whole pyramid on the device.
        Returns the merged rows of every level (boxes (R, 4) in
        original-image coordinates, scores (R,), -inf on empty slots) and
        which of them pass the detect-level cut (scores > thresh), all on
        the device; nothing waits for it."""
        with torch.inference_mode():
            boxes, scores = self._pyramid([self._prep(im)], False,
                                          score_thresh)
            # the strict > of the reference (lib/test.py:163)
            return boxes[0], scores[0], scores[0] > thresh

    def _dispatch(self, boxes, scores, thresh):
        """The final stage of N images' merged rows (N, R, ·) on the
        device, one handle per image for ``finalize_async``: under the
        device vote the top VOTE_CAP kept rows of every image are voted in
        one launch; otherwise each image's kept rows (the top
        MERGED_DET_CAP when that is > 0) wait for the host vote. On a
        CUDA device each handle carries "done", an event recorded after
        this work, which its readback waits for."""
        with torch.inference_mode(), self.stages("vote"):
            keep = scores > thresh      # the strict > of lib/test.py:163
            if self.device_vote:
                dets, n = top_rows(boxes, scores, keep, self.vote_cap)
                vote = (nms_device.bbox_vote_device
                        if cfg.TEST.NMS_METHOD == "BBOX_VOTE"
                        else nms_device.nms_device)
                out, n_out = vote(dets, n, float(cfg.TEST.NMS_THRESH))
                handles = [{"packed": o, "n": c, "voted": True}
                           for o, c in zip(out, n_out)]
            elif self.merged_cap > 0:
                dets, n = top_rows(boxes, scores, keep, self.merged_cap)
                handles = [{"packed": d, "n": c, "voted": False}
                           for d, c in zip(dets, n)]
            else:
                rows = torch.cat([boxes, scores[..., None]], dim=-1)
                handles = [{"packed": r, "keep": k, "voted": False}
                           for r, k in zip(rows, keep)]
            if boxes.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(boxes.device))
                for h in handles:
                    h["done"] = done
            return handles

    def detect_async(self, im, thresh=0.05, score_thresh=None):
        """Enqueue one image's pyramid at its exact ×16 level shapes and,
        under the device vote, its vote on the device. ``thresh`` is the
        detect-level cut (probs > thresh). Returns a handle for
        ``finalize_async``; nothing waits for the device here."""
        with torch.inference_mode():
            with self.stages("prep"):
                prep = self._prep(im)
            boxes, scores = self._pyramid([prep], False, score_thresh)
        return self._dispatch(boxes, scores, thresh)[0]

    def finalize_async(self, handle, thresh=0.05):
        """Copy one image's rows to the host: the voted rows under the
        device vote (with the reference's dummy row when there are none),
        else the kept rows, voted on the host in float64. Returns cls_dets
        like ``detect``. (``thresh`` was applied in ``detect_async``.)"""
        with self.stages("readback"), _after(handle):
            # the row count, or the boolean mask's, then the rows: each
            # waits for the device
            if "keep" in handle:
                with self.stages("wait_readback"):
                    rows = handle["packed"][handle["keep"]]
            else:
                with self.stages("wait_readback"):
                    n = int(handle["n"])
                rows = handle["packed"][:n]
            with self.stages("wait_readback"):
                dets = rows.cpu().numpy()
        if handle["voted"]:
            if cfg.TEST.NMS_METHOD == "BBOX_VOTE" and len(dets) == 0:
                # the reference's dummy detection for an empty input
                # (lib/test.py:183-185)
                dets = np.array([[10, 10, 20, 20, 0.0001]], np.float32)
            return [dets]
        with self.stages("host_vote"):
            return [_host_vote(dets)]

    def detect_many(self, ims, thresh=0.05, score_thresh=None,
                    max_batch=None):
        """Batched detection (JAX ``TPUDetector.detect_many``,
        detect.py:606-680): the images of one ``_prep`` key run as one
        batch through every level, at the key's level buckets
        (``TPU.TEST_BUCKET``), each image with its own resize, extent and
        mirror, and their final votes as one launch. ``max_batch`` (> 0)
        bounds the images of one batch; a key's images are cut into
        batches in input order. Returns one cls_dets per image, in input
        order, each like ``detect``'s and equal to it within float
        rounding (other shapes sum in other orders).

        Under TPU.HOST_PREPROC there is no batched device path: rather
        than run another numeric path than asked, it runs ``detect`` per
        image with a one-time warning, and refuses ``score_thresh``, which
        the host path does not take. A model may refuse it
        (``refuse(cfg, "detect_many")``)."""
        self.arch.refuse(cfg, "detect_many")
        if self.host_preproc:
            if score_thresh is not None:
                raise ValueError(
                    "detect_many(score_thresh=...) is not supported under "
                    "TPU.HOST_PREPROC (the host path applies "
                    "cfg.TEST.SCORE_THRESH)")
            if not self._warned_host_preproc:
                logger.warning(
                    "TPU.HOST_PREPROC is set: detect_many falls back to "
                    "sequential per-image detect() (no batched device "
                    "path on the host-preproc parity path)")
                self._warned_host_preproc = True
            return [self.detect(im, thresh)[0] for im in ims]
        if self.spatial:
            # JAX detect.py:642-644
            raise ValueError("detect_many batches per chip; use one detector "
                             "per chip for spatial sharding")
        with self.stages("prep"):
            preps = [self._prep(im) for im in ims]
        groups = {}
        for i, p in enumerate(preps):
            groups.setdefault(p["key"], []).append(i)
        step = int(max_batch) if max_batch and max_batch > 0 else len(preps)
        pending = []
        for idxs in groups.values():
            for c in range(0, len(idxs), step):
                chunk = idxs[c:c + step]
                with torch.inference_mode():
                    boxes, scores = self._pyramid(
                        [preps[i] for i in chunk], True, score_thresh)
                pending.append((chunk, self._dispatch(boxes, scores,
                                                      thresh)))
        results = [None] * len(preps)
        for chunk, handles in pending:
            for i, handle in zip(chunk, handles):
                results[i] = self.finalize_async(handle, thresh)
        return results

    def forward_scale(self, ims, im_h, im_w, score_thresh=None):
        """Host-preprocessing path: one pyramid level from resized,
        mean-subtracted host images of one (im_h, im_w) (the image and its
        mirror), zero-padded to ×16 and uploaded as float32. Returns numpy
        (boxes (B, cap, 4), scores (B, cap), counts (B,))."""
        h16 = _round_up(im_h, cfg.MAX_RESOLUTION)
        w16 = _round_up(im_w, cfg.MAX_RESOLUTION)
        x = np.zeros((len(ims), h16, w16, 3), np.float32)
        for i, im in enumerate(ims):
            x[i, :im_h, :im_w] = im
        st = float(score_thresh if score_thresh is not None
                   else cfg.TEST.SCORE_THRESH)
        with torch.inference_mode():
            # one JAX forward call over the batch: one dynamic int8 step
            out = self.model(torch.from_numpy(x).to(self.device),
                             precision=self.precision, qstate=self.qstate)
            probs = torch.softmax(out["cls_logits"], dim=-1)[..., 1]
            boxes, scores, counts = decode_mod.decode_proposals_batch(
                probs, out["bbox_deltas"], detector_mod.BASE_ANCHORS,
                feat_stride=detector_mod.FEAT_STRIDE,
                im_h=float(im_h), im_w=float(im_w),
                valid_h=h16 // detector_mod.FEAT_STRIDE,
                valid_w=w16 // detector_mod.FEAT_STRIDE,
                score_thresh=st, min_size=0.0, capacity=self.capacity)
        return boxes.cpu().numpy(), scores.cpu().numpy(), counts.cpu().numpy()

    def _detect_host_preproc(self, im, thresh):
        """JAX ``detect.py:733-785``: cv2 INTER_LINEAR resize of the
        mean-subtracted image per level on the host, the mirror as a second
        batch item, merge in float64, the cut and the float64 host vote."""
        import cv2      # the host resize of the parity path
        all_boxes, all_scores = [], []
        im_f = im.astype(np.float32) - np.asarray(cfg.PIXEL_MEANS,
                                                  np.float32)
        for scale in _pyramid_scales(im.shape):
            resized = im_f if scale == 1.0 else cv2.resize(
                im_f, None, None, fx=scale, fy=scale,
                interpolation=cv2.INTER_LINEAR)
            h, w = resized.shape[:2]
            ims = [resized]
            if cfg.TEST.FLIP:
                ims.append(resized[:, ::-1])
            boxes, scores, counts = self.forward_scale(ims, h, w)
            for i in range(boxes.shape[0]):
                bx = boxes[i, :int(counts[i])].astype(np.float64)
                if i == 1:      # mirrored: flip x in network-input space
                    bx[:, 0], bx[:, 2] = w - bx[:, 2], w - bx[:, 0]
                all_boxes.append(bx / scale)
                all_scores.append(scores[i, :int(counts[i])].astype(
                    np.float64))
        probs = np.concatenate(all_scores)
        boxes = np.concatenate(all_boxes)
        inds = np.where(probs > thresh)[0]
        dets = np.hstack((boxes[inds], probs[inds, None])).astype(np.float32)
        return [_host_vote(dets)]

    def detect(self, im, thresh=0.05, timers=None):
        """Full-pyramid detection on one BGR uint8 image (or path).
        Returns ([(N, 5) x1, y1, x2, y2, score], timers): one array for
        the single 'face' class, like the JAX ``TPUDetector.detect``."""
        if timers is None:
            timers = {"detect": Timer(), "misc": Timer()}
        if self.host_preproc:
            if isinstance(im, str):
                im = _imread(im)
            timers["detect"].tic()
            cls_dets = self._detect_host_preproc(im, thresh)
            timers["detect"].toc()
            return cls_dets, timers
        timers["detect"].tic()
        handle = self.detect_async(im, thresh)
        timers["detect"].toc()
        timers["misc"].tic()
        cls_dets = self.finalize_async(handle, thresh)
        timers["misc"].toc()
        return cls_dets, timers


def top_rows(boxes, scores, keep, cap):
    """The top min(cap, total) rows (k, 5) by score among the kept ones,
    in descending score order with the lower index first among ties (as
    ``lax.top_k`` orders them), and how many of them are kept (0-d int32,
    on the device). With a leading image axis (boxes (N, R, 4), scores and
    keep (N, R)), per image: (N, k, 5) and (N,)."""
    sortable = torch.where(keep, scores, -torch.inf)
    k = min(cap, sortable.shape[-1])
    top, idx = torch.sort(sortable, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    picked = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    dets = torch.cat([picked, top[..., None]], dim=-1).contiguous()
    n = keep.sum(-1).clamp(max=k).to(torch.int32)
    return dets, n


def _image_rows(boxes, scores, counts, w_s, inv_fx, n, reps):
    """A model's ``decode_level`` rows of N images (boxes (N·F, cap, 4) in
    network-input coordinates, scores, counts, and each image's w_s and
    inv_fx, tensors or numbers) in original-image coordinates: boxes
    (N, F·cap, 4) and scores (N, F·cap), the mirror's boxes flipped back
    about w_s, all scaled by inv_fx, -inf past each count."""
    cap = boxes.shape[1]
    boxes = boxes.view(n, reps, cap, 4)
    row_ok = torch.arange(cap, device=boxes.device) < counts.view(n, reps, 1)
    if reps == 2:
        m = boxes[:, 1]
        flipped = torch.stack([w_s - m[..., 2], m[..., 1],
                               w_s - m[..., 0], m[..., 3]], dim=-1)
        boxes = torch.stack([boxes[:, 0], flipped], dim=1)
    boxes = boxes * inv_fx
    scores = torch.where(row_ok, scores.view(n, reps, cap), -float("inf"))
    return boxes.reshape(n, -1, 4), scores.reshape(n, -1)


def _after(handle):
    """Where ``handle`` carries its "done" event (``_dispatch``): a pool
    stream that waits for that event alone, made current, so that the
    readback's copies synchronise with this image's work and not with the
    images queued after it, which run on meanwhile. Else nothing."""
    if "done" not in handle:
        return contextlib.nullcontext()
    stream = torch.cuda.Stream(handle["packed"].device)
    stream.wait_event(handle["done"])
    return torch.cuda.stream(stream)


def _indexed(device):
    """``device`` resolved, a CUDA device with its index (the current
    card's when it names none)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _pad_to(im, H, W):
    """The raw image edge-padded to (H, W)."""
    h0, w0 = im.shape[:2]
    return np.pad(im, ((0, H - h0), (0, W - w0), (0, 0)), mode="edge")


def _host_vote(dets):
    """The reference's float64 host BBOX_VOTE or NMS over (N, 5) rows."""
    if cfg.TEST.NMS_METHOD == "BBOX_VOTE":
        return nms_host.bbox_vote(dets, cfg.TEST.NMS_THRESH)
    if cfg.TEST.NMS_METHOD == "NMS":
        return dets[nms_host.nms(dets, cfg.TEST.NMS_THRESH), :]
    raise NotImplementedError(f"Unknown NMS method: {cfg.TEST.NMS_METHOD}")
