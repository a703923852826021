"""Training on one device, or data-parallel over W processes.

Counterpart of ``smallhardface_tpu/train/train_loop.py``: ``BUCKET``,
``_snap``, ``_snap_gt``, ``_batch_dims`` and ``assemble_batch``
(:417-493), ``preprocess_image`` (:97-114), the loss of ``_make_loss_fn``
(:138-181), the step of ``make_train_step`` (:186-242),
``get_training_roidb`` (:75-95) and ``train_net`` (:514), with the mesh
replaced by one process per card (``parallel.dist``):

- each iteration takes ``TRAIN.ITERSIZE`` images on each rank from that
  rank's loader at one scale of a sequence drawn from
  ``RandomState(RNG_SEED)``, pads them to a bucket shared by every rank,
  and uploads the uint8 originals;
- per image: the fused resize + crop + mean subtraction on the device, the
  forward in the ``"where"`` mask mode, anchor targets with OHEM on the
  detached background probability (the JAX ``stop_gradient``), and the
  softmax and smooth-L1 losses; ``backward`` accumulates the gradients;
- the summed gradients are summed over the ranks (one all-reduce, the JAX
  ``psum``), divided by W × iter_size once, and the solver steps in place;
  the easy-image flags go back to the rank's loader and the losses are
  logged one iteration later, after the next batch is fetched, as in the
  JAX loop (at once on a snapshot iteration);
- snapshots ``{prefix}_iter_{k}.npz`` and ``final.npz``, written by rank 0
  alone, carry the weights (HWIO, the JAX package's layout, so either
  package loads them), the optimizer slots, the iteration and the pickled
  sampler states of every rank in rank order; ``TRAIN.RESUME`` restores
  all of them, so a resumed run at the same world size replays the same
  data stream and reaches the same weights to the bit;
  ``final.caffemodel`` is written beside ``final.npz``, and a
  ``.caffemodel`` pretrained model is loaded by layer name;
- SIGINT writes a snapshot and stops, SIGHUP writes a snapshot at the next
  iteration (the Caffe solver's signal actions, JAX train_loop.py:779-805);
  over W ranks the flags ride the all-gather of the bucket extents, so a
  signal delivered to one rank acts on every rank at the same iteration;
  ``SHF_FAULT_ITER=K`` makes a run from scratch raise an injected sticky
  CUDA fault at iteration K, which the command line's
  ``TRAIN.AUTO_RESUME`` relaunch recovers from.

A prefetch thread builds the next iteration's batch while the device runs
the current one, as the JAX loop's does (its train_loop.py:808-922): it
draws the iteration's samples in order (``RoIDataLoader.plan_minibatch``),
renders their pixels on a pool of ``TRAIN.ITERSIZE`` threads
(``loader.render_minibatch``) and, in one process, returns the padded
batch in host memory (pinned on a CUDA device), which the main thread
copies to the device without blocking at the start of the step. Over W
ranks it returns the rendered samples, and the main thread agrees on the
bucket with the other ranks before it pads and pins them: no collective is
issued from a worker thread. The easy-image marks reach the loader in one
fixed order whatever the threads' timing (see ``train_net``), so the data
stream, the weights and a resume stay equal to the bit to the serial
order. Training runs in float32: int8 has no gradient, and the JAX
package's bf16 gradient fails (see ``train_net``).

Under ``TPU.SPATIAL_DEVICES`` = k > 1 each process trains over a spatial
unit of k devices (``parallel.spatial``): every micro-batch is
preprocessed on the unit's first device, its rows are split over the unit
and the forward and backward run shard by shard (the stem as K4), the
head outputs are gathered and cropped to the bucket, and the targets and
OHEM run on the whole image, as the JAX ``make_train_step_spatial``
(train_loop.py:245-308); W such processes under a launcher are its
``make_train_step_grouped`` (:311-403) with G = W groups, one process a
group.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import hashlib
import json
import logging
import math
import os
import os.path as osp
import pickle
import signal
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.detect import linear_resize_weights
from smallhardface_tpu_torch.io import caffemodel, checkpoint, weights
from smallhardface_tpu_torch.models import detector as detector_mod
from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.ops import iou as iou_mod
from smallhardface_tpu_torch.ops import stem as stem_mod
from smallhardface_tpu_torch.parallel import dist as pdist
from smallhardface_tpu_torch.parallel import spatial
from smallhardface_tpu_torch.train import solver as solver_mod
from smallhardface_tpu_torch.train import targets as targets_mod
from smallhardface_tpu_torch.train.loader import (
    RoIDataLoader, render_minibatch)
from smallhardface_tpu_torch.train.losses import (
    smooth_l1, softmax_ce_with_ignore)
from smallhardface_tpu_torch.utils.device import resolve_device
from smallhardface_tpu_torch.utils.faults import injected_fault
from smallhardface_tpu_torch.utils.tensorboard import tb
from smallhardface_tpu_torch.utils.timer import Timer, device_busy_s, no_stages

logger = logging.getLogger(__name__)

BUCKET = 128  # spatial padding granularity of the training buckets
METRIC_KEYS = ("cls_loss", "reg_loss", "accuracy", "easy", "n_fg")


def _snap(v, bucket):
    return int(math.ceil(max(v, 1) / bucket) * bucket)


def _snap_gt(g, buckets):
    for b in buckets:
        if g <= b:
            return b
    return buckets[-1]


def _batch_dims(samples):
    """Raw (pre-snap) max extents of a sample list, the quantities the
    bucket shapes derive from."""
    return np.array([
        max(s["height"] for s in samples),
        max(s["width"] for s in samples),
        max(s["data"].shape[0] for s in samples),
        max(s["data"].shape[1] for s in samples),
        max(max(s["gt_boxes"].shape[0] for s in samples), 1),
    ], np.int64)


def assemble_batch(samples, iter_size, gt_buckets, raw_dims=None):
    """Pad the loader samples of one iteration to shared bucket shapes.
    ``data`` carries the distorted uint8 ORIGINALS, edge-padded so that the
    device resize clamps at image borders like cv2; resize and crop happen
    on the device via (scale, crop). ``raw_dims`` overrides the samples'
    own ``_batch_dims`` (over W ranks: their maximum over every rank).
    Returns (arrays dict with a leading iter_size axis, im_idx list,
    bucket key (h0b, w0b, hb, wb, gb))."""
    if raw_dims is None:
        raw_dims = _batch_dims(samples)
    hmax, wmax, h0max, w0max, gmax = (int(v) for v in raw_dims)
    hb = _snap(_snap(hmax, cfg.MAX_RESOLUTION), BUCKET)
    wb = _snap(_snap(wmax, cfg.MAX_RESOLUTION), BUCKET)
    h0b, w0b = _snap(h0max, BUCKET), _snap(w0max, BUCKET)
    gb = _snap_gt(gmax, gt_buckets)

    data = np.zeros((iter_size, h0b, w0b, 3), np.uint8)
    scale = np.ones((iter_size,), np.float32)
    crop = np.zeros((iter_size, 2), np.float32)
    gt = np.zeros((iter_size, gb, 5), np.float32)
    gt_mask = np.zeros((iter_size, gb), bool)
    im_hw = np.zeros((iter_size, 2), np.float32)
    valid_hw = np.zeros((iter_size, 2), np.int32)
    im_idx = []
    for i, s in enumerate(samples):
        h0, w0 = s["data"].shape[:2]
        data[i] = np.pad(s["data"], ((0, h0b - h0), (0, w0b - w0), (0, 0)),
                         mode="edge")
        scale[i] = s["im_scale"]
        crop[i] = s["crop"]
        g = min(s["gt_boxes"].shape[0], gb)
        if s["gt_boxes"].shape[0] > gb:
            logger.warning("Truncating %d gt boxes to bucket %d",
                           s["gt_boxes"].shape[0], gb)
        gt[i, :g] = s["gt_boxes"][:g]
        gt_mask[i, :g] = True
        im_hw[i] = (s["height"], s["width"])
        valid_hw[i] = (
            _snap(s["height"], cfg.MAX_RESOLUTION) // detector_mod.FEAT_STRIDE,
            _snap(s["width"], cfg.MAX_RESOLUTION) // detector_mod.FEAT_STRIDE)
        im_idx.append(s["im_idx"])
    return ({"data": data, "scale": scale, "crop": crop, "gt": gt,
             "gt_mask": gt_mask, "im_hw": im_hw, "valid_hw": valid_hw},
            im_idx, (h0b, w0b, hb, wb, gb))


def preprocess_image(data, scl, crp, im_hw, out_shape, pixel_mean,
                     wait=contextlib.nullcontext):
    """The fused training preprocess on the device. data: (h0b, w0b, 3)
    uint8, the distorted ORIGINAL (edge-padded). The resize to the
    training scale and the crop are one separable linear resample
    (``jax.image.scale_and_translate`` with translation = −crop, cv2's
    fx-sampling convention); then the mean is subtracted and everything
    beyond the final (im_h, im_w) extent is zero (minibatch.py:47-53).
    scl, crp (hs, ws), im_hw: host numbers. Returns (hb, wb, 3) float32.
    ``wait()``: the span around each copy that waits for the device."""
    hb, wb = out_shape
    h0b, w0b, _ = data.shape
    dev = data.device
    wy = linear_resize_weights(h0b, hb, scl, dev, translation=-crp[0],
                               wait=wait)
    wx = linear_resize_weights(w0b, wb, scl, dev, translation=-crp[1],
                               wait=wait)
    img = data.float()
    t = (wy.T @ img.reshape(h0b, w0b * 3)).reshape(hb, w0b, 3)
    resized = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1)
    rows = torch.arange(hb, device=dev) < im_hw[0]
    cols = torch.arange(wb, device=dev) < im_hw[1]
    inside = (rows[:, None] & cols[None, :])[..., None]
    return torch.where(inside, resized - pixel_mean, 0.0)


class LossFn:
    """One micro-batch's loss (the loss of ``_make_loss_fn``), on one device
    or over a spatial ``unit`` of devices (``_make_loss_fn(spatial_mesh=…)``,
    train_loop.py:117-183): the input is preprocessed on the unit's first
    device (``device``), split over the unit by ``spatial.shard_input``,
    and the gathered head outputs are cropped to the bucket's rows before
    the targets. ``unit`` None is ``[device]``: one shard, no padding."""

    def __init__(self, tc, device, unit=None, stages=no_stages):
        self.tc = tc
        # the stage hook (tools/train_time): preproc, forward, targets, and
        # "wait_<stage>" inside them around each call that waits for the
        # device
        self.stages = stages
        self.unit = list(unit or [device])
        self.base_anchors = anchors_mod.generate_anchors(
            base_size=16, ratios=[1],
            scales=list(detector_mod.ANCHOR_SCALES), shifts=[0],
            strides=[detector_mod.FEAT_STRIDE] * 3)
        self.pixel_mean = torch.tensor(
            np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(1, 1, 3),
            device=device)

    def __call__(self, model, out_shape, data, scl, crp, gt, gt_mask, im_hw,
                 valid_hw):
        """data, gt, gt_mask: device tensors; scl, crp, im_hw, valid_hw:
        host numbers. Returns (cls_loss + reg_loss, aux dict of 0-dim
        tensors)."""
        stride = detector_mod.FEAT_STRIDE
        with self.stages("preproc"):
            x = preprocess_image(
                data, scl, crp, im_hw, out_shape, self.pixel_mean,
                wait=functools.partial(self.stages, "wait_preproc"))
        extent = (int(valid_hw[0]) * stride, int(valid_hw[1]) * stride)
        with self.stages("forward"):
            # the rows padded to a multiple of 32·k are cropped off the
            # outputs: the anchor grid and OHEM's tie order are the bucket's
            shards, _ = spatial.shard_input(x[None], self.unit, extent)
            out = model(shards, valid_hw=extent)
            rows = out_shape[0] // stride
            logits = out["cls_logits"][0, :rows]
            deltas = out["bbox_deltas"][0, :rows]
        with self.stages("targets"):
            bg_prob = torch.softmax(logits.detach(), dim=-1)[..., 0]
            tgt = targets_mod.anchor_targets(
                bg_prob, self.base_anchors, gt, gt_mask,
                im_h=float(im_hw[0]), im_w=float(im_hw[1]),
                valid_h=int(valid_hw[0]), valid_w=int(valid_hw[1]),
                tc=self.tc,
                wait=functools.partial(self.stages, "wait_targets"))
            cls_loss = softmax_ce_with_ignore(logits.reshape(-1, 2),
                                              tgt["labels"])
            reg_loss = smooth_l1(deltas.reshape(-1, 4), tgt["bbox_targets"],
                                 tgt["inside_weights"],
                                 tgt["outside_weights"])
        aux = {"cls_loss": cls_loss, "reg_loss": reg_loss,
               "accuracy": tgt["accuracy"], "easy": tgt["easy"],
               "n_fg": tgt["n_fg"]}
        return cls_loss + reg_loss, aux


def grad_step(model, loss_fn, batch, out_shape, iter_size, reduce=None,
              stages=no_stages):
    """Forward and backward of every micro-batch of one iteration; the
    parameters' ``.grad`` ends as the mean over micro-batches and ranks:
    the sum over micro-batches (``backward`` accumulates), then
    ``reduce(grads)``, which sums the gradients over the W ranks in place
    and returns W (None: one process), then one division by
    W × iter_size, as the JAX step's ``psum`` and division
    (train_loop.py:219-224). Only the leaves that take a gradient, those
    with a learning-rate multiplier above 0, are reduced. Returns the
    metrics as a (len(METRIC_KEYS), iter_size) float32 device tensor.
    ``stages``: the stage hook around each backward and the reduction
    (tools/train_time)."""
    for p in model.parameters():
        p.grad = None
    rows = []
    for i in range(iter_size):
        loss, aux = loss_fn(
            model, out_shape, batch["data"][i], float(batch["scale"][i]),
            batch["crop"][i].tolist(), batch["gt"][i], batch["gt_mask"][i],
            batch["im_hw"][i].tolist(), batch["valid_hw"][i].tolist())
        with stages("backward"):
            loss.backward()
        rows.append(torch.stack([aux[k].detach().float()
                                 for k in METRIC_KEYS]))
    with stages("reduce"):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        n_ranks = 1 if reduce is None else reduce(grads)
        for g in grads:
            g.div_(n_ranks * iter_size)
        return torch.stack(rows, dim=1)


def get_training_roidb(imdb):
    """Flip-augment, prepare and filter the roidb
    (reference lib/train.py:181-227)."""
    if cfg.TRAIN.USE_FLIPPED:
        logger.info("Appending horizontally-flipped training examples...")
        imdb.append_flipped_images()
        logger.info("done")
    logger.info("Preparing training data...")
    imdb.prepare_roidb()

    def is_valid(entry):
        overlaps = entry["max_overlaps"]
        fg = np.where(overlaps >= cfg.TRAIN.ANCHOR_POSITIVE_OVERLAP)[0]
        bg = np.where((overlaps < cfg.TRAIN.BG_THRESH_HI) &
                      (overlaps >= cfg.TRAIN.BG_THRESH_LOW))[0]
        return len(fg) > 0 or len(bg) > 0

    final = [e for e in imdb.roidb if is_valid(e)]
    logger.info("done")
    return final


def _init_params(spec, pretrained_model):
    params = detector_mod.init_params(
        torch.Generator().manual_seed(int(cfg.RNG_SEED)), spec)
    if pretrained_model and osp.exists(str(pretrained_model)):
        logger.info("Loading pretrained model weights from %s",
                    pretrained_model)
        if str(pretrained_model).endswith(".caffemodel"):
            # by layer name, unmatched parameters keep their init (JAX
            # train_loop.py:495-511): the ImageNet VGG-16 path
            return caffemodel.load_into_params(str(pretrained_model), params)
        loaded = weights.load_params(str(pretrained_model))
        for name in params:
            if name in loaded:
                params[name] = loaded[name]
            else:
                logger.warning("Checkpoint missing param %s; keeping init",
                               name)
    elif pretrained_model:
        logger.warning("Pretrained model %s not found; training from "
                       "random init", pretrained_model)
    return params


def _save(path, model, opt_state, iteration, extra):
    """A snapshot in the JAX package's layout (HWIO weights and slots)."""
    checkpoint.save(path, weights.params_to_numpy(model.tree()),
                    {slot: weights.params_to_numpy(tree)
                     for slot, tree in opt_state.items()},
                    iteration, extra=extra)


def _save_final(output_dir, model, opt_state, iteration, extra):
    """final.npz and, beside it, final.caffemodel (JAX
    train_loop.py:624-632, :944-952)."""
    _save(osp.join(output_dir, "final.npz"), model, opt_state, iteration,
          extra)
    caffemodel.export_params(osp.join(output_dir, "final.caffemodel"),
                             model.tree())


def _resume(model, opt_state, solver_type):
    """Load TRAIN.RESUME into the model and the optimizer state (in place);
    returns (start_iter, extra)."""
    params, loaded, start_iter, extra = checkpoint.load(cfg.TRAIN.RESUME)
    with torch.no_grad():
        for name, leaf in weights.params_from_numpy(params).items():
            for k, v in leaf.items():
                model.params[name][k].copy_(v)
    if loaded is not None:
        if "h1" not in loaded:                    # pre-family checkpoints
            loaded = {"h1": loaded}
        if "h2" in opt_state and "h2" not in loaded:
            logger.warning("Checkpoint has one optimizer slot but %s needs "
                           "two; h2 starts from zeros", solver_type)
        if "h2" not in opt_state and "h2" in loaded:
            logger.warning("Dropping checkpoint's second optimizer slot for "
                           "%s", solver_type)
        with torch.no_grad():
            for slot, tree in loaded.items():
                if slot not in opt_state:
                    continue
                for name, leaf in weights.params_from_numpy(tree).items():
                    for k, v in leaf.items():
                        opt_state[slot][name][k].copy_(v)
    logger.info("Resumed from %s at iter %d", cfg.TRAIN.RESUME, start_iter)
    return start_iter, extra


PROFILE_ENV = "SHF_TRAIN_PROFILE"


def _weights_digest(model):
    """sha256 of the weights, leaf by leaf in name order."""
    digest = hashlib.sha256()
    for name, leaf in sorted(model.tree().items()):
        for k in sorted(leaf):
            digest.update(leaf[k].detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _check_world(world):
    """TPU.NUM_DEVICES: -1 takes the world size; any other value must equal
    it (one process per card: the port cannot clamp as make_mesh does).
    Spatial training does not read it (JAX train_loop.py:527-546)."""
    n_devices = int(cfg.TPU.NUM_DEVICES)
    if n_devices > 0 and n_devices != world:
        raise ValueError(
            f"TPU.NUM_DEVICES={n_devices} but this run has {world} rank(s): "
            "the port trains with one process per card, so launch that many "
            "ranks (torchrun --nproc_per_node) or set TPU.NUM_DEVICES = -1")


def _train_unit(device, k):
    """The devices this process trains over, the first holding the
    weights: [device] for k = 1; under a launcher the LOCAL_RANK-th unit of
    k local devices (``spatial.unit``, ValueError when there is none: the
    JAX group mesh, one process a group); else the first k local devices,
    clamped with JAX's warning where there are fewer (``make_mesh``,
    mesh.py:60-70, which ``make_spatial_mesh`` calls)."""
    if k <= 1:
        return [device]
    if pdist.active():
        return spatial.unit(device, k, pdist.local_rank())
    local = spatial.local_devices(device)
    if k > len(local):
        logger.warning("Requested %d devices but only %d available (%s "
                       "backend); using %d", k, len(local), device.type,
                       len(local))
    return local[:k]


def train_net(roidb, output_dir, pretrained_model, max_iter, device=None,
              progress_hook=None):
    """Train the detector on one device, the CUDA card when ``device`` is
    None (raises when there is none). Under a launcher (torchrun) the
    process first joins the process group (``parallel.dist
    .init_distributed``) and trains as one of W ranks on its own card;
    rank 0 alone writes. With ``TPU.SPATIAL_DEVICES`` = k > 1 each rank
    trains over a spatial unit of k devices instead (``_train_unit``), and
    ``device`` may also be a list of devices, the unit itself (such as
    ``["cuda:0"] * 2``: one card running the shards one after another).
    Snapshots and final weights land in ``output_dir``.
    ``progress_hook(it, metrics)`` is called after every
    iteration with this rank's (1, iter_size) float32 arrays under
    METRIC_KEYS ("easy" as bool) and the iteration's bucket under
    "bucket". Returns the trained ``Detector``. On the main thread SIGINT
    and SIGHUP act as in the module docstring; the previous handlers are
    back, and the prefetch and render threads have ended, when it returns
    or raises. An error in the prefetch thread is raised here as the same
    object. With ``SHF_TRAIN_PROFILE=1`` on a card the iterations run
    under torch.profiler (device activity only), and the summary logged at
    the end (always logged over W ranks) carries the device's busy time."""
    if str(cfg.MODEL.ARCH) != "smallhardface":
        # RetinaFace's multibox and landmark loss is not ported (PERF.md §7)
        raise NotImplementedError(
            f"MODEL.ARCH={cfg.MODEL.ARCH!r} runs detection only; training "
            "is the smallhardface detector's")
    if isinstance(device, (list, tuple)):
        unit = [resolve_device(d) for d in device]
        pdist.init_distributed(unit[0])
        k = len(unit)
    else:
        k = int(cfg.TPU.SPATIAL_DEVICES)
        unit = _train_unit(pdist.init_distributed(device, spatial=k), k)
    device = unit[0]
    world, rank = pdist.world(), pdist.rank()
    dp = pdist.active()
    if len(unit) > 1:
        logger.info("Training over a spatial unit of %d devices: %s",
                    len(unit), ", ".join(map(str, unit)))
    precision = str(cfg.TPU.PRECISION)
    if precision == "int8":
        raise ValueError(
            "TPU.PRECISION='int8' is inference-only (dynamic rounding "
            "has no gradient); train with 'float32'")
    if precision != "float32":
        raise NotImplementedError(
            f"TPU.PRECISION={precision!r}: the port trains in float32 only. "
            "The JAX reference's own bfloat16 gradient fails: jax.grad "
            "through its bf16 convolution raises TypeError "
            "(lax.conv_general_dilated requires arguments to have the same "
            "dtypes, got bfloat16, float32), so a bf16 training step has "
            "nothing to be held against; bf16 runs in inference")
    if k <= 1:
        _check_world(world)
    spec = detector_mod.build_spec(cfg)
    tc = targets_mod.from_cfg(cfg)
    iter_size = int(cfg.TRAIN.ITERSIZE)
    gt_buckets = list(cfg.TPU.MAX_GT_BUCKETS)
    solver_type = str(cfg.TRAIN.SOLVER_TYPE)
    lr_mults, decay_mults = detector_mod.param_multipliers(spec)

    model = detector_mod.Detector(_init_params(spec, pretrained_model), spec,
                                  device, trainable=True)
    params = model.tree()
    opt_state = solver_mod.init_state(
        {n: {k: v.detach() for k, v in leaf.items()}
         for n, leaf in params.items()}, solver_type)
    start_iter, resume_extra = 0, {}
    if cfg.TRAIN.RESUME:
        start_iter, resume_extra = _resume(model, opt_state, solver_type)

    if start_iter >= max_iter:
        logger.warning("Resume iteration %d >= max_iter %d: writing final "
                       "weights without training", start_iter, max_iter)
        if rank == 0:
            _save_final(output_dir, model, opt_state, start_iter,
                        resume_extra)
        pdist.barrier()
        return model

    # test-only fault injection: SHF_FAULT_ITER=K makes a run from scratch
    # raise a sticky device fault at iteration K (a resumed run is immune,
    # so the relaunch completes): tests/test_torch_port_auto_resume.py
    fault_iter = int(os.environ.get("SHF_FAULT_ITER", "0") or 0)
    # one loader per rank, seeded by the rank: rank r draws what device r
    # of a JAX mesh of W devices draws
    loader = RoIDataLoader(roidb, rank=rank)
    if resume_extra.get("loader_state") is not None:
        states = pickle.loads(
            np.asarray(resume_extra["loader_state"]).tobytes())
        if len(states) == world:
            loader.load_state_dict(states[rank])
            logger.info("Restored sampler state for %d ranks", world)
        else:
            # as JAX (train_loop.py:706-716): weights, slots and iteration
            # are restored, the samplers are not
            logger.warning("Checkpoint sampler state has %d ranks but this "
                           "run has %d; samplers restart fresh",
                           len(states), world)
    host_rng = np.random.RandomState(int(cfg.RNG_SEED))
    num_scales = len(cfg.TRAIN.SCALES.SHORT_SIDE)
    scale_seq = host_rng.randint(0, num_scales, size=max_iter)

    pin = device.type == "cuda"

    def to_host_tensors(assembled):
        """The padded batch's device-bound arrays as host tensors, pinned
        for a CUDA device."""
        arrays, im_idx, bucket = assembled
        for k in ("data", "gt", "gt_mask"):
            arrays[k] = torch.from_numpy(arrays[k])
            if pin:
                arrays[k] = arrays[k].pin_memory()
        return arrays, im_idx, bucket

    def build_batch(it, marks):
        """Batch ``it``, on the prefetch thread: the easy-image marks it was
        handed, then every draw of the iteration in order, then the pixels
        of its images in parallel. In one process it also pads them and
        returns host tensors; over W ranks it returns the rendered samples,
        which ``finish_batch`` pads on the main thread."""
        for idx in marks:
            loader.mark_easy(idx)
        plans = [loader.plan_minibatch(int(scale_seq[it]))
                 for _ in range(iter_size)]
        renders = [renderers.submit(render_minibatch, p) for p in plans]
        samples = [r.result() for r in renders]
        if dp:
            return samples
        return to_host_tensors(assemble_batch(samples, iter_size,
                                              gt_buckets))

    # Signal actions, polled once per iteration like the Caffe solver loop
    # (JAX train_loop.py:779-805): SIGINT → snapshot and stop, SIGHUP →
    # snapshot. The handler only sets a flag in ``actions``; a signal that
    # lands during a blocking CUDA call is handled when the call returns.
    # Over W ranks the loop acts on ``agreed``, the maximum of every rank's
    # flags: a rank acting alone would leave the others waiting in their
    # next collective.
    actions = {"stop": False, "snapshot": False}
    agreed = {"stop": False, "snapshot": False}

    def finish_batch(got):
        """On the main thread, over W ranks: one all-gather agrees on the
        bucket (the maximum of every rank's ``_batch_dims``) and carries
        the signal flags (JAX finish_batch, train_loop.py:751-775), then
        the samples are padded and pinned. In one process ``got`` is done
        already."""
        if not dp:
            return got
        # pop reads and clears the local snapshot flag in one step against
        # the handler; once gathered it reaches every rank
        snap = bool(actions.pop("snapshot", False))
        gathered = pdist.allgather_max(np.concatenate([
            _batch_dims(got),
            np.array([int(actions["stop"]), int(snap)], np.int64)]))
        if gathered[-2]:
            agreed["stop"] = True
        agreed["snapshot"] = bool(gathered[-1])
        return to_host_tensors(assemble_batch(got, iter_size, gt_buckets,
                                              raw_dims=gathered[:-2]))

    pending_marks = []      # easy-image marks not yet handed to the loader

    def fetch(it):
        """Start batch ``it`` on the prefetch thread with the marks
        collected since the last fetch."""
        marks = list(pending_marks)
        pending_marks.clear()
        return prefetch.submit(build_batch, it, marks)

    snapshot_prefix = (cfg.NAME if cfg.TRAIN.SNAPSHOT_INFIX == ""
                       else f"{cfg.NAME}_{cfg.TRAIN.SNAPSHOT_INFIX}")
    loss_fn = LossFn(tc, device, unit)
    loss_window = deque(maxlen=100)   # the solver's average_loss display
    t = Timer()

    def process_metrics(rec):
        """Read one step's metrics back, queue its easy-image marks for the
        loader, log, and call the hook."""
        it1, metrics_dev, m_idx, m_rate, m_bucket = rec
        m = metrics_dev.cpu().numpy()
        metrics = {k: m[j][None] for j, k in enumerate(METRIC_KEYS)}
        metrics["easy"] = metrics["easy"] > 0.5
        if cfg.TRAIN.DISABLE_EASY_IMAGE.ENABLE:
            for k, flag in enumerate(metrics["easy"].reshape(-1)):
                if flag:
                    pending_marks.append(m_idx[k])
        cls_l = float(metrics["cls_loss"].mean())
        reg_l = float(metrics["reg_loss"].mean())
        loss_window.append(cls_l + reg_l)
        if it1 % 20 == 0 or it1 == max_iter or it1 == start_iter + 1:
            acc = float(metrics["accuracy"].mean())
            speed = 1.0 / max(t.average_time, 1e-9)
            eta = int((max_iter - it1) * t.average_time)
            logger.info(
                "iter %d/%d cls_loss: %.5f reg_loss: %.5f smoothed_loss: "
                "%.5f accuracy: %.5f lr: %.2e bucket: %s speed: %.3f iter/s "
                "ETA: %s", it1, max_iter, cls_l, reg_l,
                sum(loss_window) / len(loss_window), acc, m_rate, m_bucket,
                speed, datetime.timedelta(seconds=eta))
            tb.sess.add_scalar_value("cls_loss", cls_l, step=it1)
            tb.sess.add_scalar_value("reg_loss", reg_l, step=it1)
            tb.sess.add_scalar_value("target_layer_accuracy", acc, step=it1)
            tb.sess.add_scalar_value("speed", speed, step=it1)
            tb.sess.add_scalar_value("ETA (min)", eta / 60.0, step=it1)
        if progress_hook is not None:
            metrics["bucket"] = m_bucket
            progress_hook(it1, metrics)

    # the all-reduce of the gradients, timed: CUDA events on a card (read
    # after the loop), the host clock on the CPU
    reduced = {"bytes": 0, "events": [], "walls": []}

    def reduce(grads):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            reduced["bytes"] = pdist.allreduce_sum_(grads)
            end.record()
            reduced["events"].append((start, end))
        else:
            t0 = time.perf_counter()
            reduced["bytes"] = pdist.allreduce_sum_(grads)
            reduced["walls"].append(time.perf_counter() - t0)
        return world

    def on_signal(signum, frame):
        if signum == signal.SIGINT:
            actions["stop"] = True
            logger.warning("SIGINT received: stopping after this iteration "
                           "(snapshot will be written)")
        else:
            actions["snapshot"] = True
            logger.warning("SIGHUP received: snapshot at next iteration")

    prev_handlers = {}
    try:
        for sig in (signal.SIGINT, signal.SIGHUP):
            prev_handlers[sig] = signal.signal(sig, on_signal)
    except ValueError:
        prev_handlers = {}      # not on the main thread
    profile = (device.type == "cuda"
               and os.environ.get(PROFILE_ENV) == "1")
    profiler = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profile
        else contextlib.nullcontext())
    launches0 = (stem_mod.fused_stem.launches, iou_mod.max_iou.launches)
    walls = []
    # the module's ThreadPoolExecutor, which tests replace with an inline
    # stand-in: one prefetch worker, and the iteration's renders at once
    prefetch = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="shf-prefetch")
    renderers = ThreadPoolExecutor(max_workers=iter_size,
                                   thread_name_prefix="shf-render")
    pending = None          # the fetch in flight
    try:
        # The JAX loop's schedule (its train_loop.py:808-922): iteration it
        # starts the fetch of batch it + 1 before it queues its step, and
        # reads step it - 1's metrics back after. The marks of step k go to
        # the fetch of batch k + 3, which applies them before its first
        # draw: the loader sees them after batch k + 2's draws whatever the
        # threads' timing, the order of the serial loop and of the JAX loop
        # when its thread wins the race. A snapshot iteration starts no
        # fetch before its step, so none is in flight when it applies every
        # pending mark, captures the sampler, writes the snapshot, and only
        # then starts the next fetch: a resume replays the same stream.
        # Every collective (the bucket's all-gather, the gradients'
        # all-reduce, the samplers' gather, the barrier after a write) is
        # issued from this thread, in the same order on every rank.
        pending = fetch(start_iter)
        deferred = None
        with profiler:
            for it in range(start_iter, max_iter):
                t.tic()
                fut, pending = pending, None
                host, im_idx, bucket = finish_batch(fut.result())
                it1 = it + 1
                if fault_iter and it1 == fault_iter and start_iter == 0:
                    raise injected_fault("SHF_FAULT_ITER")
                # the snapshot and stop decision up front (JAX :873-880): a
                # signal that lands later in this iteration acts at the
                # next one; pop reads and clears the flag in one step
                # against the handler
                flags = agreed if dp else actions
                will_stop = bool(flags["stop"])
                snap_req = bool(flags.pop("snapshot", False))
                will_snap = (it1 % int(cfg.TRAIN.SNAPSHOT) == 0
                             or it1 == max_iter or snap_req or will_stop)
                if not will_snap:
                    pending = fetch(it1)
                batch = dict(host)
                for k in ("data", "gt", "gt_mask"):
                    batch[k] = host[k].to(device, non_blocking=True)
                rate = solver_mod.learning_rate(it, cfg)
                metrics_dev = grad_step(model, loss_fn, batch, bucket[2:4],
                                        iter_size, reduce if dp else None)
                solver_mod.apply_update(
                    params, {n: {k: v.grad for k, v in leaf.items()}
                             for n, leaf in params.items()},
                    opt_state, solver_type=solver_type, rate=rate,
                    lr_mults=lr_mults, decay_mults=decay_mults,
                    weight_decay=float(cfg.TRAIN.WEIGHT_DECAY),
                    momentum=float(cfg.TRAIN.MOMENTUM), iteration=it)
                if deferred is not None:
                    process_metrics(deferred)
                    deferred = None
                record = (it1, metrics_dev, im_idx, rate, bucket)
                if not will_snap:
                    deferred = record
                    walls.append(t.toc(average=False))
                    continue
                process_metrics(record)
                for idx in pending_marks:
                    loader.mark_easy(idx)
                pending_marks.clear()
                # every rank's sampler, in rank order: the layout of a JAX
                # run over W devices (train_loop.py:929-941)
                states = pdist.allgather_object(loader.state_dict())
                if rank == 0:
                    extra = {"loader_state": np.frombuffer(
                        pickle.dumps(states), dtype=np.uint8)}
                    _save(osp.join(output_dir,
                                   f"{snapshot_prefix}_iter_{it1}.npz"),
                          model, opt_state, it1, extra)
                    if it1 == max_iter:
                        _save_final(output_dir, model, opt_state, it1, extra)
                # no rank goes on before rank 0's files are written
                pdist.barrier()
                if it1 != max_iter and not will_stop:
                    # a stop iteration fetches no next batch
                    pending = fetch(it1)
                walls.append(t.toc(average=False))
                if will_stop:
                    logger.warning("Stopping at iteration %d on signal", it1)
                    break
    finally:
        # no worker outlives the call: a queued fetch is cancelled and the
        # one in flight finishes before this returns or raises (and before
        # the previous signal handlers are back); its error, if any, is
        # logged beside the one that is propagating
        prefetch.shutdown(wait=True, cancel_futures=True)
        renderers.shutdown(wait=True, cancel_futures=True)
        if (pending is not None and not pending.cancelled()
                and pending.exception() is not None):
            logger.error("The batch fetch in flight failed too",
                         exc_info=pending.exception())
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    if dp or profile:
        _log_summary(model, device, world, rank, walls, reduced,
                     (stem_mod.fused_stem.launches - launches0[0],
                      iou_mod.max_iou.launches - launches0[1]),
                     device_busy_s(profiler) if profile else None)
    logger.info("done solving!")
    return model


def _log_summary(model, device, world, rank, walls, reduced, launches,
                 busy_s):
    """One "train summary" log line (JSON) for this rank: its iteration
    walls, the gradients' all-reduce (bytes and ms per iteration), K1's
    and K3's launches, the device's busy seconds under SHF_TRAIN_PROFILE
    and the weights' digest. Over W ranks the digests must agree: every
    rank applies the same all-reduced update."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        reduce_ms = [a.elapsed_time(b) for a, b in reduced["events"]]
    else:
        reduce_ms = [1e3 * w for w in reduced["walls"]]
    digest = _weights_digest(model)
    summary = {
        "rank": rank, "world": world, "backend": pdist.backend(),
        "device": str(device), "iterations": len(walls),
        "iteration_wall_s": walls, "loop_wall_s": sum(walls),
        "allreduce_bytes": reduced["bytes"], "allreduce_ms": reduce_ms,
        "launches": {"fused_stem": launches[0], "max_iou": launches[1]},
        "device_busy_s": busy_s, "weights_sha256": digest}
    logger.info("train summary %s", json.dumps(summary))
    digests = pdist.allgather_object(digest)
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks' weights differ after training: "
                           f"{digests}")
