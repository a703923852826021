"""Training on one device.

Counterpart of the single-device parts of
``smallhardface_tpu/train/train_loop.py``: ``BUCKET``, ``_snap``,
``_snap_gt``, ``_batch_dims`` and ``assemble_batch`` (:417-493),
``preprocess_image`` (:97-114), the loss of ``_make_loss_fn`` (:138-181)
``get_training_roidb`` (:75-95) and ``train_net`` (:514), with the mesh
replaced by one ``device``:

- each iteration takes ``TRAIN.ITERSIZE`` images from the loader at one
  scale of a sequence drawn from ``RandomState(RNG_SEED)``, pads them to a
  shared bucket, and uploads the uint8 originals;
- per image: the fused resize + crop + mean subtraction on the device, the
  forward in the ``"where"`` mask mode, anchor targets with OHEM on the
  detached background probability (the JAX ``stop_gradient``), and the
  softmax and smooth-L1 losses; ``backward`` accumulates the gradients;
- the gradients are divided by iter_size (one device) and the solver steps
  in place; the easy-image flags go back to the loader and the losses are
  logged one iteration later, after the next batch is fetched, as in the
  JAX loop (at once on a snapshot iteration);
- snapshots ``{prefix}_iter_{k}.npz`` and ``final.npz`` carry the weights
  (HWIO, the JAX package's layout, so either package loads them), the
  optimizer slots, the iteration and the pickled loader state;
  ``TRAIN.RESUME`` restores all of them, so a resumed run replays the same
  data stream and reaches the same weights to the bit; ``final.caffemodel``
  is written beside ``final.npz``, and a ``.caffemodel`` pretrained model
  is loaded by layer name;
- SIGINT writes a snapshot and stops, SIGHUP writes a snapshot at the next
  iteration (the Caffe solver's signal actions, JAX train_loop.py:779-805,
  one process); ``SHF_FAULT_ITER=K`` makes a run from scratch raise an
  injected sticky CUDA fault at iteration K, which the command line's
  ``TRAIN.AUTO_RESUME`` relaunch recovers from.

A prefetch thread builds the next iteration's batch while the device runs
the current one, as the JAX loop's does (its train_loop.py:808-922): it
draws the iteration's samples in order (``RoIDataLoader.plan_minibatch``),
renders their pixels on a pool of ``TRAIN.ITERSIZE`` threads
(``loader.render_minibatch``) and returns the padded batch in host memory
(pinned on a CUDA device), which the main thread copies to the device
without blocking at the start of the step. The easy-image marks reach the
loader in one fixed order whatever the threads' timing (see ``train_net``),
so the data stream, the weights and a resume stay equal to the bit to the
serial order. Training runs in float32: int8 has no gradient, and the JAX
package's bf16 gradient fails (see ``train_net``).
Multi-device, spatial and grouped steps are not ported yet (ROADMAP
queue 1).
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import os.path as osp
import pickle
import signal
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.detect import linear_resize_weights
from smallhardface_tpu_torch.io import caffemodel, checkpoint, weights
from smallhardface_tpu_torch.models import detector as detector_mod
from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.train import solver as solver_mod
from smallhardface_tpu_torch.train import targets as targets_mod
from smallhardface_tpu_torch.train.loader import (
    RoIDataLoader, render_minibatch)
from smallhardface_tpu_torch.train.losses import (
    smooth_l1, softmax_ce_with_ignore)
from smallhardface_tpu_torch.utils.device import resolve_device
from smallhardface_tpu_torch.utils.faults import injected_fault
from smallhardface_tpu_torch.utils.tensorboard import tb
from smallhardface_tpu_torch.utils.timer import Timer

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


def assemble_batch(samples, iter_size, gt_buckets):
    """Pad the loader samples of one iteration to shared bucket shapes.
    ``data`` carries the distorted uint8 ORIGINALS, edge-padded so that the
    device resize clamps at image borders like cv2; resize and crop happen
    on the device via (scale, crop). Returns (arrays dict with a leading
    iter_size axis, im_idx list, bucket key (h0b, w0b, hb, wb, gb))."""
    hmax, wmax, h0max, w0max, gmax = (int(v) for v in _batch_dims(samples))
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


def preprocess_image(data, scl, crp, im_hw, out_shape, pixel_mean):
    """The fused training preprocess on the device. data: (h0b, w0b, 3)
    uint8, the distorted ORIGINAL (edge-padded). The resize to the
    training scale and the crop are one separable linear resample
    (``jax.image.scale_and_translate`` with translation = −crop, cv2's
    fx-sampling convention); then the mean is subtracted and everything
    beyond the final (im_h, im_w) extent is zero (minibatch.py:47-53).
    scl, crp (hs, ws), im_hw: host numbers. Returns (hb, wb, 3) float32."""
    hb, wb = out_shape
    h0b, w0b, _ = data.shape
    dev = data.device
    wy = linear_resize_weights(h0b, hb, scl, dev, translation=-crp[0])
    wx = linear_resize_weights(w0b, wb, scl, dev, translation=-crp[1])
    img = data.float()
    t = (wy.T @ img.reshape(h0b, w0b * 3)).reshape(hb, w0b, 3)
    resized = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1)
    rows = torch.arange(hb, device=dev) < im_hw[0]
    cols = torch.arange(wb, device=dev) < im_hw[1]
    inside = (rows[:, None] & cols[None, :])[..., None]
    return torch.where(inside, resized - pixel_mean, 0.0)


class LossFn:
    """One micro-batch's loss (the loss of ``_make_loss_fn``)."""

    def __init__(self, tc, device):
        self.tc = tc
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
        x = preprocess_image(data, scl, crp, im_hw, out_shape,
                             self.pixel_mean)
        out = model(x[None].contiguous(),
                    valid_hw=(int(valid_hw[0]) * stride,
                              int(valid_hw[1]) * stride))
        logits = out["cls_logits"][0]
        deltas = out["bbox_deltas"][0]
        bg_prob = torch.softmax(logits.detach(), dim=-1)[..., 0]
        tgt = targets_mod.anchor_targets(
            bg_prob, self.base_anchors, gt, gt_mask,
            im_h=float(im_hw[0]), im_w=float(im_hw[1]),
            valid_h=int(valid_hw[0]), valid_w=int(valid_hw[1]), tc=self.tc)
        cls_loss = softmax_ce_with_ignore(logits.reshape(-1, 2),
                                          tgt["labels"])
        reg_loss = smooth_l1(deltas.reshape(-1, 4), tgt["bbox_targets"],
                             tgt["inside_weights"], tgt["outside_weights"])
        aux = {"cls_loss": cls_loss, "reg_loss": reg_loss,
               "accuracy": tgt["accuracy"], "easy": tgt["easy"],
               "n_fg": tgt["n_fg"]}
        return cls_loss + reg_loss, aux


def grad_step(model, loss_fn, batch, out_shape, iter_size):
    """Forward and backward of every micro-batch of one iteration; the
    parameters' ``.grad`` ends as the mean over micro-batches. Returns the
    metrics as a (len(METRIC_KEYS), iter_size) float32 device tensor."""
    for p in model.parameters():
        p.grad = None
    rows = []
    for i in range(iter_size):
        loss, aux = loss_fn(
            model, out_shape, batch["data"][i], float(batch["scale"][i]),
            batch["crop"][i].tolist(), batch["gt"][i], batch["gt_mask"][i],
            batch["im_hw"][i].tolist(), batch["valid_hw"][i].tolist())
        loss.backward()
        rows.append(torch.stack([aux[k].detach().float()
                                 for k in METRIC_KEYS]))
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(iter_size)
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


def train_net(roidb, output_dir, pretrained_model, max_iter, device=None,
              progress_hook=None):
    """Train the detector on one device (the CUDA card when ``device`` is
    None; raises when there is none). Snapshots and final weights land in
    ``output_dir``. ``progress_hook(it, metrics)`` is called after every
    iteration with (1, iter_size) float32 arrays under METRIC_KEYS
    ("easy" as bool) and the iteration's bucket under "bucket". Returns
    the trained ``Detector``. On the main thread SIGINT and SIGHUP act
    as in the module docstring; the previous handlers are back, and the
    prefetch and render threads have ended, when it returns or raises.
    An error in the prefetch thread is raised here as the same object."""
    device = resolve_device(device)
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
    if int(cfg.TPU.SPATIAL_DEVICES) > 1:
        raise NotImplementedError(
            "spatial and grouped training are not ported yet (ROADMAP "
            "queue 1, 'Spatial H-sharding with K4')")
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
        _save_final(output_dir, model, opt_state, start_iter, resume_extra)
        return model

    # test-only fault injection: SHF_FAULT_ITER=K makes a run from scratch
    # raise a sticky device fault at iteration K (a resumed run is immune,
    # so the relaunch completes): tests/test_torch_port_auto_resume.py
    fault_iter = int(os.environ.get("SHF_FAULT_ITER", "0") or 0)
    loader = RoIDataLoader(roidb, rank=0)
    if resume_extra.get("loader_state") is not None:
        states = pickle.loads(
            np.asarray(resume_extra["loader_state"]).tobytes())
        if len(states) == 1:
            loader.load_state_dict(states[0])
            logger.info("Restored sampler state")
        else:
            logger.warning("Checkpoint sampler state has %d ranks but this "
                           "run has 1; the sampler restarts fresh",
                           len(states))
    host_rng = np.random.RandomState(int(cfg.RNG_SEED))
    num_scales = len(cfg.TRAIN.SCALES.SHORT_SIDE)
    scale_seq = host_rng.randint(0, num_scales, size=max_iter)

    pin = device.type == "cuda"

    def build_batch(it, marks):
        """Batch ``it``, on the prefetch thread: the easy-image marks it was
        handed, then every draw of the iteration in order, then the pixels
        of its images in parallel and the padding. Returns host tensors,
        pinned for a CUDA device."""
        for idx in marks:
            loader.mark_easy(idx)
        plans = [loader.plan_minibatch(int(scale_seq[it]))
                 for _ in range(iter_size)]
        renders = [renderers.submit(render_minibatch, p) for p in plans]
        arrays, im_idx, bucket = assemble_batch(
            [r.result() for r in renders], iter_size, gt_buckets)
        for k in ("data", "gt", "gt_mask"):
            arrays[k] = torch.from_numpy(arrays[k])
            if pin:
                arrays[k] = arrays[k].pin_memory()
        return arrays, im_idx, bucket

    pending_marks = []      # easy-image marks not yet handed to the loader

    def fetch(it):
        """Start batch ``it`` on the prefetch thread with the marks
        collected since the last fetch."""
        marks = list(pending_marks)
        pending_marks.clear()
        return prefetch.submit(build_batch, it, marks)

    snapshot_prefix = (cfg.NAME if cfg.TRAIN.SNAPSHOT_INFIX == ""
                       else f"{cfg.NAME}_{cfg.TRAIN.SNAPSHOT_INFIX}")
    loss_fn = LossFn(tc, device)
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

    # Signal actions, polled once per iteration like the Caffe solver loop
    # (JAX train_loop.py:779-805): SIGINT → snapshot and stop, SIGHUP →
    # snapshot. The handler only sets a flag; a signal that lands during a
    # blocking CUDA call is handled when the call returns.
    actions = {"stop": False, "snapshot": False}
    prev_handlers = {}

    def on_signal(signum, frame):
        if signum == signal.SIGINT:
            actions["stop"] = True
            logger.warning("SIGINT received: stopping after this iteration "
                           "(snapshot will be written)")
        else:
            actions["snapshot"] = True
            logger.warning("SIGHUP received: snapshot at next iteration")

    try:
        for sig in (signal.SIGINT, signal.SIGHUP):
            prev_handlers[sig] = signal.signal(sig, on_signal)
    except ValueError:
        prev_handlers = {}      # not on the main thread
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
        pending = fetch(start_iter)
        deferred = None
        for it in range(start_iter, max_iter):
            t.tic()
            fut, pending = pending, None
            host, im_idx, bucket = fut.result()
            it1 = it + 1
            if fault_iter and it1 == fault_iter and start_iter == 0:
                raise injected_fault("SHF_FAULT_ITER")
            # the snapshot and stop decision up front (JAX :873-880): a
            # signal that lands later in this iteration acts at the next
            # one; pop reads and clears the flag in one step against the
            # handler
            will_stop = bool(actions["stop"])
            snap_req = bool(actions.pop("snapshot", False))
            will_snap = (it1 % int(cfg.TRAIN.SNAPSHOT) == 0
                         or it1 == max_iter or snap_req or will_stop)
            if not will_snap:
                pending = fetch(it1)
            batch = dict(host)
            for k in ("data", "gt", "gt_mask"):
                batch[k] = host[k].to(device, non_blocking=True)
            rate = solver_mod.learning_rate(it, cfg)
            metrics_dev = grad_step(model, loss_fn, batch, bucket[2:4],
                                    iter_size)
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
                t.toc()
                continue
            process_metrics(record)
            for idx in pending_marks:
                loader.mark_easy(idx)
            pending_marks.clear()
            extra = {"loader_state": np.frombuffer(
                pickle.dumps([loader.state_dict()]), dtype=np.uint8)}
            _save(osp.join(output_dir,
                           f"{snapshot_prefix}_iter_{it1}.npz"),
                  model, opt_state, it1, extra)
            if it1 == max_iter:
                _save_final(output_dir, model, opt_state, it1, extra)
            elif not will_stop:
                # a stop iteration fetches no next batch
                pending = fetch(it1)
            t.toc()
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
    logger.info("done solving!")
    return model
