"""Test-phase orchestration of the PyTorch port: dataset evaluation and the
demo.

Counterpart of ``smallhardface_tpu/test_runner.py``: ``_load_params``
(:31-43), ``inference_worker`` (:46-145), ``_process_range`` (:148-157),
``run_inference`` (:178-222), ``demo`` (:225-241), ``get_testing_roidb``
(:244-252) and ``test_net`` (:255-324), with one unit per process (a
device, or under ``TPU.SPATIAL_DEVICES`` = k > 1 a spatial unit of k):

- each process (a rank of ``parallel.dist``, or the only one) runs a
  contiguous block of the imdb's images through ``TorchDetector`` on its
  card, three images in flight (``detect_async`` enqueues an image's
  pyramid and vote on the device, ``finalize_async`` reads one back), or
  one at a time under ``TPU.HOST_PREPROC``; over W ranks an all-gather
  brings every block back in imdb order on every rank;
- under ``TPU.EVAL_BATCH > 1`` every full group of exactly EVAL_BATCH
  images of one ``_prep`` key within the block runs as one ``detect_many``
  batch, and the images left over run one at a time (JAX
  test_runner.py:89-122);
- ``test_net`` caches the detections in ``detections.pkl`` and hands them
  to the imdb's evaluator; rank 0 alone reads and writes the cache and
  evaluates, and its cache hit is broadcast, so that no rank waits in a
  gather the others skip; ``SHF_FAULT_TEST=1`` makes the first process of
  a ``TRAIN.AUTO_RESUME`` run meet an injected sticky CUDA fault before
  it detects.

Spatial units (``TPU.SPATIAL_DEVICES`` = k > 1, JAX test_runner.py:46-57,
:90-96, :178-193): the process's unit is k local devices of its device's
type, under ``torchrun`` those from LOCAL_RANK·k to LOCAL_RANK·k + k − 1
(``parallel.spatial.unit``; ValueError when k does not divide the local
device count or the unit lies beyond it), and each image runs H-sharded
over it (``TorchDetector(spatial_devices=…)``). ``TPU.EVAL_BATCH > 1`` is
ignored there, with JAX's warning: ``detect_many`` batches per device.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import pickle
from collections import deque

import numpy as np

from smallhardface_tpu_torch import models
from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.detect import TorchDetector, _imread
from smallhardface_tpu_torch.models import detector as detector_mod
from smallhardface_tpu_torch.parallel import dist as pdist
from smallhardface_tpu_torch.parallel import spatial
from smallhardface_tpu_torch.utils.faults import injected_fault
from smallhardface_tpu_torch.utils.tensorboard import tb
from smallhardface_tpu_torch.utils.timer import Timer

logger = logging.getLogger(__name__)

# images in flight on the device in inference_worker's pipeline
PIPELINE_DEPTH = 3


def _load_params(spec):
    """TEST.MODEL as the parameter tree of the model of MODEL.ARCH (its
    ``load_params``, ``models.for_config``): random init from cfg.RNG_SEED
    when empty, else the weights files that model reads."""
    path = cfg.TEST.MODEL
    if not path:
        logger.warning("TEST.MODEL is empty; using random-init weights")
    return models.for_config(cfg).load_params(path, spec, int(cfg.RNG_SEED))


def _process_range(n_total):
    """The contiguous block of images this rank owns (JAX
    test_runner.py:148-157; the reference's worker sharding,
    lib/test.py:319-344)."""
    per = int(np.ceil(n_total / pdist.world()))
    first = per * pdist.rank()
    return min(first, n_total), min(first + per, n_total)


def inference_worker(rank, device, imdb, params, spec, start, end, thresh):
    """Detections of images [start, end) of the imdb on ``device`` (a list
    of devices: a spatial unit), as ``dets[class][image - start]``. Up to PIPELINE_DEPTH images wait on the
    device while the host reads back and stores the oldest; under
    TPU.EVAL_BATCH > 1, full groups of EVAL_BATCH images of one key go
    through ``detect_many`` and the rest one at a time; under
    TPU.HOST_PREPROC the images run one at a time. Under TPU.PRECISION
    "int8" the detector first calibrates on the shard's first
    TPU.INT8_CALIB_IMAGES images; "bfloat16" needs no set-up."""
    if isinstance(device, list):
        det = TorchDetector(params, spec, spatial_devices=device)
    else:
        det = TorchDetector(params, spec, device)
    if det.precision == "int8":
        # the calibrated int8 chain: activation ranges from the first
        # INT8_CALIB_IMAGES images of this shard, before the timed loop
        # (JAX test_runner.py:60-69); 0 stays dynamic
        n_cal = min(int(cfg.TPU.INT8_CALIB_IMAGES), end - start)
        if n_cal > 0:
            det.calibrate_int8([imdb.image_path_at(i)
                                for i in range(start, start + n_cal)])
    timers = {"detect": Timer(), "misc": Timer()}
    dets = [[[] for _ in range(start, end)]
            for _ in range(imdb.num_classes)]

    def store(i, dets_):
        for c in range(imdb.num_classes - 1):
            dets[c + 1][i - start] = dets_[c]
        if rank == 0 and (i - start) % 20 == 0:
            done, total = i + 1 - start, end - start
            avg = timers["detect"].average_time + timers["misc"].average_time
            logger.info(
                "%02d%% detect-time: %.3fs, misc-time: %.3fs, "
                "remain-time: %.1fs", int(100 * done / total),
                timers["detect"].average_time, timers["misc"].average_time,
                (total - done) * avg)
            tb.sess.add_scalar_value(
                "detect-time", timers["detect"].average_time, step=i - start)

    if det.host_preproc:
        for i in range(start, end):
            dets_, _ = det.detect(imdb.image_path_at(i), thresh,
                                  timers=timers)
            store(i, dets_)
        return rank, dets
    eval_batch = int(cfg.TPU.EVAL_BATCH)
    if eval_batch > 1 and det.spatial:
        if rank == 0:
            logger.warning(
                "TPU.EVAL_BATCH=%d ignored under TPU.SPATIAL_DEVICES: "
                "detect_many batches per chip; spatial groups run the "
                "per-image pipeline", eval_batch)
        eval_batch = 1
    if eval_batch > 1:
        # as the JAX runner: full batches of exactly eval_batch images of
        # one key through detect_many, the images left over one at a time
        groups = {}
        for i in range(start, end):
            im = _imread(imdb.image_path_at(i))
            key = det._prep(im)["key"]
            groups.setdefault(key, []).append((i, im))
            if len(groups[key]) == eval_batch:
                group = groups.pop(key)
                timers["detect"].tic()
                results = det.detect_many([m for _, m in group], thresh)
                timers["detect"].toc()
                for (j, _), res in zip(group, results):
                    store(j, res)
        for j, im in (entry for group in groups.values()
                      for entry in group):
            timers["detect"].tic()
            handle = det.detect_async(im, thresh)
            timers["detect"].toc()
            timers["misc"].tic()
            store(j, det.finalize_async(handle, thresh))
            timers["misc"].toc()
        return rank, dets
    pending = deque()       # (image index, device handle)
    for i in range(start, end):
        timers["detect"].tic()
        pending.append((i, det.detect_async(imdb.image_path_at(i), thresh)))
        timers["detect"].toc()
        if len(pending) > PIPELINE_DEPTH:
            j, handle = pending.popleft()
            timers["misc"].tic()
            store(j, det.finalize_async(handle, thresh))
            timers["misc"].toc()
    while pending:
        j, handle = pending.popleft()
        store(j, det.finalize_async(handle, thresh))
    return rank, dets


def run_inference(imdb, params, spec, thresh, device=None):
    """Every image of the imdb: ``dets[class][image]``. Each rank detects
    its block on ``device``; over W ranks the blocks are all-gathered
    (pickled, as JAX's _allgather_detections, test_runner.py:159-176), so
    every rank returns the whole list in imdb order. Under
    TPU.SPATIAL_DEVICES = k > 1 the rank's unit is ``spatial.unit`` k local
    devices of ``device``'s type, the LOCAL_RANK-th group of k."""
    k = int(cfg.TPU.SPATIAL_DEVICES)
    if k > 1:
        device = spatial.unit(device or "cuda", k, pdist.local_rank())
    start, end = _process_range(len(imdb))
    _, dets = inference_worker(0, device, imdb, params, spec, start, end,
                               thresh)
    if pdist.world() == 1:
        return dets
    parts = pdist.allgather_object(dets)
    return [[im_dets for part in parts for im_dets in part[c]]
            for c in range(imdb.num_classes)]


def demo(params, spec, thresh, output_dir, device=None):
    """Single-image demo: detect on TEST.DEMO.IMAGE and draw the boxes into
    ``<output_dir>/demo_res.jpg``. Returns the (N, 5) detections. Runs on
    ``device``, the CUDA card when None (raises when there is none)."""
    import cv2      # drawing and image files only; not on the GPU path

    det = TorchDetector(params, spec, device)
    im_path = cfg.TEST.DEMO.IMAGE
    if not osp.isabs(im_path):
        im_path = osp.join(cfg.ROOT_DIR, im_path)
    im = _imread(im_path)
    dets = det.detect(im, thresh)[0][0]
    for x1, y1, x2, y2, score in dets:
        if score < thresh:
            continue
        cv2.rectangle(im, (int(x1), int(y1)), (int(x2), int(y2)),
                      (0, 255, 0), 2)
    out = osp.join(output_dir, "demo_res.jpg")
    cv2.imwrite(out, im)
    logger.info("Demo result written to %s (%d detections)", out,
                dets.shape[0])
    return np.asarray(dets)


def get_testing_roidb(imdb):
    """Prepare the testing roidb (reference lib/test.py:359-371; evaluation
    itself reads images by path and needs no roidb)."""
    logger.info("Preparing testing data...")
    imdb.prepare_roidb()
    logger.info("done")
    return imdb.roidb


def test_net(imdb, output_dir, thresh=0.05, no_cache=False, step=0,
             params=None, spec=None, device=None):
    """Evaluate on the imdb (the demo when it is None): detections of every
    image, cached in ``<output_dir>/detections.pkl`` unless ``no_cache``,
    then the imdb's ``evaluate_detections``. Returns its result string.
    Runs on ``device``, the CUDA card when None. Under a launcher
    (torchrun) the process joins the process group first and detects its
    block of the images on its card; rank 0 alone reads and writes the
    cache and evaluates, and the other ranks return None."""
    device = pdist.init_distributed(device,
                                    spatial=int(cfg.TPU.SPATIAL_DEVICES))
    if cfg.TEST.LEVEL:
        logger.warning("TEST.LEVEL=%s ignored: the different-dilation "
                       "model has a single proposal module", cfg.TEST.LEVEL)
    spec = spec or detector_mod.build_spec(cfg)
    if params is None:
        params = _load_params(spec)
    if imdb is None:
        assert cfg.TEST.DEMO.ENABLE, "check your config and stderr!"
        return demo(params, spec, thresh, output_dir, device)
    logger.info("Evaluating %s on %s", cfg.NAME, imdb.name)
    rank = pdist.rank()
    dets = None
    det_file = osp.join(output_dir, "detections.pkl")
    if rank == 0 and not no_cache and osp.exists(det_file):
        try:
            with open(det_file, "rb") as f:
                dets = pickle.load(f)
            logger.info("Loading detections from cache: %s", det_file)
        except Exception:
            logger.warning("Could not load the cached detections file, "
                           "detecting from scratch!")
            dets = None
    # every rank detects, or none does: a rank that skipped the gather
    # would leave the others waiting in it
    if not pdist.broadcast_object(dets is not None):
        if (os.environ.get("SHF_FAULT_TEST") == "1"
                and "SHF_AUTO_RESUME_LEFT" not in os.environ):
            # test-only fault injection (JAX test_runner.py:299-307): the
            # first process (no relaunch marker in the env yet) meets a
            # sticky device fault; the TRAIN.AUTO_RESUME relaunch, which
            # carries the marker, completes
            raise injected_fault("SHF_FAULT_TEST")
        dets = run_inference(imdb, params, spec, thresh, device)
        assert len(dets[0]) == len(imdb), "Detection result compromised"
        if rank == 0 and not no_cache:
            with open(det_file, "wb") as f:
                pickle.dump(dets, f, pickle.HIGHEST_PROTOCOL)
    if rank != 0:
        logger.info("Rank %d: detections gathered to rank 0, which writes "
                    "and evaluates them", rank)
        return None
    logger.info("Evaluating detections")
    result = imdb.evaluate_detections(
        all_boxes=dets, output_dir=output_dir, method_name=cfg.NAME,
        step=step)
    logger.info(result)
    logger.info("All Done!")
    return result
