"""Test-phase orchestration of the PyTorch port.

Counterpart of ``smallhardface_tpu/test_runner.py``: ``_load_params``
(:31-43) and ``demo`` (:225-241). Dataset evaluation (``test_net`` over an
imdb, ``detections.pkl``, the evaluators) waits: ROADMAP queue 1,
'test_net and eval on every dataset config'.
"""

from __future__ import annotations

import logging
import os.path as osp

import numpy as np
import torch

from smallhardface_tpu.config import cfg
from smallhardface_tpu_torch.detect import TorchDetector, _imread
from smallhardface_tpu_torch.io import weights
from smallhardface_tpu_torch.models import detector as detector_mod

logger = logging.getLogger(__name__)


def _load_params(spec):
    """TEST.MODEL as the port's parameter tree: random init from
    cfg.RNG_SEED when empty, else a JAX-package ``.npz`` checkpoint."""
    path = cfg.TEST.MODEL
    if not path:
        logger.warning("TEST.MODEL is empty; using random-init weights")
        gen = torch.Generator().manual_seed(int(cfg.RNG_SEED))
        return detector_mod.init_params(gen, spec)
    if path.endswith(".caffemodel"):
        raise NotImplementedError(
            ".caffemodel loading is not ported yet (ROADMAP queue 1, "
            "'.caffemodel loading'); convert it to .npz with the JAX "
            "package")
    return weights.load_params(path)


def demo(params, spec, thresh, output_dir, device):
    """Single-image demo: detect on TEST.DEMO.IMAGE and draw the boxes into
    ``<output_dir>/demo_res.jpg``. Returns the (N, 5) detections."""
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
