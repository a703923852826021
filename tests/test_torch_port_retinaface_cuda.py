"""RetinaFace-R50 on the card against its plain reference
(``tests/retinaface_ref.py``), with TF32 off, at the benchmark's sizes:
the forward of the largest level of the WIDER protocol (1700×2267, the
short edge 1700 of a 768×1024 image) inside its ×32 bucket, one image's
detections over the whole protocol under the strict rule, and the
detection path's synchronisations, which may only happen inside a wait
span (``torch.cuda.set_sync_debug_mode("error")`` outside them, as
``tests/test_torch_port_waits.py`` holds the other paths).

Every test needs an NVIDIA card (marker ``cuda``) and skips without one.
This file imports neither jax nor the JAX package; on the card:

    python -m pytest --noconftest tests/test_torch_port_retinaface_cuda.py -q

Tolerances as ``tests/test_torch_port_retinaface.py`` states them.
"""

import copy
import json

import numpy as np
import pytest
import torch

import retinaface_ref as ref
from portbench import common
from portbench.gen import images
from portbench.reference import compare
from smallhardface_tpu_torch.config import cfg, cfg_from_file
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io import retinaface as rio
from smallhardface_tpu_torch.models import retinaface as rm
from test_torch_port_retinaface import MEAN, TOML, _close, flat_outputs
from test_torch_port_waits import SyncGuard, fp32_detect

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from smallhardface_tpu_torch.ops import cuda_build, nms_device
    cuda_build.build_all([nms_device.VOTE])
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def net(cuda):
    """The benchmark's weights for SEED: batch norms from a 480×640 probe,
    class heads biased so that 3.5 % of its priors pass 0.02."""
    model = ref.RetinaFace().to(cuda)
    ref.init_weights(model, SEED)
    x = images.background(480, 640, np.random.default_rng(SEED + 3))
    x = torch.from_numpy(x.astype(np.float32) - MEAN).permute(2, 0, 1)
    x = x[None].contiguous().to(cuda)
    ref.probe_bn(model, x)
    ref.background_bias(model, x, common.PASS_SHARE, 0.02)
    return model


@pytest.fixture
def retina_cfg():
    saved = copy.deepcopy(cfg)
    try:
        cfg_from_file(TOML)
        yield cfg
    finally:
        cfg.clear()
        cfg.update(saved)


def _pool_image(seed):
    return images.make_pool(seed, 1, "768x1024", (2, 60), (10, 300))[0][
        "image"]


@pytest.mark.cuda
def test_largest_level_forward_matches_reference(cuda, net):
    h, w = 1700, 2267
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(np.stack(
        [images.background(h, w, rng) for _ in range(2)]).astype(
        np.float32) - MEAN).to(cuda)
    x = torch.zeros(2, 1728, 2272, 3, device=cuda)
    x[:, :h, :w] = img
    params = rio.load_state_dict(net.state_dict())
    with torch.inference_mode():
        conf, loc, landm = flat_outputs(
            rm.RetinaFace(params, cuda)(x, (h, w)), h, w)
    with torch.no_grad(), ref.numerics("fp32"):
        want_loc, want_conf, want_landm = net(
            img.permute(0, 3, 1, 2).contiguous())
    _close(conf, want_conf)
    _close(loc, want_loc)
    _close(landm, want_landm)


@pytest.mark.cuda
def test_protocol_detections_match_reference(cuda, net, retina_cfg):
    """A pool image through all five levels with flip, the cut, the top
    2,048 rows and the vote, against the reference under the strict
    rule, with the benchmark's limit."""
    im = _pool_image(SEED)
    det = TorchDetector(rio.load_state_dict(net.state_dict()), None, cuda)
    got = det.detect(im, rm.CONFIDENCE_THRESHOLD)[0][0]
    tree = json.loads(json.dumps(retina_cfg))
    stats = {}
    want = ref.detect(net, im, tree, cuda, rm.CONFIDENCE_THRESHOLD,
                      stats=stats)
    assert stats["above_cut"] > 2048 and len(want) > 100
    nums = compare.detections([(want, got)], "float32")
    assert (nums["det_unmatched_pct.strict"]
            <= compare.LIMITS["det_unmatched_pct.strict"]), nums


@pytest.mark.cuda
def test_detect_syncs_only_inside_wait_spans(cuda, net, retina_cfg):
    det = TorchDetector(rio.load_state_dict(net.state_dict()), None, cuda)
    im = _pool_image(SEED + 1)
    fp32_detect(det, im)
    guard = SyncGuard("error")
    det.stages = guard
    with guard.armed():
        fp32_detect(det, im)
    torch.cuda.synchronize()
    assert guard.waits > 0
