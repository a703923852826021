"""The final vote of the port (smallhardface_tpu_torch/ops/nms_device.py and
the DEVICE_VOTE / VOTE_CAP / MERGED_DET_CAP paths of detect.py) on the CPU
against the JAX package's (ops/nms_jax.py, detect.TPUDetector).

The plain versions are compared with ``bbox_vote_device`` / ``nms_device``
on seeded inputs: the same number of rows out, the scores equal to the bit
(each is a row's own score or a cluster's max, and a cluster's members are
decided by the same float32 IoU expression), the boxes within 1e-6 of the
largest coordinate (a merged box is a float32 sum over the cluster, taken
in another order). Whole detections are compared with the golden fixture's
rule (tests/test_torch_port_slice.py:_agree)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg
from smallhardface_tpu.ops import nms_jax
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.ops import nms_device
import torch_threads  # noqa: F401
from tests.test_full_detect_golden import (  # noqa: F401 (golden_cfg)
    THRESH, _fixture_inputs, golden_cfg)
from tests.test_torch_port_slice import _agree, port_cfg  # noqa: F401

BOX_TOL = 1e-6


def _sorted_dets(rng, n, n_pad=0, span=150.0, integer=False):
    """n candidate rows sorted by descending score, then n_pad padding rows
    (score -inf), float32."""
    dets = np.zeros((n + n_pad, 5), np.float32)
    x1y1 = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(5, span / 2, (n, 2))
    if integer:
        x1y1, wh = np.floor(x1y1), np.floor(wh)
    dets[:n, :2] = x1y1
    dets[:n, 2:4] = x1y1 + wh
    dets[:n, 4] = np.sort(rng.permutation(n) / max(n, 1) + 0.05)[::-1]
    dets[n:, 4] = -np.inf
    return dets


def _jax_vote(dets, n_valid, thresh, method):
    if method == "BBOX_VOTE":
        out, cnt = nms_jax.bbox_vote_device(jnp.asarray(dets), n_valid,
                                            np.float32(thresh))
        return np.asarray(out)[:int(cnt)]
    idx, _, n_keep = nms_jax.nms_device(
        jnp.asarray(dets[:, :4]), jnp.asarray(dets[:, 4]),
        np.float32(thresh), n_valid=n_valid)
    return dets[np.asarray(idx)[:int(n_keep)]]


def _port_vote(dets, n_valid, thresh, method):
    fn = (nms_device.bbox_vote_device if method == "BBOX_VOTE"
          else nms_device.nms_device)
    out, n_out = fn(torch.from_numpy(dets), torch.tensor(n_valid,
                                                         dtype=torch.int32),
                    thresh)
    out = out.numpy()
    assert not out[int(n_out):].any()
    return out[:int(n_out)]


@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
@pytest.mark.parametrize("n,n_pad,thresh,integer", [
    (0, 8, 0.4, False),         # no candidate, padding only
    (1, 0, 0.4, False),         # a lone row: the singleton tail
    (2, 3, 0.4, True),
    (40, 24, 0.3, False),
    (120, 0, 0.4, False),
    (300, 40, 0.5, True),
    (64, 0, 0.0, False),        # every overlapping row joins
])
def test_plain_vote_matches_jax(method, n, n_pad, thresh, integer):
    rng = np.random.RandomState(n + n_pad)
    dets = _sorted_dets(rng, n, n_pad, integer=integer)
    want = _jax_vote(dets, n, thresh, method)
    got = _port_vote(dets, n, thresh, method)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    peak = max(float(np.abs(dets[:n, :4]).max(initial=1.0)), 1.0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=BOX_TOL * peak)


def test_plain_vote_singleton_quirks():
    """A mid-stream singleton is dropped, a final one kept; a crowd of
    identical boxes merges into one row with the max score."""
    dets = np.array([[10, 10, 50, 50, 0.9], [200, 200, 240, 240, 0.85],
                     [12, 12, 52, 52, 0.8], [300, 10, 330, 40, 0.5]],
                    np.float32)
    got = _port_vote(dets, 4, 0.4, "BBOX_VOTE")
    want = _jax_vote(dets, 4, 0.4, "BBOX_VOTE")
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=BOX_TOL * 330)
    assert got[1].tolist() == dets[3].tolist()
    crowd = np.tile(np.array([[5, 6, 25, 30, 0.0]], np.float32), (9, 1))
    crowd[:, 4] = np.linspace(0.9, 0.1, 9)
    got = _port_vote(crowd, 9, 0.4, "BBOX_VOTE")
    want = _jax_vote(crowd, 9, 0.4, "BBOX_VOTE")
    assert got.shape == want.shape == (1, 5) and got[0, 4] == np.float32(0.9)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=BOX_TOL * 30)


def _both_detectors(device_vote, method, vote_cap, merged_cap=-1):
    """The fixture through the JAX TPUDetector and the port's TorchDetector
    under the same TPU settings."""
    im, spec, params = _fixture_inputs()
    saved = {k: (cfg.TPU[k], tcfg.TPU[k]) for k in ("MERGED_DET_CAP",)}
    for c in (cfg, tcfg):
        c.TPU.DEVICE_VOTE = device_vote
        c.TPU.VOTE_CAP = vote_cap
        c.TPU.MERGED_DET_CAP = merged_cap
        c.TEST.NMS_METHOD = method
    try:
        from smallhardface_tpu.detect import TPUDetector
        want = TPUDetector(params, spec).detect(im, thresh=THRESH)[0][0]
        tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                for k, v in params.items()}
        got = TorchDetector(params_from_numpy(tree),
                            tdm.ModelSpec(different_dilation=True),
                            "cpu").detect(im, thresh=THRESH)[0][0]
    finally:
        for k, (a, b) in saved.items():
            cfg.TPU[k], tcfg.TPU[k] = a, b
    return got, want


def test_device_vote_with_binding_cap_matches_jax(port_cfg):
    """TPU.DEVICE_VOTE = true (the default) with a VOTE_CAP below the
    fixture's count above the threshold: only the top 64 rows are voted."""
    got, want = _both_detectors(True, "BBOX_VOTE", 64)
    _agree(got, want)
    assert 0 < len(want) < 64


@pytest.mark.parametrize("device_vote,method,vote_cap,merged_cap", [
    (True, "NMS", 64, -1),
    (False, "BBOX_VOTE", 64, 64),       # MERGED_DET_CAP binds the host vote
    (False, "NMS", 2048, -1),
])
def test_vote_paths_match_jax(port_cfg, device_vote, method, vote_cap,
                              merged_cap):
    got, want = _both_detectors(device_vote, method, vote_cap, merged_cap)
    _agree(got, want)
