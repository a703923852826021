"""The port's Detector.forward against the JAX package's detector.forward on
JAX-initialised parameters (PRNGKey 7), converted. Both are true fp32 on the
CPU: rtol 1e-4, atol 1e-4·max|ref|."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.models import detector as dm
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
import torch_threads  # noqa: F401

RTOL = 1e-4


def _pair(different_dilation):
    spec = dm.ModelSpec(different_dilation=different_dilation)
    params = dm.init_params(jax.random.PRNGKey(7), spec)
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = tdm.Detector(params_from_numpy(tree),
                       tdm.ModelSpec(different_dilation=different_dilation),
                       "cpu")
    return spec, params, det


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("different_dilation", [True, False])
def test_forward_exact_matches_jax(different_dilation):
    spec, params, det = _pair(different_dilation)
    x = np.random.RandomState(0).randn(1, 64, 80, 3).astype(np.float32) * 30
    want = dm.forward(params, jnp.asarray(x), spec, mask_mode="exact")
    with torch.inference_mode():
        got = det(torch.from_numpy(x))
    for k in ("cls_logits", "bbox_deltas"):
        assert got[k].shape == want[k].shape
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), np.asarray(want[k]))


def test_forward_where_masking_matches_jax():
    """valid_hw=(48, 64) inside a (1, 64, 128) bucket with garbage beyond
    it: the port's masking equals JAX mask_mode="where" inside the valid
    grid, and equals the unpadded image's forward there too."""
    vh, vw = 48, 64
    spec, params, det = _pair(True)
    x = np.random.RandomState(1).randn(1, 64, 128, 3).astype(np.float32) * 30
    want = dm.forward(params, jnp.asarray(x), spec, valid_hw=(vh, vw),
                      mask_mode="where")
    with torch.inference_mode():
        got = det(torch.from_numpy(x), valid_hw=(vh, vw))
        alone = det(torch.from_numpy(np.ascontiguousarray(x[:, :vh, :vw])))
    for k in ("cls_logits", "bbox_deltas"):
        g = got[k].numpy()[:, :vh // 8, :vw // 8]
        _close(g, np.asarray(want[k])[:, :vh // 8, :vw // 8])
        _close(g, alone[k].numpy())


@pytest.mark.parametrize("different_dilation", [True, False])
def test_forward_through_taps_matches_jax(different_dilation, monkeypatch):
    """Every 3×3 convolution of the forward as nine channel products
    (layers.conv3x3 with TAPS_MIN_FLOP at 0, the route of detection's large
    ones) against the JAX forward."""
    from smallhardface_tpu_torch.models import layers
    monkeypatch.setattr(layers, "TAPS_MIN_FLOP", 0.0)
    spec, params, det = _pair(different_dilation)
    x = np.random.RandomState(4).randn(1, 64, 80, 3).astype(np.float32) * 30
    want = dm.forward(params, jnp.asarray(x), spec, mask_mode="exact")
    with torch.inference_mode():
        got = det(torch.from_numpy(x))
    for k in ("cls_logits", "bbox_deltas"):
        _close(got[k].numpy(), np.asarray(want[k]))


def test_forward_output_layout():
    """NHWC in, (B, H/8, W/8, A, 2|4) out, batch items independent."""
    _, _, det = _pair(True)
    x = np.random.RandomState(2).randn(2, 32, 48, 3).astype(np.float32) * 30
    with torch.inference_mode():
        both = det(torch.from_numpy(x))
        one = det(torch.from_numpy(x[1:].copy()))
    assert both["cls_logits"].shape == (2, 4, 6, 3, 2)
    assert both["bbox_deltas"].shape == (2, 4, 6, 3, 4)
    torch.testing.assert_close(both["cls_logits"][1:], one["cls_logits"],
                               rtol=1e-5, atol=1e-6)
