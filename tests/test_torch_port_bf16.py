"""The port's bfloat16 mode (TPU.PRECISION = "bfloat16") on the CPU against
the JAX package's (``compute_dtype=jnp.bfloat16``), on seeded numpy inputs
and JAX-initialised weights converted with io/weights.py:

- one convolution (3×3 at dilations 1, 2 and 4, 1×1, the grouped bilinear
  deconv) on the same bf16 input: the products rounded to bf16 once, then
  the bf16 bias added in bf16, as JAX does. An element may differ only
  where the two fp32 sums, taken in different orders, round to different
  bf16 values: at most a 1e-3 share, each within the bound of two fp32
  sums of the same terms plus a bf16 ulp; with the bias, every element
  whose product agrees agrees to the bit, and a bias fused before the
  rounding would miss JAX on more than 10 % of them;
- the full-width flagship forward at 1×64×128 against JAX's on both of its
  stem routes, the XLA chain and the Pallas stem in interpret mode:
  rtol 1e-1, atol 0.025·peak (measured ≤ 0.012·peak over three seeds;
  the Pallas test's own bound is atol 0.05·peak); the "where" mode inside
  a larger bucket too;
- ``TorchDetector`` on the golden fixture at exactly the bounds of
  tests/test_full_detect_golden.py::test_full_detect_bfloat16_drift_bounded,
  and against JAX's ``TPUDetector`` in bf16: counts within max(3, 5 %),
  each side matched at ≥ 0.95 by that test's loose rule (measured 0.978
  and 0.982);
- ``detect_many`` and one service request in bf16 against per-image
  ``detect``;
- bf16 training raises, and the reason is pinned: JAX's own bf16 gradient
  through ``layers.conv2d`` raises TypeError.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from smallhardface_tpu.config import cfg
from smallhardface_tpu.models import detector as dm
from smallhardface_tpu.models import layers as jl
from smallhardface_tpu.ops import bbox_np
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.models import layers as tl
from tests.test_full_detect_golden import (  # noqa: F401 (golden_cfg)
    GOLDEN, THRESH, _fixture_inputs, golden_cfg)
from tests.test_torch_port_slice import _agree, port_cfg  # noqa: F401

BF16 = torch.bfloat16
FWD_RTOL, FWD_ATOL = 1e-1, 0.025       # atol as a share of max|JAX|


def _bf16_nchw(a):
    """A numpy NHWC array rounded to bf16 by JAX, as an NCHW bf16 tensor
    in channels_last memory, and the JAX bf16 array."""
    xb = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
    return t.permute(0, 3, 1, 2), xb


def _bits(t_nchw):
    return t_nchw.permute(0, 2, 3, 1).contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("k,dilation,c,o", [
    (3, 1, 64, 128), (3, 2, 128, 128), (3, 4, 128, 96), (1, 1, 512, 256)],
    ids=["3x3_d1", "3x3_d2", "3x3_d4", "1x1"])
def test_conv_bf16_rounds_once_then_adds_bias(k, dilation, c, o):
    rng = np.random.RandomState(10 * k + dilation)
    x = (rng.randn(2, 24, 40, c) * 3).astype(np.float32)
    w = (rng.randn(k, k, c, o) * np.sqrt(2 / (k * k * c))).astype(np.float32)
    b = rng.randn(o).astype(np.float32)
    pad = dilation if k == 3 else 0
    xt, xb = _bf16_nchw(x)
    wt, bt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), \
        torch.from_numpy(b)

    # the product alone: differences only where two fp32 sums of the same
    # terms round to different bf16 values
    want = jl.conv2d(xb, jnp.asarray(w), None, dilation=dilation,
                     padding=pad, compute_dtype=jnp.bfloat16)
    got = tl.conv2d(xt, wt, None, dilation=dilation, padding=pad)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    g = got.permute(0, 2, 3, 1).float().numpy().astype(np.float64)
    r = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    differ = g != r
    abs_sum = F.conv2d(xt.double().abs(), wt.to(BF16).double().abs(),
                       dilation=dilation, padding=pad)
    abs_sum = abs_sum.permute(0, 2, 3, 1).numpy()
    n_terms = k * k * c
    ulp = np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -7
    bound = 2 * n_terms * 2.0 ** -24 * abs_sum + ulp
    assert differ.mean() <= 1e-3, differ.mean()
    assert (np.abs(g - r) <= bound).all()

    # with the bias: rounded first, then the bf16 bias in bf16
    want_b = jl.conv2d(xb, jnp.asarray(w), jnp.asarray(b), dilation=dilation,
                       padding=pad, compute_dtype=jnp.bfloat16)
    got_b = tl.conv2d(xt, wt, bt, dilation=dilation, padding=pad)
    same = ~differ
    assert (_bits(got_b)[same]
            == np.asarray(want_b).view(np.int16)[same]).all()
    fused = F.conv2d(xt.float(), wt.to(BF16).float(), bt.to(BF16).float(),
                     dilation=dilation, padding=pad).to(BF16)
    assert (_bits(fused) != np.asarray(want_b).view(np.int16)).mean() > 0.1


def test_deconv_bf16_equal_to_jax():
    """The grouped bilinear deconv in bf16: four exact products of the
    dyadic bilinear weights a pixel, rounded once: equal to the bit."""
    rng = np.random.RandomState(9)
    x = (rng.randn(2, 12, 20, 256) * 3).astype(np.float32)
    wk = jl.bilinear_kernel(2, 256)
    xt, xb = _bf16_nchw(x)
    want = jl.upsample2x_bilinear(xb, jnp.asarray(wk))
    got = tl.upsample2x_bilinear(
        xt, torch.from_numpy(wk.transpose(3, 2, 0, 1).copy()))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int16))


def _pair(seed=7):
    spec = dm.ModelSpec(different_dilation=True)
    params = dm.init_params(jax.random.PRNGKey(seed), spec)
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = tdm.Detector(params_from_numpy(tree),
                       tdm.ModelSpec(different_dilation=True), "cpu")
    return spec, params, det


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL,
                               atol=FWD_ATOL * np.abs(want).max())


@pytest.mark.parametrize("stem", ["xla", "pallas_interpret"])
def test_forward_bf16_matches_jax(stem):
    """The flagship network at full width on a 1×64×128 input: the port's
    stem is K1's plain version in fp32 on the bf16-rounded input, JAX's
    either the bf16 XLA chain (its CPU default) or the Pallas kernel (bf16
    dots inside), so the two agree at the bf16 noise of a deep network."""
    import smallhardface_tpu.ops.pallas_stem as ps
    spec, params, det = _pair()
    x = np.random.RandomState(0).randn(1, 64, 128, 3).astype(np.float32) * 30
    ps.TESTING_INTERPRET = stem == "pallas_interpret"
    try:
        want = dm.forward(params, jnp.asarray(x), spec, mask_mode="exact",
                          compute_dtype=jnp.bfloat16,
                          pallas_stem=stem == "pallas_interpret")
    finally:
        ps.TESTING_INTERPRET = False
    with torch.inference_mode():
        got = det(torch.from_numpy(x), precision="bfloat16")
    for k in ("cls_logits", "bbox_deltas"):
        assert got[k].shape == want[k].shape
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        _close(got[k].numpy(), np.asarray(want[k]))


def test_forward_bf16_where_mode_matches_jax():
    """valid_hw=(48, 64) inside a (1, 64, 128) bucket with garbage beyond
    it: the bf16 forward against JAX's "where" mode inside the valid
    grid."""
    vh, vw = 48, 64
    spec, params, det = _pair()
    x = np.random.RandomState(1).randn(1, 64, 128, 3).astype(np.float32) * 30
    want = dm.forward(params, jnp.asarray(x), spec, valid_hw=(vh, vw),
                      mask_mode="where", compute_dtype=jnp.bfloat16)
    with torch.inference_mode():
        got = det(torch.from_numpy(x), valid_hw=(vh, vw),
                  precision="bfloat16")
    for k in ("cls_logits", "bbox_deltas"):
        _close(got[k].numpy()[:, :vh // 8, :vw // 8],
               np.asarray(want[k])[:, :vh // 8, :vw // 8])


def test_bf16_weights_cast_once():
    """The bf16 weights are rounded once per detector and again only when
    a parameter changes in place."""
    _, _, det = _pair()
    first = det.bf16_tree()
    assert det.bf16_tree() is first
    assert first["head"]["w"].dtype == BF16
    with torch.no_grad():
        det.params["head"]["b"].add_(1.0)
    again = det.bf16_tree()
    assert again is not first
    torch.testing.assert_close(again["head"]["b"],
                               det.params["head"]["b"].to(BF16))


def _loose_match(a, b):
    """test_full_detect_bfloat16_drift_bounded's rule: IoU > 0.6 and
    |Δscore| < 0.1."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    iou = bbox_np.bbox_overlaps(a[:, :4], b[:, :4])
    best = iou.argmax(axis=1)
    ok = (iou[np.arange(len(a)), best] > 0.6) & (
        np.abs(a[:, 4] - b[best, 4]) < 0.1)
    return float(ok.mean())


@pytest.fixture
def bf16_detector(port_cfg):
    saved = cfg.TPU.PRECISION, tcfg.TPU.PRECISION
    cfg.TPU.PRECISION = tcfg.TPU.PRECISION = "bfloat16"
    im, spec, params = _fixture_inputs()
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = TorchDetector(params_from_numpy(tree),
                        tdm.ModelSpec(different_dilation=True), "cpu")
    yield im, spec, params, det
    cfg.TPU.PRECISION, tcfg.TPU.PRECISION = saved


def test_detect_bf16_drift_bounded(bf16_detector):
    """The bounds of test_full_detect_bfloat16_drift_bounded, on the
    port."""
    im, _, _, det = bf16_detector
    golden = np.load(GOLDEN)["dets"]
    dets = det.detect(im, thresh=THRESH)[0][0]
    assert abs(dets.shape[0] - golden.shape[0]) <= max(
        3, 0.15 * golden.shape[0])
    assert _loose_match(golden, dets) >= 0.85
    assert _loose_match(dets, golden) >= 0.75


def test_detect_bf16_matches_jax_detector(bf16_detector):
    from smallhardface_tpu.detect import TPUDetector
    im, spec, params, det = bf16_detector
    want = TPUDetector(params, spec).detect(im, thresh=THRESH)[0][0]
    got = det.detect(im, thresh=THRESH)[0][0]
    assert abs(len(got) - len(want)) <= max(3, 0.05 * len(want))
    assert _loose_match(got, want) >= 0.95
    assert _loose_match(want, got) >= 0.95


def test_detect_many_and_service_bf16(bf16_detector):
    """detect_many over three images of one bucket key, and one request to
    the service, against per-image bf16 detect."""
    import cv2
    from smallhardface_tpu_torch.serve import DetectorService
    im, _, _, det = bf16_detector
    ims = [im, np.ascontiguousarray(im[:150, :190]),
           np.ascontiguousarray(im[:144, :180])]
    assert len({det._prep(m)["key"] for m in ims}) == 1
    singles = [det.detect(m, thresh=THRESH)[0][0] for m in ims]
    for got, want in zip(det.detect_many(ims, THRESH, max_batch=3), singles):
        _agree(got[0], want)
    service = DetectorService(det.model.tree(), det.spec, device="cpu")
    assert service.det.precision == "bfloat16"
    served = service.detect(cv2.imencode(".png", im)[1].tobytes(), THRESH)
    np.testing.assert_array_equal(served, singles[0])


def test_train_bf16_raises_citing_the_reference(port_cfg):
    from smallhardface_tpu_torch.train import train_loop
    saved = tcfg.TPU.PRECISION
    tcfg.TPU.PRECISION = "bfloat16"
    try:
        with pytest.raises(NotImplementedError,
                           match="JAX reference's own bfloat16 gradient"):
            train_loop.train_net(None, None, "", 1, device="cpu")
    finally:
        tcfg.TPU.PRECISION = saved


def test_jax_bf16_gradient_fails():
    """The reason bf16 training is not ported: the JAX package's bf16
    convolution has no gradient under the installed jax (its transpose
    mixes a bf16 operand with the fp32 cotangent). If this test fails, a
    later jax computes that gradient, and bf16 training can be ported
    against it."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(1, 8, 8, 4).astype(np.float32))
    w = jnp.asarray(rng.randn(3, 3, 4, 5).astype(np.float32))
    b = jnp.zeros((5,), jnp.float32)

    def loss(w):
        y = jl.conv2d(x.astype(jnp.bfloat16), w, b, padding=1,
                      compute_dtype=jnp.bfloat16)
        return y.astype(jnp.float32).sum()

    jl.conv2d(x.astype(jnp.bfloat16), w, b, padding=1,
              compute_dtype=jnp.bfloat16)          # the forward runs
    with pytest.raises(TypeError, match="same dtypes"):
        jax.grad(loss)(w)
