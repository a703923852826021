"""The port's int8 serving mode (TPU.PRECISION = "int8") on the CPU against
the JAX package's (tests/test_int8.py), with JAX-initialised weights
converted by ``io/weights.params_from_numpy``, JAX qstates carried across
by ``qstate_from_numpy`` and inputs from numpy seeds. On the CPU the int8
products run through ``ops/conv_int8``'s plain version (float64 sums).

Tolerances, each beside what was measured:

- the layer ops (weight quantization, one chain link at dilations 1/2/4
  for the three epilogues, the dynamic conv, the int8 pool): equal to the
  bit (measured: no element differs; XLA's CPU code does not contract the
  epilogue's multiply-add);
- the amax of a calibration forward: rtol 1e-5 (measured 1.0e-6: the
  stems differ in the last bits);
- the whole forward with one stem output fed to both: every int8 carrier
  of the backbone equal, the later links within 1e-4 of their values
  (measured: all equal), the logits corr >= 0.99999 (measured 1 - 2.2e-14
  at worst);
- the whole forward end to end, each package with its own fp32 stem:
  logits corr >= 0.999 (measured 0.99977 static, 0.99957 dynamic) and at
  most 1e-4 of conv2_1's int8 input differing (measured 5.1e-6). A
  one-ulp stem difference flips a value at conv2_1's input now and then,
  and each link of the full-width chain multiplies the flips about
  threefold (the measured shares are printed);
- port int8 against port fp32: JAX's own bounds (corr > 0.99 dynamic,
  > 0.98 static);
- detection on the skeletal net (the JAX qstate carried across): the
  golden tests' rule at 0.99 each way, counts within max(2, 2 %)
  (measured: equal counts, every row matched each way); the dynamic
  mode at a TPU.FLIP_SPLIT_PX that splits one level's image and mirror
  and not the other's (a wrong grouping measured 0.940-0.958 matched:
  test_dynamic_grouping_is_visible).
"""

import copy
import logging
import os

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import smallhardface_tpu.models.detector as jdm
from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.detect import TPUDetector
from smallhardface_tpu.models import layers as jl
from smallhardface_tpu_torch import serve as tserve
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io.weights import (
    params_from_numpy, qstate_from_numpy, qstate_to_numpy)
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.models import layers as tl
from smallhardface_tpu_torch.ops import conv_int8
from tests.test_full_detect_golden import _match_fraction
from tests.test_torch_port_eval import (  # noqa: F401 (fixtures)
    SKELETAL, _skeletal_weights, data_dir, synth_wider)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8_TOML = os.path.join(REPO, "smallhardface_tpu", "configs",
                         "smallhardface-int8.toml")
BACKBONE_LINKS = 11     # conv2_1 .. conv5_3: before the fp32 laterals


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def _nchw(a):
    """NHWC numpy → an NCHW-shaped channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _numpy_qstate(q):
    return {k: {n: np.asarray(v) for n, v in d.items()} for k, d in q.items()}


@pytest.fixture(scope="module")
def full():
    """Full-width VGG-16 weights (PRNGKey 0) in both packages, a JAX qstate
    calibrated on two 64×96 inputs, and that qstate in the port."""
    spec = jdm.ModelSpec(different_dilation=True)
    params = jdm.init_params(jax.random.PRNGKey(0), spec)
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = tdm.Detector(params_from_numpy(tree),
                       tdm.ModelSpec(different_dilation=True), "cpu")
    rng = np.random.RandomState(6)
    calib = [rng.randn(1, 64, 96, 3).astype(np.float32) * 30
             for _ in range(2)]
    amax = jdm.collect_int8_amax(params, spec, calib)
    jq = jdm.make_qstate(params, spec, amax)
    x = rng.randn(2, 64, 96, 3).astype(np.float32) * 39
    return {"spec": spec, "params": params, "det": det, "calib": calib,
            "amax": amax, "jq": jq, "tq": qstate_from_numpy(
                _numpy_qstate(jq)), "x": x}


# ---- the layer ops ----

@pytest.mark.parametrize("shape,zero_channel", [((3, 3, 64, 128), False),
                                                ((3, 3, 32, 64), True)])
def test_quantize_weights_int8_matches_jax(shape, zero_channel):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.05
    if zero_channel:                    # max|w| = 0: the 1e-12 floor
        w[..., 3] = 0.0
    jq, js = jl.quantize_weights_int8(jnp.asarray(w))
    tq, ts = tl.quantize_weights_int8(_oihw(w))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("epilogue", ["link", "end", "dynamic"])
def test_int8_conv_matches_jax(dilation, epilogue):
    """One static link (int8 out, or the chain's fp32 end) on identical
    int8 inputs with -128 among them, and the dynamic conv (fp32 in, no
    ReLU), against JAX conv2d_int8_chain / conv2d_int8: equal to the
    bit."""
    rng = np.random.RandomState(dilation)
    w = rng.randn(3, 3, 32, 64).astype(np.float32) * 0.1
    b = rng.randn(64).astype(np.float32) * 0.1
    if epilogue == "dynamic":
        x = np.abs(rng.randn(2, 12, 17, 32)).astype(np.float32) * 3
        want = np.asarray(jl.conv2d_int8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            dilation=dilation, padding=dilation))
        got = tl.conv2d_int8(_nchw(x), _oihw(w), torch.from_numpy(b),
                             dilation=dilation)
    else:
        q = rng.randint(-128, 128, (2, 12, 17, 32)).astype(np.int8)
        s_in, s_out = np.float32(0.0371), np.float32(0.0496)
        jqw, js = jl.quantize_weights_int8(jnp.asarray(w))
        tqw, ts = tl.quantize_weights_int8(_oihw(w))
        link = epilogue == "link"
        want = np.asarray(jl.conv2d_int8_chain(
            jnp.asarray(q), jqw, s_in, js, jnp.asarray(b), dilation=dilation,
            padding=dilation, s_out=s_out if link else None))
        got = tl.conv2d_int8_chain(
            _nchw(q), tl.kernel_weights(tqw), float(s_in), ts,
            torch.from_numpy(b), dilation=dilation,
            s_out=float(s_out) if link else None)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = _nhwc(got)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (5, 6), (1, 3)])
def test_int8_max_pool_matches_jax(hw):
    """Caffe's ceil mode on an int8 carrier: an odd edge pads with -128."""
    x = np.random.RandomState(1).randint(-128, 128, (2, *hw, 32)).astype(
        np.int8)
    want = np.asarray(jl.max_pool_2x2(jnp.asarray(x)))
    got = tl.max_pool_2x2(_nchw(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_nhwc(got), want)


def test_conv_int8_wrapper_takes_only_its_epilogues():
    x = torch.zeros((1, 32, 4, 4), dtype=torch.int8)
    w = torch.zeros((64, 3, 3, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="ReLU"):
        conv_int8.conv3x3_int8(x, w, torch.ones(1, 64), torch.zeros(64),
                               relu=False, s_out=0.5)


# ---- calibration and the qstate ----

def test_collect_int8_amax_matches_jax(full):
    got = tdm.collect_int8_amax(full["det"], full["calib"])
    assert sorted(got) == sorted(jdm.int8_layer_names(full["spec"]))
    print("amax max relative difference:", max(
        abs(got[k] - v) / v for k, v in full["amax"].items()))
    for k, v in full["amax"].items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


def test_make_qstate_matches_jax(full):
    tq = tdm.make_qstate(full["det"].tree(), full["det"].spec, full["amax"])
    want = _numpy_qstate(full["jq"])
    got = qstate_to_numpy(tq)
    assert sorted(got["qw"]) == sorted(want["qw"])
    for n in want["qw"]:
        assert np.float32(got["scales"][n]) == want["scales"][n]
        np.testing.assert_array_equal(got["qw"][n], want["qw"][n])
        np.testing.assert_array_equal(got["s_w"][n].view(np.int32),
                                      want["s_w"][n].view(np.int32))
        assert tq["qw"][n].shape[1:3] == (3, 3) and tq["qw"][n].is_contiguous()


def test_qstate_round_trip(full):
    want = _numpy_qstate(full["jq"])
    back = qstate_to_numpy(qstate_from_numpy(want))
    for key in ("scales", "qw", "s_w"):
        for n, v in want[key].items():
            assert back[key][n].dtype == v.dtype
            np.testing.assert_array_equal(back[key][n], v)
    again = qstate_from_numpy(back)
    for n, v in full["tq"]["qw"].items():
        assert torch.equal(again["qw"][n], v)
        assert again["scales"][n] == full["tq"]["scales"][n]


# ---- the whole forward ----

def _record(monkeypatch, module, name, into, to_numpy):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append((to_numpy(args[0]), to_numpy(out)))
        return out
    monkeypatch.setattr(module, name, wrapped)


def _jax_stem(params, x):
    """The XLA stem of the JAX forward (conv1_1, conv1_2, the 2×2 pool)."""
    h = jnp.asarray(x)
    for name in ("conv1_1", "conv1_2"):
        h = jax.nn.relu(jl.conv2d(h, params[name]["w"], params[name]["b"],
                                  padding=1))
    return np.asarray(jl.max_pool_2x2(h))


def _corr(a, b):
    return np.corrcoef(np.asarray(a).ravel(), np.asarray(b).ravel())[0, 1]


@pytest.mark.parametrize("mode", ["static", "dynamic_per_item",
                                  "dynamic_joint"])
def test_forward_equal_to_jax_on_a_common_stem(full, monkeypatch, mode):
    """The JAX stem's output fed to the port's forward: every int8 conv of
    the backbone (int8 carriers in the chain, fp32 outputs in the dynamic
    mode) equal to JAX's; the links after the fp32 laterals equal but for
    at most 1e-4 of their values; the logits corr >= 0.99999. The dynamic
    mode's step groups: one per item (``scale_groups`` [0, 1]) against JAX
    called per item, and one for the batch against JAX called once."""
    x, params = full["x"], full["params"]
    stem = torch.from_numpy(_jax_stem(params, x))
    monkeypatch.setattr(tdm, "fused_stem", lambda *a, **k: stem)
    name = "conv2d_int8_chain" if mode == "static" else "conv2d_int8"
    jrec, trec = [], []
    _record(monkeypatch, jdm, name, jrec, np.asarray)
    _record(monkeypatch, tdm, name, trec, lambda t: _nhwc(t))
    qs = full["jq"] if mode == "static" else None

    def jax_fwd(xx):
        return jdm.forward(params, jnp.asarray(xx), full["spec"],
                           compute_dtype="int8", mask_mode="exact",
                           qstate=qs)
    if mode == "dynamic_per_item":
        outs = [jax_fwd(x[i:i + 1]) for i in range(2)]
        want = {k: np.concatenate([np.asarray(o[k]) for o in outs])
                for k in outs[0]}
        n = len(jrec) // 2          # JAX's calls: item 0's, then item 1's
        jrec = [tuple(np.concatenate(p) for p in zip(a, b))
                for a, b in zip(jrec[:n], jrec[n:])]
        groups = torch.tensor([0, 1])
    else:
        want = jax_fwd(x)
        groups = None
    with torch.inference_mode():
        got = full["det"](torch.from_numpy(x), precision="int8",
                          qstate=full["tq"] if mode == "static" else None,
                          scale_groups=groups)
    assert len(trec) == len(jrec) == BACKBONE_LINKS + 5
    for i, ((jin, jout), (tin, tout)) in enumerate(zip(jrec, trec)):
        assert tout.dtype == jout.dtype
        if i < BACKBONE_LINKS:
            np.testing.assert_array_equal(tin, jin)
            np.testing.assert_array_equal(tout.view(np.uint8),
                                          jout.view(np.uint8))
        else:
            assert (tout != jout).mean() <= 1e-4, i
    corr = {k: _corr(got[k], want[k]) for k in want}
    later = [float((t[1] != j[1]).mean()) for j, t in zip(jrec, trec)]
    print(f"{mode}: later links differ in {later[BACKBONE_LINKS:]}; "
          f"1 - corr {({k: 1 - v for k, v in corr.items()})}")
    assert min(corr.values()) >= 0.99999


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_forward_end_to_end_tracks_jax(full, monkeypatch, mode):
    """Each package with its own fp32 stem: logits corr >= 0.999 and at
    most 1e-4 of conv2_1's int8 input differing. Prints the share of
    differing int8 values at conv2_1's input and at each later link."""
    x = full["x"]
    name = "conv2d_int8_chain" if mode == "static" else "conv2d_int8"
    jrec, trec = [], []
    _record(monkeypatch, jdm, name, jrec, np.asarray)
    _record(monkeypatch, tdm, name, trec, lambda t: _nhwc(t))
    static = mode == "static"
    want = jdm.forward(full["params"], jnp.asarray(x), full["spec"],
                       compute_dtype="int8", mask_mode="exact",
                       qstate=full["jq"] if static else None)
    with torch.inference_mode():
        got = full["det"](torch.from_numpy(x), precision="int8",
                          qstate=full["tq"] if static else None)
    if static:
        first = (jrec[0][0] != trec[0][0]).mean()
        shares = [float((j[1] != t[1]).mean()) for j, t in zip(jrec, trec)]
    else:           # conv2_1's input quantized on each side's own step
        s_j = np.float32(max(np.abs(jrec[0][0]).max(), 1e-12)) / \
            np.float32(127)
        s_t = np.float32(max(np.abs(trec[0][0]).max(), 1e-12)) / \
            np.float32(127)
        first = (np.round(jrec[0][0] / s_j) != np.round(
            trec[0][0] / s_t)).mean()
        shares = []
    corr = {k: _corr(got[k], want[k]) for k in want}
    print(f"{mode}: conv2_1 input differs in {first:.3g}; links {shares}; "
          f"corr {corr}")
    assert first <= 1e-4
    assert min(corr.values()) >= 0.999


@pytest.mark.parametrize("static", [False, True])
def test_port_int8_tracks_port_fp32(full, static):
    """tests/test_int8.py's bounds on the port alone: the dynamic forward's
    logits corr > 0.99 with fp32 (64×128 input), the calibrated one > 0.98
    on an input 1.3× beyond its calibration."""
    rng = np.random.RandomState(3 if not static else 6)
    det = full["det"]
    qstate = None
    if static:
        calib = [rng.randn(1, 64, 128, 3).astype(np.float32) * 30
                 for _ in range(2)]
        qstate = tdm.make_qstate(det.tree(), det.spec,
                                 tdm.collect_int8_amax(det, calib))
        x = rng.randn(1, 64, 128, 3).astype(np.float32) * 39
    else:
        x = rng.randn(1, 64, 128, 3).astype(np.float32) * 30
    with torch.inference_mode():
        f32 = det(torch.from_numpy(x), valid_hw=(64, 128))
        q8 = det(torch.from_numpy(x), valid_hw=(64, 128), precision="int8",
                 qstate=qstate)
    assert torch.isfinite(q8["cls_logits"]).all()
    assert _corr(f32["cls_logits"], q8["cls_logits"]) > (
        0.98 if static else 0.99)
    assert q8["bbox_deltas"].abs().max() < 1e3


# ---- the detector, test_net and the service ----

@pytest.fixture
def int8_cfg():
    saved = [(c, copy.deepcopy(c.TEST), copy.deepcopy(c.TPU))
             for c in (jcfg, tcfg)]
    yield
    for c, test, tpu in saved:
        c.TEST.update(test)
        c.TPU.update(tpu)


def _set(**kv):
    for c in (jcfg, tcfg):
        for key, v in kv.items():
            section, k = key.split("__")
            c[section][k] = v


@pytest.mark.parametrize("mode", ["band", "band_margin"])
def test_detector_init_rejects_int8_band(full, int8_cfg, mode):
    _set(TPU__PRECISION="int8", TPU__MASK_MODE=mode)
    with pytest.raises(ValueError, match="MASK_MODE"):
        TPUDetector(full["params"], full["spec"])
    with pytest.raises(ValueError, match="MASK_MODE"):
        TorchDetector(full["det"].tree(), full["det"].spec, "cpu")


def test_detector_refuses_bfloat16(full, int8_cfg):
    """bfloat16 is ported: the detector builds, and refuses int8
    calibration as the JAX one does; a precision the JAX package has no
    mode for ("float16") raises."""
    _set(TPU__PRECISION="bfloat16")
    det = TorchDetector(full["det"].tree(), full["det"].spec, "cpu")
    assert det.precision == "bfloat16" and det.qstate is None
    with pytest.raises(ValueError, match="int8"):
        det.calibrate_int8([_small_image(3)])
    _set(TPU__PRECISION="float16")
    with pytest.raises(ValueError, match="float16"):
        TorchDetector(full["det"].tree(), full["det"].spec, "cpu")


def test_train_rejects_int8(int8_cfg):
    from smallhardface_tpu_torch.train import train_loop
    _set(TPU__PRECISION="int8")
    with pytest.raises(ValueError, match="inference-only"):
        train_loop.train_net(None, None, "", 1, device="cpu")


def _small_image(seed):
    return np.random.RandomState(seed).randint(0, 255, (90, 130, 3),
                                               dtype=np.uint8)


def test_detector_calibrate_int8(full, int8_cfg):
    """JAX test_detector_calibrate_int8 on the port: calibrate_int8 builds
    a qstate (its amax within rtol 1e-5 of JAX's on the same image), it
    refuses fp32, and detection then runs the calibrated chain with a
    count near the fp32 one."""
    im = _small_image(7)
    _set(TEST__SCALES=[60], TEST__FLIP=False, TPU__MASK_MODE="where",
         TPU__PRECISION="float32")
    tree, spec = full["det"].tree(), full["det"].spec
    d32 = TorchDetector(tree, spec, "cpu").detect(im, 0.05)[0][0]
    with pytest.raises(ValueError, match="int8"):
        TorchDetector(tree, spec, "cpu").calibrate_int8([im])
    _set(TPU__PRECISION="int8")
    det = TorchDetector(tree, spec, "cpu")
    amax = det.calibrate_int8([im])
    assert det.qstate is not None
    assert sorted(amax) == sorted(jdm.int8_layer_names(full["spec"]))
    want = TPUDetector(full["params"], full["spec"]).calibrate_int8([im])
    for k, v in want.items():
        assert amax[k] == pytest.approx(v, rel=1e-5), k
    calls = conv_int8.conv3x3_int8.launches
    d8 = det.detect(im, thresh=0.05)[0][0]
    assert conv_int8.conv3x3_int8.launches == calls     # the CPU: no kernel
    assert abs(d8.shape[0] - d32.shape[0]) <= max(5, 0.5 * d32.shape[0])


def test_detector_int8_mode_wires_through(full, int8_cfg, monkeypatch):
    """JAX test_detector_int8_mode_wires_through on the port: the dynamic
    mode's detections near the fp32 ones, its convs through
    conv3x3_int8."""
    im = _small_image(5)
    _set(TEST__SCALES=[60], TEST__FLIP=False, TPU__MASK_MODE="where",
         TPU__PRECISION="float32")
    tree, spec = full["det"].tree(), full["det"].spec
    d32 = TorchDetector(tree, spec, "cpu").detect(im, 0.05)[0][0]
    _set(TPU__PRECISION="int8")
    seen = []
    _record(monkeypatch, tl, "conv3x3_int8", seen, lambda t: t.dtype)
    d8 = TorchDetector(tree, spec, "cpu").detect(im, 0.05)[0][0]
    assert len(seen) == len(jdm.int8_layer_names(full["spec"])) + 2
    assert abs(d8.shape[0] - d32.shape[0]) <= max(5, 0.5 * d32.shape[0])


@pytest.fixture
def skeletal(int8_cfg, monkeypatch):
    """The skeletal backbone in both packages, background-biased heads, two
    levels (64×80 and 96×128 for a 96×128 image) with flip, and a
    FLIP_SPLIT_PX that splits the larger level only."""
    monkeypatch.setattr(jdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    _set(TEST__SCALES=[50, 90], TEST__FLIP=True, TEST__NMS_METHOD="BBOX_VOTE",
         TEST__NMS_THRESH=0.4, TEST__SCORE_THRESH=0.002,
         TEST__N_DETS_PER_MODULE=10000, TPU__VOTE_CAP=16384,
         TPU__TEST_BUCKET=64, TPU__DEVICE_VOTE=True, TPU__HOST_PREPROC=False,
         TPU__PRECISION="int8", TPU__MASK_MODE="exact",
         TPU__FLIP_SPLIT_PX=8000)
    spec = jdm.ModelSpec(different_dilation=True)
    params = jdm.init_params(jax.random.PRNGKey(7), spec)
    for k in (1, 2, 4):
        params[f"cls_score_{k}"]["b"] = jnp.asarray([1.2, -1.2])
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    ims = [cv2.GaussianBlur(np.random.RandomState(s).randint(
        0, 255, (96, 128, 3)).astype(np.uint8), (7, 7), 3) for s in (3, 4)]
    ims[1] = ims[1][:80]
    return params, spec, params_from_numpy(tree), ims


def _rule(a, b):
    fwd, bwd = _match_fraction(a, b), _match_fraction(b, a)
    print(f"{len(a)} and {len(b)} rows, matched {fwd:.3f} / {bwd:.3f}")
    assert abs(len(a) - len(b)) <= max(2, 0.02 * len(b))
    assert min(fwd, bwd) >= 0.99


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("entry", ["detect", "detect_many", "host_preproc"])
def test_detection_matches_jax(skeletal, static, entry):
    """TorchDetector against TPUDetector in the int8 mode, on one qstate
    (JAX's calibration, carried across) or both dynamic: ``detect``,
    ``detect_many`` over two images of one ×16 key, and the host-preproc
    path (``forward_scale``, one step for the image and its mirror)."""
    params, spec, tparams, ims = skeletal
    if entry == "host_preproc":
        _set(TPU__HOST_PREPROC=True)
    jd = TPUDetector(params, spec)
    td = TorchDetector(tparams, tdm.ModelSpec(different_dilation=True),
                       "cpu")
    levels = td._prep(ims[0])["levels"]
    assert [lv["hb"] * lv["wb"] >= 8000 for lv in levels] == [False, True]
    if static:
        jd.calibrate_int8(ims[:1])
        td.qstate = qstate_from_numpy(_numpy_qstate(jd.qstate))
        assert td._scale_groups(levels) is None
    else:
        assert td._scale_groups(levels[:1] * 2).tolist() == [0, 0, 2, 2]
        assert td._scale_groups(levels[1:] * 2).tolist() == [0, 1, 2, 3]
    if entry == "detect_many":
        for a, b in zip(td.detect_many(ims, 0.05),
                        jd.detect_many(ims, 0.05)):
            _rule(a[0], b[0])
    else:
        _rule(td.detect(ims[0], 0.05)[0][0], jd.detect(ims[0], 0.05)[0][0])


def test_dynamic_grouping_is_visible(skeletal):
    """The detection test above can see a wrong FLIP_SPLIT_PX grouping: the
    port's dynamic mode with the image and its mirror always apart, or
    always together, misses the rule against JAX at the right split on at
    least one side. Prints the matched fractions."""
    params, spec, tparams, ims = skeletal
    want = TPUDetector(params, spec).detect(ims[0], 0.05)[0][0]
    td = TorchDetector(tparams, tdm.ModelSpec(different_dilation=True),
                       "cpu")
    for split in (0, 10 ** 9):
        tcfg.TPU.FLIP_SPLIT_PX = split
        got = td.detect(ims[0], 0.05)[0][0]
        fwd, bwd = _match_fraction(got, want), _match_fraction(want, got)
        print(f"FLIP_SPLIT_PX {split}: matched {fwd:.3f} / {bwd:.3f}")
        assert min(fwd, bwd) < 0.99


def test_cli_int8_eval_calibrates(data_dir, monkeypatch, tmp_path):
    """``python -m smallhardface_tpu_torch --conf smallhardface-int8.toml
    --train false --test true`` on a synthetic WIDER tree (the skeletal
    net): test_net calibrates on the first INT8_CALIB_IMAGES images of the
    shard, then evaluates through the calibrated chain."""
    from smallhardface_tpu_torch.__main__ import main
    synth_wider.build(data_dir, n_images=4, im_size=96)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(jdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setitem(jcfg.MODEL.DIFFERENT_DILATION, "ENABLE", True)
    model = str(tmp_path / "weights.npz")
    _skeletal_weights(model)
    calibrated, chained = [], []
    calibrate = TorchDetector.calibrate_int8

    def spy(self, images):
        calibrated.append(list(images))
        return calibrate(self, images)
    monkeypatch.setattr(TorchDetector, "calibrate_int8", spy)
    _record(monkeypatch, tdm, "conv2d_int8_chain", chained,
            lambda t: t.dtype)
    saved = copy.deepcopy(tcfg)
    exp_dir = f"torch_port_int8_cli_{os.getpid()}"
    try:
        result = main([
            "--train", "false", "--test", "true", "--device", "cpu",
            "--conf", INT8_TOML, "--amend", "DATA_DIR", data_dir,
            "EXP_DIR", exp_dir, "TEST.MODEL", model,
            "TEST.SCALES", "[50, 90]", "TPU.INT8_CALIB_IMAGES", "2"])
        assert tcfg.TPU.PRECISION == "int8"
    finally:
        tcfg.clear()
        tcfg.update(saved)
        import shutil
        shutil.rmtree(os.path.join(REPO, "output", exp_dir),
                      ignore_errors=True)
    assert result.startswith("Easy: ")
    assert len(calibrated) == 1 and len(calibrated[0]) == 2
    assert all(p.endswith(".jpg") for p in calibrated[0])
    assert chained and torch.int8 in {d for _, d in chained}


def test_int8_serving_calibrates_at_startup(full, int8_cfg, tmp_path,
                                            caplog):
    """JAX test_int8_serving_calibrates_at_startup on the port: with
    calib_images the service builds a qstate at construction and serves;
    without them it serves the dynamic mode, with a warning."""
    _set(TEST__SCALES=[48], TEST__FLIP=False, TPU__TEST_BUCKET=64,
         TPU__PRECISION="int8", TPU__MASK_MODE="where")
    im = np.random.RandomState(1).randint(0, 255, (60, 90, 3), np.uint8)
    path = str(tmp_path / "calib.jpg")
    cv2.imwrite(path, im)
    body = cv2.imencode(".jpg", im)[1].tobytes()
    tree, spec = full["det"].tree(), full["det"].spec
    svc = tserve.DetectorService(tree, spec, calib_images=[path],
                                 device="cpu")
    assert svc.det.qstate is not None
    dets = svc.detect(body)
    assert dets.ndim == 2 and dets.shape[1] == 5
    with caplog.at_level(logging.WARNING):
        dyn = tserve.DetectorService(tree, spec, device="cpu")
    assert dyn.det.qstate is None
    assert any("calib-images" in r.message for r in caplog.records)
    assert dyn.detect(body).shape[1] == 5
