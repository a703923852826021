"""The port's whole detection path (smallhardface_tpu_torch/detect.py) on the
CPU against the JAX package's, on the golden fixture of
tests/test_full_detect_golden.py: demo.jpg at 200×160, PRNGKey-7 weights
with background-biased heads, scales [100, 300], flip TTA, BBOX_VOTE.

Detections are compared with that file's rule: ≥ 97 % of the rows of each
side have an IoU > 0.9, |Δscore| < 0.01 partner in the other, and the counts
agree within max(2, 2 %)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.detect import (
    TorchDetector, linear_resize_weights)
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
import torch_threads  # noqa: F401
from tests.test_full_detect_golden import (  # noqa: F401 (golden_cfg)
    GOLDEN, THRESH, _fixture_inputs, _match_fraction, golden_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _agree(a, b):
    assert abs(a.shape[0] - b.shape[0]) <= max(2, 0.02 * b.shape[0])
    assert _match_fraction(a, b) >= 0.97
    assert _match_fraction(b, a) >= 0.97


@pytest.fixture
def port_cfg(golden_cfg):
    """The golden fixture's TEST/TPU settings, set in the port's own config
    as golden_cfg sets them in the JAX package's."""
    saved_test, saved_tpu = tcfg.TEST.copy(), tcfg.TPU.copy()
    for k in ("SCALES", "FLIP", "NMS_METHOD", "NMS_THRESH", "SCORE_THRESH",
              "N_DETS_PER_MODULE"):
        tcfg.TEST[k] = cfg.TEST[k]
    for k in ("VOTE_CAP", "TEST_BUCKET", "DEVICE_VOTE", "HOST_PREPROC"):
        tcfg.TPU[k] = cfg.TPU[k]
    yield
    tcfg.TEST.update(saved_test)
    tcfg.TPU.update(saved_tpu)


@pytest.fixture
def port_dets(port_cfg):
    im, spec, params = _fixture_inputs()
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = TorchDetector(params_from_numpy(tree),
                        tdm.ModelSpec(different_dilation=True), "cpu")
    return im, spec, params, det.detect(im, thresh=THRESH)[0][0]


def test_port_matches_golden_fixture(port_dets):
    _, _, _, dets = port_dets
    golden = np.load(GOLDEN)["dets"]
    assert dets.shape[1] == 5 and len(golden) > 5
    _agree(dets, golden)


def test_port_matches_jax_detector(port_cfg):
    """Same fixture through the JAX TPUDetector and the port with the
    float64 host vote (TPU.DEVICE_VOTE = False) on both sides; the device
    vote is compared in tests/test_torch_port_vote.py."""
    im, spec, params = _fixture_inputs()
    from smallhardface_tpu.detect import TPUDetector
    cfg.TPU.DEVICE_VOTE = tcfg.TPU.DEVICE_VOTE = False
    want = TPUDetector(params, spec).detect(im, thresh=THRESH)[0][0]
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    dets = TorchDetector(params_from_numpy(tree),
                         tdm.ModelSpec(different_dilation=True),
                         "cpu").detect(im, thresh=THRESH)[0][0]
    _agree(dets, want)


@pytest.mark.parametrize("in_size,out_size,scale", [
    (96, 40, 0.4), (80, 101, 1.27), (160, 16, 0.1)])
def test_resize_weights_match_jax(in_size, out_size, scale):
    """The separable weights reproduce jax.image.scale_and_translate
    (method="linear", antialias=False) and cv2's INTER_LINEAR convention."""
    import cv2
    rng = np.random.RandomState(in_size)
    im = rng.randint(0, 255, (in_size, in_size + 8, 3)).astype(np.float32)
    out_w = int(round((in_size + 8) * scale))
    want = np.asarray(jax.image.scale_and_translate(
        jnp.asarray(im), (out_size, out_w, 3), (0, 1),
        scale=jnp.asarray([scale, scale], jnp.float32),
        translation=jnp.zeros((2,), jnp.float32),
        method="linear", antialias=False))
    wy = linear_resize_weights(in_size, out_size, scale)
    wx = linear_resize_weights(in_size + 8, out_w, scale)
    got = torch.einsum("hwc,ho,wp->opc", torch.from_numpy(im), wy,
                       wx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    ref = cv2.resize(im, None, fx=scale, fy=scale,
                     interpolation=cv2.INTER_LINEAR)
    h, w = min(ref.shape[0], out_size), min(ref.shape[1], out_w)
    # cv2's last rows may sample past the input, which jax weights zero
    np.testing.assert_allclose(got[:h - 1, :w - 1], ref[:h - 1, :w - 1],
                               atol=0.6)


def test_level_inputs_flip_and_padding(port_cfg):
    """Level shapes are the exact ×16 round-up of the resized extent, the
    padding is zero, and the mirror reflects about the level's own width."""
    im, _, params = _fixture_inputs()
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = TorchDetector(params_from_numpy(tree), tdm.ModelSpec(), "cpu")
    p = det._prep(im)
    img = torch.from_numpy(p["padded"]).float()
    assert p["padded"].shape[:2] == (160, 208)
    for lv in p["levels"]:
        x = det._level_batch(img[None], [lv], lv["hb"], lv["wb"])
        hb, wb, h_s, w_s = lv["hb"], lv["wb"], lv["h_s"], lv["w_s"]
        assert x.shape == (2, hb, wb, 3) and hb % 16 == 0 and wb % 16 == 0
        assert hb - 16 < h_s <= hb and wb - 16 < w_s <= wb
        assert not x[:, h_s:].any() and not x[:, :, w_s:].any()
        torch.testing.assert_close(x[1, :h_s, :w_s],
                                   x[0, :h_s, :w_s].flip(1))


def test_non_float32_precision_raises(port_cfg):
    """bfloat16 is ported (tests/test_torch_port_bf16.py) and builds; a
    precision the JAX package has no mode for raises; int8 is ported
    (tests/test_torch_port_int8.py) and raises, as the JAX detector does,
    with a "band" mask mode."""
    saved = tcfg.TPU.PRECISION, tcfg.TPU.MASK_MODE
    _, _, params = _fixture_inputs()
    tree = params_from_numpy({k: {kk: np.asarray(vv) for kk, vv in v.items()}
                              for k, v in params.items()})
    try:
        tcfg.TPU.PRECISION = "bfloat16"
        assert TorchDetector(tree, tdm.ModelSpec(),
                             "cpu").precision == "bfloat16"
        tcfg.TPU.PRECISION = "float16"
        with pytest.raises(ValueError, match="float16"):
            TorchDetector(tree, tdm.ModelSpec(), "cpu")
        tcfg.TPU.PRECISION, tcfg.TPU.MASK_MODE = "int8", "band"
        with pytest.raises(ValueError, match="MASK_MODE"):
            TorchDetector(None, tdm.ModelSpec(), "cpu")
    finally:
        tcfg.TPU.PRECISION, tcfg.TPU.MASK_MODE = saved


def test_demo_cli():
    """python -m smallhardface_tpu_torch --device cpu in demo mode writes the
    picture."""
    exp_dir = f"torch_port_test_{os.getpid()}"
    root = os.path.join(REPO, "output", exp_dir)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "smallhardface_tpu_torch", "--device",
             "cpu", "--train", "false", "--test", "true", "--conf",
             os.path.join(REPO, "smallhardface_tpu", "configs",
                          "smallhardface.toml"),
             "--amend", "TEST.DEMO.ENABLE", "True", "TEST.SCALES", "[100]",
             "EXP_DIR", exp_dir],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "Demo result written to" in proc.stderr
        out = proc.stderr.split("Demo result written to ")[1].split(" ")[0]
        assert os.path.exists(out)
        assert out.startswith(os.path.join(root, "demo"))
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("args,error,what", [
    (["--train", "true", "--test", "false", "--amend",
      "TPU.SPATIAL_DEVICES", "2", "TRAIN.ITERS", "1", "TRAIN.ITERSIZE", "1",
      "TRAIN.PRETRAINED", "", "TRAIN.SCALES.SHORT_SIDE", "[64]",
      "TRAIN.SCALES.MAX_SIZE", "128", "TPU.MAX_GT_BUCKETS", "[8]"], None,
     "Training over a spatial unit of 2 devices: cpu, cpu"),
    (["--train", "false", "--test", "true", "--amend",
      "TPU.SPATIAL_DEVICES", "2"], ValueError,
     "must divide the local device count"),
], ids=["args0-training", "args1-dataset evaluation"])
def test_cli_unported_branches_raise(args, error, what, tmp_path,
                                     monkeypatch, caplog):
    """Both branches of the command line are ported, spatial training
    (``--amend TPU.SPATIAL_DEVICES 2``) included: with two local "devices"
    (a monkeypatched ``spatial.local_devices``) the full-width net trains
    one iteration over a unit of both and writes final.npz. What they do
    not cover raises: a spatial evaluation unit of 2 over the one CPU, with
    JAX's words (spatial evaluation itself is ported,
    tests/test_torch_port_spatial.py). Batched evaluation (TPU.EVAL_BATCH
    > 1, tests/test_torch_port_batch.py) and evaluation in bfloat16
    (tests/test_torch_port_bf16.py) are ported."""
    from smallhardface_tpu_torch.__main__ import main
    from smallhardface_tpu_torch.parallel import spatial
    import copy
    import glob
    import logging
    saved = copy.deepcopy(tcfg)
    exp_dir = f"torch_port_raise_{os.getpid()}"
    try:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        import synth_wider
        synth_wider.build(str(tmp_path), n_images=1, im_size=64)
        argv = (["--device", "cpu"] + args
                + ["EXP_DIR", exp_dir, "DATA_DIR", str(tmp_path)])
        if error is None:
            cpu = torch.device("cpu")
            monkeypatch.setattr(spatial, "local_devices",
                                lambda d: [cpu, cpu])
            with caplog.at_level(logging.INFO):
                main(argv)
            assert what in caplog.text
            assert glob.glob(os.path.join(REPO, "output", exp_dir, "*", "*",
                                          "final.npz"))
        else:
            with pytest.raises(error, match=what):
                main(argv)
    finally:
        tcfg.clear()
        tcfg.update(saved)
        shutil.rmtree(os.path.join(REPO, "output", exp_dir),
                      ignore_errors=True)
