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
from smallhardface_tpu_torch.detect import (
    TorchDetector, linear_resize_weights)
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from tests.test_full_detect_golden import (  # noqa: F401 (golden_cfg)
    GOLDEN, THRESH, _fixture_inputs, _match_fraction, golden_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _agree(a, b):
    assert abs(a.shape[0] - b.shape[0]) <= max(2, 0.02 * b.shape[0])
    assert _match_fraction(a, b) >= 0.97
    assert _match_fraction(b, a) >= 0.97


@pytest.fixture
def port_dets(golden_cfg):
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


def test_port_matches_jax_detector(port_dets):
    """Same fixture through the JAX TPUDetector with the host vote
    (TPU.DEVICE_VOTE = False), the path the port implements."""
    im, spec, params, dets = port_dets
    from smallhardface_tpu.detect import TPUDetector
    cfg.TPU.DEVICE_VOTE = False
    want = TPUDetector(params, spec).detect(im, thresh=THRESH)[0][0]
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


def test_level_inputs_flip_and_padding(golden_cfg):
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
        x = det._level_input(img, lv)
        hb, wb, h_s, w_s = lv["hb"], lv["wb"], lv["h_s"], lv["w_s"]
        assert x.shape == (2, hb, wb, 3) and hb % 16 == 0 and wb % 16 == 0
        assert hb - 16 < h_s <= hb and wb - 16 < w_s <= wb
        assert not x[:, h_s:].any() and not x[:, :, w_s:].any()
        torch.testing.assert_close(x[1, :h_s, :w_s],
                                   x[0, :h_s, :w_s].flip(1))


def test_non_float32_precision_raises(golden_cfg):
    _, _, params = _fixture_inputs()
    saved = cfg.TPU.PRECISION
    try:
        for precision in ("bfloat16", "int8"):
            cfg.TPU.PRECISION = precision
            with pytest.raises(NotImplementedError, match="float32"):
                TorchDetector(None, tdm.ModelSpec(), "cpu")
    finally:
        cfg.TPU.PRECISION = saved


def test_demo_cli():
    """python -m smallhardface_tpu_torch in demo mode writes the picture."""
    exp_dir = f"torch_port_test_{os.getpid()}"
    root = os.path.join(REPO, "output", exp_dir)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "smallhardface_tpu_torch", "--train",
             "false", "--test", "true", "--conf",
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


@pytest.mark.parametrize("args,what", [
    (["--train", "true", "--test", "false"], "training"),
    (["--train", "false", "--test", "true"], "dataset evaluation"),
])
def test_cli_unported_branches_raise(args, what):
    from smallhardface_tpu_torch.__main__ import main
    saved = cfg.TEST.NO_CACHE
    try:
        with pytest.raises(NotImplementedError, match=what):
            main(args)
    finally:
        cfg.TEST.NO_CACHE = saved
