"""The port's training loader (smallhardface_tpu_torch/train/loader.py)
against the JAX package's, both seeded from RNG_SEED with the same roidb of
JPEGs written by cv2 and the same settings in their own configs:

- the same index sequence, scales, crops and gt boxes (exact);
- the same pixels with augmentation on, to the cv2 float conventions the
  port re-implements in numpy (BGR↔HSV, the INTER_LINEAR downscale): at
  least 99.9 % of the uint8 values equal and the rest within ±1;
- the sampler's state_dict round trip replays the same stream;
- mark_easy with smooth and non-smooth skipping gives the JAX epochs.
"""

import pickle

import cv2
import numpy as np
import pytest

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.train.loader import RoIDataLoader as JaxLoader
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.train import loader as tloader
import torch_threads  # noqa: F401

SETTINGS = {
    ("TRAIN", "SCALES", "SHORT_SIDE"): [64, 240],
    ("TRAIN", "SCALES", "MAX_SIZE"): 400,
    ("TRAIN", "AUGMENT", "ENABLE"): True,
    ("TRAIN", "DISABLE_EASY_IMAGE", "ENABLE"): True,
    ("TRAIN", "DISABLE_EASY_IMAGE", "PROB"): 0.7,
}


def _set(cfg, key, value):
    d = cfg
    for k in key[:-1]:
        d = d[k]
    old = d[key[-1]]
    d[key[-1]] = value
    return old


@pytest.fixture
def both_cfgs():
    saved = {}
    for key, value in SETTINGS.items():
        saved[key] = (_set(jcfg, key, value), _set(tcfg, key, value))
    yield
    for key, (jv, tv) in saved.items():
        _set(jcfg, key, jv)
        _set(tcfg, key, tv)


def _roidb(tmp_path, n=6):
    rng = np.random.RandomState(1)
    roidb = []
    for i in range(n):
        h, w = (120, 160) if i % 3 else (160, 120)
        im = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        boxes = []
        for j in range(1 + i % 3):
            x1, y1 = 8 + 30 * j, 10 + 20 * j
            im[y1:y1 + 24, x1:x1 + 24] = (250, 200, 30 * j)
            boxes.append([x1, y1, x1 + 23, y1 + 23])
        path = str(tmp_path / f"im{i}.jpg")
        cv2.imwrite(path, im)
        boxes = np.array(boxes, np.float64)
        for flipped in (False, True):
            b = boxes.copy()
            if flipped:
                b[:, [0, 2]] = w - 1 - boxes[:, [2, 0]]
            roidb.append({"image": path, "flipped": flipped, "boxes": b,
                          "gt_classes": np.ones(len(b), np.int32),
                          "width": w, "height": h})
    return roidb


def _compare(a, b):
    for k in ("im_idx", "crop", "height", "width", "im_scale"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["gt_boxes"], b["gt_boxes"])
    assert a["data"].shape == b["data"].shape
    diff = np.abs(a["data"].astype(np.int16) - b["data"].astype(np.int16))
    assert diff.max() <= 1
    return diff.size, int((diff != 0).sum())


def test_stream_and_pixels_match_jax(tmp_path, both_cfgs):
    roidb = _roidb(tmp_path)
    jl, tl = JaxLoader(roidb), tloader.RoIDataLoader(roidb)
    total = differ = 0
    for k in range(16):
        n, d = _compare(jl.get_minibatch(k % 2), tl.get_minibatch(k % 2))
        total, differ = total + n, differ + d
    assert differ <= 1e-3 * total, (differ, total)


def test_decoded_arrays_read_like_paths(tmp_path, both_cfgs):
    """A roidb entry may carry the decoded uint8 BGR array itself."""
    roidb = _roidb(tmp_path, n=3)
    arrays = [dict(e, image=cv2.imread(e["image"])) for e in roidb]
    a, b = tloader.RoIDataLoader(roidb), tloader.RoIDataLoader(arrays)
    for k in range(6):
        x, y = a.get_minibatch(k % 2), b.get_minibatch(k % 2)
        np.testing.assert_array_equal(x["data"], y["data"])


def test_state_dict_round_trip(tmp_path, both_cfgs):
    roidb = _roidb(tmp_path)
    ld = tloader.RoIDataLoader(roidb)
    for k in range(5):
        ld.get_minibatch(k % 2)
    ld.mark_easy(3)
    state = ld.state_dict()
    want = [ld.get_minibatch(k % 2) for k in range(9)]
    fresh = tloader.RoIDataLoader(roidb)
    fresh.load_state_dict(state)
    for w, g in zip(want, [fresh.get_minibatch(k % 2) for k in range(9)]):
        assert w["im_idx"] == g["im_idx"] and w["crop"] == g["crop"]
        np.testing.assert_array_equal(w["data"], g["data"])


@pytest.mark.parametrize("smooth", [True, False])
def test_mark_easy_epochs_match_jax(tmp_path, both_cfgs, smooth):
    roidb = _roidb(tmp_path)
    old = jcfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH, tcfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH
    jcfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH = smooth
    tcfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH = smooth
    try:
        jl, tl = JaxLoader(roidb), tloader.RoIDataLoader(roidb)
        seen_j, seen_t = [], []
        for epoch in range(4):
            for _ in range(len(roidb)):
                seen_j.append(jl._next_index())
                seen_t.append(tl._next_index())
            for i in (0, 5, 7):
                jl.mark_easy(i)
                tl.mark_easy(i)
        assert seen_t == seen_j
        assert tl.state_dict()["mining"] == jl.state_dict()["mining"]
        assert len(tl._perm) < len(roidb)     # some image was skipped
    finally:
        jcfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH, \
            tcfg.TRAIN.DISABLE_EASY_IMAGE.SMOOTH = old


def test_distortion_matches_jax(both_cfgs):
    """_distortion (the draws, then the pixels) against the JAX one from
    the same RandomState, over seeds that take both orders of the
    contrast-first coin: the same draws in the same order (the states
    after it equal) and the pixels within ±1."""
    from smallhardface_tpu.train.loader import _distortion as jax_distortion
    coins = set()
    for seed in range(8):
        im = np.random.RandomState(100 + seed).randint(
            0, 256, (40, 56, 3)).astype(np.float32)
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jax_distortion(im.copy(), rj)
        got = tloader._distortion(im.copy(), rt)
        assert pickle.dumps(rj.get_state()) == pickle.dumps(rt.get_state())
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1
        coins.add(tloader.draw_distortion(
            np.random.RandomState(seed))["contrast_first"])
    assert coins == {False, True}


def test_hsv_round_trip_matches_cv2():
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (64, 96, 3)).astype(np.float32)
    im[:8] = 128.0                            # grey: S = 0
    im[8:16, :, 0] = 0.0
    hsv = tloader.bgr_to_hsv(im)
    np.testing.assert_allclose(hsv, cv2.cvtColor(im, cv2.COLOR_BGR2HSV),
                               rtol=0, atol=1e-3)
    hsv[..., 0] = (hsv[..., 0] + 17.0) % 360.0
    hsv[..., 1] *= 0.7
    np.testing.assert_allclose(tloader.hsv_to_bgr(hsv),
                               cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR),
                               rtol=0, atol=1e-3)
