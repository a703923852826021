"""Batched inference in the port (``TorchDetector.detect_many``, the
per-item valid extents of ``models/layers.zero_outside``,
``Detector.forward``, ``ops/stem.fused_stem`` and
``ops/decode.decode_proposals_batch``, the batched vote of
``ops/nms_device``, and ``TPU.EVAL_BATCH`` in ``test_runner``) on the CPU
against the JAX package's, with JAX-initialised weights converted by
``io/weights.params_from_numpy`` and inputs from numpy seeds.

Tolerances:

- detect_many against the port's own detect: equal counts, rtol 1e-5 /
  atol 1e-4 (JAX's own tests/test_detect_many.py: the batch sums its
  resize and convolutions in other orders);
- against JAX: the golden fixture's rule (tests/test_torch_port_slice.py:
  _agree), as the port's detect is held against JAX's;
- the stem against the Pallas kernel in interpret mode: rtol 2e-2, atol
  1 % of the peak (tests/test_torch_port_stem.py: the kernel feeds its
  dots bf16); the forward: rtol 1e-4, atol 1e-4 of the peak
  (tests/test_torch_port_forward.py);
- decode: counts and scores equal to the bit, boxes within rtol 1e-6 /
  atol 1e-4 (tests/test_torch_port_decode.py: exp in another library);
  the vote: its rows and scores equal to the bit, its merged boxes within
  1e-6 of the largest coordinate (tests/test_torch_port_vote.py).
"""

import copy
import logging
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.detect import TPUDetector
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.ops import decode as jdecode
from smallhardface_tpu.ops import nms_jax
from smallhardface_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.models import layers
from smallhardface_tpu_torch.ops import decode as tdecode
from smallhardface_tpu_torch.ops import nms_device, stem
import torch_threads  # noqa: F401
from tests.test_torch_port_eval import (  # noqa: F401 (fixtures)
    _skeletal_weights, data_dir, eval_cfg, synth_wider)
from tests.test_torch_port_slice import _agree, port_cfg  # noqa: F401
from tests.test_torch_port_stem import _torch_w, weights  # noqa: F401
from tests.test_full_detect_golden import golden_cfg  # noqa: F401
from tests.test_torch_port_vote import BOX_TOL, _sorted_dets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def many_cfg():
    """tests/test_detect_many.py's settings in both packages."""
    saved = [(c, copy.deepcopy(c.TEST), copy.deepcopy(c.TPU))
             for c in (jcfg, tcfg)]
    for c in (jcfg, tcfg):
        c.TEST.SCALES = [48]
        c.TEST.MAX_SIZE = 96
        c.TEST.FLIP = True
        c.TEST.NMS_METHOD = "BBOX_VOTE"
        c.TPU.VOTE_CAP = 2048
        c.TPU.TEST_BUCKET = 64
        c.TPU.DEVICE_VOTE = True
        c.TPU.HOST_PREPROC = False
    yield
    for c, test, tpu in saved:
        c.TEST.update(test)
        c.TPU.update(tpu)


def _params():
    spec = jdm.ModelSpec(different_dilation=True)
    params = jdm.init_params(jax.random.PRNGKey(2), spec)
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    return spec, params, params_from_numpy(tree)


def _images():
    """Two bucket groups: 3 images of one padded size, 2 of another."""
    rng = np.random.RandomState(11)
    return ([rng.randint(0, 255, (50, 60, 3)).astype(np.uint8)
             for _ in range(3)]
            + [rng.randint(0, 255, (80, 100, 3)).astype(np.uint8)
               for _ in range(2)])


def _same(got, want):
    for g, w in zip(got, want):
        assert g[0].shape == w[0].shape
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5, atol=1e-4)


# ---- per-item valid extents ----

def test_zero_outside_per_item_equals_one_extent_per_item():
    h = torch.randn(3, 4, 9, 11).contiguous(memory_format=torch.channels_last)
    h[0, 0, 0, 5] = float("nan")        # outside image 0's extent
    vh, vw = torch.tensor([9, 5, 0]), torch.tensor([3, 11, 7])
    got = layers.zero_outside(h, vh, vw)
    for i in range(3):
        want = layers.zero_outside(h[i:i + 1], int(vh[i]), int(vw[i]))
        assert torch.equal(got[i:i + 1], want)
        assert not got[i, :, int(vh[i]):].any()
        assert not got[i, :, :, int(vw[i]):].any()
    assert got.is_contiguous(memory_format=torch.channels_last)
    # one extent for the batch: exact zeros outside, the rest untouched
    one = layers.zero_outside(h, 5, 4)
    assert torch.equal(one[:, :, :5, :4], h[:, :, :5, :4])
    assert not one[:, :, 5:].any() and not one[:, :, :, 4:].any()


def test_forward_per_item_extents_matches_jax_where_under_vmap():
    """Two items in a (2, 64, 128) bucket with their own extents and
    garbage beyond them: the port's forward equals JAX mask_mode="where"
    per item inside each item's grid."""
    spec, params, tparams = _params()
    det = tdm.Detector(tparams, tdm.ModelSpec(different_dilation=True), "cpu")
    x = np.random.RandomState(3).randn(2, 64, 128, 3).astype(np.float32) * 30
    ext = np.array([[48, 64], [64, 112]], np.int32)
    for i, (vh, vw) in enumerate(ext):
        x[i, vh:] = 1e3
        x[i, :, vw:] = -1e3
    want = jax.vmap(lambda xi, vh, vw: jdm.forward(
        params, xi[None], spec, valid_hw=(vh, vw), mask_mode="where"))(
        jnp.asarray(x), jnp.asarray(ext[:, 0]), jnp.asarray(ext[:, 1]))
    with torch.inference_mode():
        got = det(torch.from_numpy(x), valid_hw=(
            torch.from_numpy(ext[:, 0]), torch.from_numpy(ext[:, 1])))
    for k in ("cls_logits", "bbox_deltas"):
        for i, (vh, vw) in enumerate(ext):
            g = got[k][i, :vh // 8, :vw // 8].numpy()
            w = np.asarray(want[k])[i, 0, :vh // 8, :vw // 8]
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max())


def test_stem_per_image_extents_match_jax_pallas_per_image(weights):
    """The plain stem with one extent per image against the JAX Pallas
    kernel (interpret mode) called per image with that image's valid_hw,
    and against itself called per image (within 1e-5 of the peak: the CPU
    convolution sums a batch in another order than one image)."""
    x = np.random.RandomState(4).randn(3, 64, 128, 3).astype(np.float32) * 10
    ext = [(48, 96), (64, 128), (32, 40)]
    vh = torch.tensor([e[0] for e in ext])
    vw = torch.tensor([e[1] for e in ext])
    got = stem.fused_stem(torch.from_numpy(x), *_torch_w(weights),
                          valid_hw=(vh, vw)).numpy()
    for i, (h, w) in enumerate(ext):
        want = np.asarray(jax_fused_stem(
            jnp.asarray(x[i:i + 1]), *map(jnp.asarray, weights),
            valid_hw=(h, w), interpret=True))[0, :h // 2, :w // 2]
        np.testing.assert_allclose(got[i, :h // 2, :w // 2], want, rtol=2e-2,
                                   atol=0.01 * np.abs(want).max())
        alone = stem.fused_stem(torch.from_numpy(x[i:i + 1]),
                                *_torch_w(weights), valid_hw=(h, w)).numpy()
        np.testing.assert_allclose(got[i], alone[0], rtol=1e-5,
                                   atol=1e-5 * np.abs(alone).max())


def test_stem_per_image_extents_refuse_weight_grads(weights):
    """Per-image extents are for detection: with a weight that needs a
    gradient the stem raises instead of running another backward."""
    x = torch.zeros((2, 16, 32, 3))
    w = [t.requires_grad_(True) for t in _torch_w(weights)]
    ext = (torch.tensor([16, 8]), torch.tensor([32, 16]))
    with pytest.raises(NotImplementedError, match="per-image"):
        stem.fused_stem(x, *w, valid_hw=ext)
    with torch.no_grad():
        assert stem.fused_stem(x, *w, valid_hw=ext).shape == (2, 8, 16, 64)


def test_decode_per_image_matches_jax_vmap():
    rng = np.random.RandomState(5)
    B, h, w, A = 4, 6, 8, 3
    fg = rng.uniform(0, 1, (B, h, w, A)).astype(np.float32)
    deltas = (rng.randn(B, h, w, A, 4) * 0.4).astype(np.float32)
    base = np.array([[-8, -8, 23, 23], [-24, -24, 39, 39],
                     [-56, -56, 71, 71]], np.float32)
    im_h = np.array([40, 48, 20, 33], np.float32)
    im_w = np.array([60, 64, 31, 50], np.float32)
    vh = np.array([5, 6, 3, 5], np.int32)
    vw = np.array([8, 8, 4, 7], np.int32)
    kw = dict(feat_stride=8, score_thresh=0.4, min_size=0.0, capacity=40)
    want = jax.vmap(lambda f, d, a, b, c, e: jdecode.decode_proposals_batch(
        f[None], d[None], base, im_h=a, im_w=b, valid_h=c, valid_w=e,
        **kw))(*map(jnp.asarray, (fg, deltas, im_h, im_w, vh, vw)))
    got = tdecode.decode_proposals_batch(
        torch.from_numpy(fg), torch.from_numpy(deltas), base,
        im_h=torch.from_numpy(im_h), im_w=torch.from_numpy(im_w),
        valid_h=torch.from_numpy(vh), valid_w=torch.from_numpy(vw), **kw)
    boxes, scores, counts = (np.asarray(a)[:, 0] for a in want)
    np.testing.assert_array_equal(got[2].numpy(), counts)
    for i in range(B):
        n = int(counts[i])
        np.testing.assert_array_equal(got[1][i, :n].numpy(), scores[i, :n])
        np.testing.assert_allclose(got[0][i, :n].numpy(), boxes[i, :n],
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
def test_batched_vote_matches_jax_vmap(method):
    """The plain vote over a batch of images against the JAX functions
    under jax.vmap, and against itself per image."""
    rng = np.random.RandomState(6)
    n_valid = np.array([40, 0, 120, 7], np.int32)
    dets = np.stack([_sorted_dets(rng, n, 120 - n) for n in n_valid])
    thresh = np.float32(0.4)
    if method == "BBOX_VOTE":
        out, cnt = jax.vmap(nms_jax.bbox_vote_device, (0, 0, None))(
            jnp.asarray(dets), jnp.asarray(n_valid), thresh)
        want = [np.asarray(o)[:int(c)] for o, c in zip(out, cnt)]
    else:
        idx, _, n_keep = jax.vmap(
            lambda d, n: nms_jax.nms_device(d[:, :4], d[:, 4], thresh,
                                            n_valid=n))(
            jnp.asarray(dets), jnp.asarray(n_valid))
        want = [d[np.asarray(i)[:int(k)]] for d, i, k in zip(dets, idx,
                                                              n_keep)]
    fn = (nms_device.bbox_vote_device if method == "BBOX_VOTE"
          else nms_device.nms_device)
    out, n_out = fn(torch.from_numpy(dets), torch.from_numpy(n_valid),
                    float(thresh))
    assert out.shape == dets.shape and n_out.shape == (4,)
    for i, w in enumerate(want):
        g = out[i, :int(n_out[i])].numpy()
        assert g.shape == w.shape
        assert not out[i, int(n_out[i]):].any()
        np.testing.assert_array_equal(g[:, 4], w[:, 4])
        peak = max(np.abs(dets[i, :, :4]).max(), 1.0)
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0,
                                   atol=BOX_TOL * peak)
        one, n_one = fn(torch.from_numpy(dets[i]),
                        torch.tensor(int(n_valid[i]), dtype=torch.int32),
                        float(thresh))
        assert int(n_one) == int(n_out[i])
        assert torch.equal(one, out[i])


# ---- detect_many ----

def test_prep_key_groups_by_bucketed_shape(many_cfg):
    _, _, tparams = _params()
    det = TorchDetector(tparams, tdm.ModelSpec(different_dilation=True),
                        "cpu")
    keys = [det._prep(im)["key"] for im in _images()]
    assert keys[0] == keys[1] == keys[2] != keys[3] == keys[4]
    assert keys[0][:2] == (64, 64) and keys[3][:2] == (128, 128)
    p = det._prep(_images()[3])
    lv, = p["levels"]
    assert (lv["hb"], lv["wb"], lv["bh"], lv["bw"]) == (48, 64, 64, 64)
    assert p["padded"].shape == (80, 112, 3)


@pytest.mark.parametrize("device_vote", [True, False],
                         ids=["device_vote", "host_vote"])
def test_detect_many_matches_port_detect(many_cfg, device_vote):
    """Two bucket groups (3 and 2 images), whole and chunked by
    max_batch=2, against the port's own per-image detect."""
    tcfg.TPU.DEVICE_VOTE = device_vote
    _, _, tparams = _params()
    det = TorchDetector(tparams, tdm.ModelSpec(different_dilation=True),
                        "cpu")
    ims = _images()
    singles = [det.detect(im, thresh=0.05)[0] for im in ims]
    launches = nms_device.bbox_vote_device.launches
    batched = det.detect_many(ims, thresh=0.05)
    assert len(batched) == len(ims)
    _same(batched, singles)
    _same(det.detect_many(ims, thresh=0.05, max_batch=2), singles)
    assert all(len(s[0]) > 1 for s in singles)
    # the CPU path counts no kernel launch
    assert nms_device.bbox_vote_device.launches == launches


@pytest.mark.parametrize("device_vote", [True, False],
                         ids=["device_vote", "host_vote"])
def test_detect_many_matches_jax(many_cfg, device_vote):
    jcfg.TPU.DEVICE_VOTE = tcfg.TPU.DEVICE_VOTE = device_vote
    spec, params, tparams = _params()
    ims = _images()
    want = TPUDetector(params, spec).detect_many(ims, thresh=0.05,
                                                 max_batch=2)
    got = TorchDetector(tparams, tdm.ModelSpec(different_dilation=True),
                        "cpu").detect_many(ims, thresh=0.05, max_batch=2)
    for g, w in zip(got, want):
        _agree(g[0], w[0])


def test_detect_many_prod_fixture_matches_golden(many_cfg):
    """detect_many at production shapes (scales [100, 300, 1000] with flip,
    the per-module cap binding) on tests/golden_detect_prod.npz: the
    crowded collage and its mirror as one bucketed batch of two, each held
    to the independent oracle's detections (the mirror's boxes mirrored
    back) by tests/test_full_detect_golden.py's prod rule."""
    from tests.test_full_detect_golden import (
        GOLDEN_PROD, PROD_SCALES, THRESH, _match_fraction,
        _prod_fixture_inputs)
    tcfg.TEST.SCALES = list(PROD_SCALES)
    tcfg.TEST.NMS_THRESH = 0.4
    tcfg.TEST.SCORE_THRESH = 0.002
    tcfg.TEST.N_DETS_PER_MODULE = 10000
    tcfg.TPU.VOTE_CAP = 16384
    tcfg.TPU.TEST_BUCKET = 128
    golden = np.load(GOLDEN_PROD)["dets"]
    im, _, params = _prod_fixture_inputs()
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = TorchDetector(params_from_numpy(tree),
                        tdm.ModelSpec(different_dilation=True), "cpu")
    mirror = np.ascontiguousarray(im[:, ::-1])
    assert det._prep(im)["key"] == det._prep(mirror)["key"]
    got, got_mirror = det.detect_many([im, mirror], thresh=THRESH)
    back = got_mirror[0].copy()
    back[:, [0, 2]] = im.shape[1] - back[:, [2, 0]]
    for dets in (got[0], back):
        assert abs(dets.shape[0] - golden.shape[0]) <= max(
            3, 0.03 * golden.shape[0])
        assert _match_fraction(golden, dets) >= 0.95
        assert _match_fraction(dets, golden) >= 0.95


def test_detect_many_host_preproc_falls_back(many_cfg, caplog):
    """Under TPU.HOST_PREPROC detect_many runs detect per image, warns
    once, and refuses score_thresh (JAX detect.py:629-641)."""
    tcfg.TPU.HOST_PREPROC = True
    _, _, tparams = _params()
    det = TorchDetector(tparams, tdm.ModelSpec(different_dilation=True),
                        "cpu")
    ims = _images()[:2]
    with caplog.at_level(logging.WARNING, "smallhardface_tpu_torch.detect"):
        batched = det.detect_many(ims, thresh=0.05)
        det.detect_many(ims[:1], thresh=0.05)
    assert sum("HOST_PREPROC" in r.message for r in caplog.records) == 1
    for one, many in zip([det.detect(im, 0.05)[0] for im in ims], batched):
        np.testing.assert_array_equal(many[0], one[0])
    with pytest.raises(ValueError, match="HOST_PREPROC"):
        det.detect_many(ims, thresh=0.05, score_thresh=0.1)


def test_test_net_eval_batch_matches_one_by_one_and_jax(
        eval_cfg, data_dir, tmp_path, monkeypatch):
    """test_net over five synthetic WIDER val images with TPU.EVAL_BATCH 2
    (two detect_many batches and one image left over): the same
    detections.pkl as with EVAL_BATCH 1 (rtol 1e-5, atol 1e-4), and as the
    JAX test_runner with EVAL_BATCH 2 (the golden rule)."""
    from smallhardface_tpu import test_runner as jtr
    from smallhardface_tpu.datasets.factory import get_imdb as jget
    from smallhardface_tpu_torch import test_runner as ttr
    from smallhardface_tpu_torch.datasets.factory import get_imdb as tget
    synth_wider.build(data_dir, n_images=5, im_size=96)
    model = str(tmp_path / "weights.npz")
    _skeletal_weights(model)
    for c in (jcfg, tcfg):
        monkeypatch.setitem(c.TEST, "MODEL", model)
    one = jax.local_devices()[:1]
    monkeypatch.setattr(jtr.jax, "local_devices", lambda: one)
    calls = []
    many = TorchDetector.detect_many
    monkeypatch.setattr(TorchDetector, "detect_many", lambda self, ims, *a,
                        **k: calls.append(len(ims)) or many(self, ims, *a,
                                                            **k))
    dets = {}
    for name, batch in (("port1", 1), ("port2", 2), ("jax2", 2)):
        out = str(tmp_path / name)
        os.makedirs(out)
        monkeypatch.setitem(tcfg.TPU, "EVAL_BATCH", batch)
        monkeypatch.setitem(jcfg.TPU, "EVAL_BATCH", batch)
        if name == "jax2":
            jtr.test_net(jget("wider_val"), out, no_cache=False)
        else:
            ttr.test_net(tget("wider_val"), out, no_cache=False,
                         device="cpu")
        with open(os.path.join(out, "detections.pkl"), "rb") as f:
            dets[name] = pickle.load(f)[1]
    assert calls == [2, 2]
    assert len(dets["port2"]) == 5
    _same([[d] for d in dets["port2"]], [[d] for d in dets["port1"]])
    for a, b in zip(dets["port2"], dets["jax2"]):
        _agree(a, b)
    assert any(len(b) > 1 for b in dets["port1"])
