"""The port's box decode (smallhardface_tpu_torch/ops/bbox.py, decode.py)
against the JAX package's bbox_jax and decode_proposals_batch(fast_k=0)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from smallhardface_tpu.ops import anchors, bbox_jax
from smallhardface_tpu.ops import decode as jdecode
from smallhardface_tpu_torch.ops import bbox as tbbox
from smallhardface_tpu_torch.ops import decode as tdecode

BASE = anchors.generate_anchors(base_size=16, ratios=[1], scales=[1, 2, 4],
                                shifts=[0], strides=[8, 8, 8])


def _both(fg, deltas, **kw):
    jb, js, jn = jdecode.decode_proposals_batch(
        jnp.asarray(fg), jnp.asarray(deltas), BASE, fast_k=0, **kw)
    tb, ts, tn = tdecode.decode_proposals_batch(
        torch.from_numpy(fg), torch.from_numpy(deltas), BASE, **kw)
    return ((np.asarray(jb), np.asarray(js), np.asarray(jn)),
            (tb.numpy(), ts.numpy(), tn.numpy()))


def test_bbox_transform_inv_and_clip(rng):
    boxes = (rng.rand(50, 4) * 100).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    deltas = (rng.randn(50, 4) * 0.5).astype(np.float32)
    deltas[:5, 2] = 60.0                 # the > 50 → 5 overflow clamp
    deltas[5:10, 3] = 51.0
    want = np.asarray(bbox_jax.bbox_transform_inv(jnp.asarray(boxes),
                                                  jnp.asarray(deltas)))
    got = tbbox.bbox_transform_inv(torch.from_numpy(boxes),
                                   torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    want = np.asarray(bbox_jax.clip_boxes(jnp.asarray(want), 70.0, 90.0))
    got = tbbox.clip_boxes(torch.from_numpy(got), 70.0, 90.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_dense_anchor_grid(rng):
    want = np.asarray(jdecode.dense_anchor_grid(5, 7, BASE, 8))
    got = tdecode.dense_anchor_grid(5, 7, BASE, 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh,cap", [(0.5, 50), (0.0, 10000), (0.3, 7)])
def test_decode_batch_matches_jax(rng, thresh, cap):
    """Random scores, bucket padding beyond the valid grid, flip-pair
    batch: same boxes, scores and keep counts on every live row."""
    h, w = 7, 9
    fg = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    deltas = (rng.randn(2, h, w, 3, 4) * 0.3).astype(np.float32)
    kw = dict(feat_stride=8, im_h=37.0, im_w=51.0, valid_h=5, valid_w=7,
              score_thresh=thresh, min_size=0.0, capacity=cap)
    (jb, js, jn), (tb, ts, tn) = _both(fg, deltas, **kw)
    np.testing.assert_array_equal(tn, jn)
    assert tb.shape == jb.shape and ts.shape == js.shape
    for i in range(2):
        n = int(jn[i])
        np.testing.assert_array_equal(ts[i, :n], js[i, :n])
        np.testing.assert_allclose(tb[i, :n], jb[i, :n], rtol=1e-6,
                                   atol=1e-4)


def test_decode_tie_order_lower_index_first(rng):
    """Planted ties (random-init softmax scores do tie): both packages keep
    the lower flat index first, so the same boxes survive the cap."""
    h, w = 4, 5
    fg = np.full((1, h, w, 3), 0.25, np.float32)
    fg[0, 1, 2, :] = 0.75
    fg[0, 3, 0, 1] = 0.75
    fg[0, 0, 4, 2] = 0.75
    deltas = (rng.randn(1, h, w, 3, 4) * 0.3).astype(np.float32)
    kw = dict(feat_stride=8, im_h=1e4, im_w=1e4, valid_h=h, valid_w=w,
              score_thresh=0.5, min_size=0.0, capacity=8)
    (jb, js, jn), (tb, ts, tn) = _both(fg, deltas, **kw)
    assert int(tn[0]) == int(jn[0]) == 5
    # 5 planted 0.75s, then the first three 0.25s in index order
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-4)
    flat = fg.reshape(-1)
    order = np.argsort(-flat, kind="stable")[:8]
    boxes = tbbox.clip_boxes(tbbox.bbox_transform_inv(
        tdecode.dense_anchor_grid(h, w, BASE, 8).reshape(-1, 4),
        torch.from_numpy(deltas.reshape(-1, 4))), 1e4, 1e4).numpy()
    np.testing.assert_allclose(tb[0], boxes[order], rtol=1e-6, atol=1e-4)


def test_decode_keep_at_least_one():
    h, w = 4, 4
    fg = np.full((1, h, w, 3), 0.001, np.float32)
    fg[0, 2, 3, 1] = 0.0015              # best, still below the threshold
    deltas = np.zeros((1, h, w, 3, 4), np.float32)
    kw = dict(feat_stride=8, im_h=32.0, im_w=32.0, valid_h=h, valid_w=w,
              score_thresh=0.002, min_size=0.0, capacity=10)
    (jb, js, jn), (tb, ts, tn) = _both(fg, deltas, **kw)
    assert int(tn[0]) == int(jn[0]) == 1
    assert ts[0, 0] == js[0, 0] == np.float32(0.0015)
    np.testing.assert_allclose(tb[0, 0], jb[0, 0], atol=1e-5)
