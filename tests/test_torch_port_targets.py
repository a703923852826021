"""The port's anchor targets and OHEM (smallhardface_tpu_torch/train/
targets.py) against the JAX package's on identical background
probabilities, with the fixtures of tests/test_targets.py: labels, the easy
flag and n_fg exact; regression targets and weights within 1e-6. The
planted-tie cases quantize the scores to a few levels, so the hardest-k
selections cut through runs of equal scores and the tie order (lower anchor
index first, as lax.top_k keeps it) decides which anchors are kept."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from smallhardface_tpu.train import targets as jtg
from smallhardface_tpu_torch.train import targets as ttg
import torch_threads  # noqa: F401
from tests.test_targets import BASE


def _case(seed, h, w, n_gt, im_frac=1.0, levels=None, dense=False):
    rng = np.random.RandomState(seed)
    im_h, im_w = 8.0 * h * im_frac, 8.0 * w * im_frac
    bg_prob = rng.uniform(0.01, 0.99, (h, w, 3)).astype(np.float32)
    if levels:
        bg_prob = (np.floor(bg_prob * levels) / levels + 0.01).astype(
            np.float32)
    gt = np.zeros((max(n_gt, 1) + 3, 5), np.float32)
    gt_mask = np.zeros(len(gt), bool)
    for i in range(n_gt):
        if dense:       # many positives: a grid of overlapping faces
            x1, y1 = 8.0 * (i % w), 8.0 * (i // w % h)
            s = 16.0
        else:
            x1 = rng.uniform(0, im_w * 0.7)
            y1 = rng.uniform(0, im_h * 0.7)
            s = rng.uniform(8, 70)
        gt[i] = [x1, y1, x1 + s, y1 + s, 1.0]
        gt_mask[i] = True
    return bg_prob, gt, gt_mask, im_h, im_w


CASES = [
    dict(seed=0, h=6, w=9, n_gt=2),
    dict(seed=1, h=8, w=10, n_gt=5, im_frac=0.8),
    dict(seed=2, h=7, w=9, n_gt=0),
    dict(seed=3, h=12, w=12, n_gt=120, dense=True, levels=4),
    dict(seed=4, h=16, w=16, n_gt=4, levels=3),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c['seed']}")
def test_anchor_targets_match_jax(case):
    bg_prob, gt, gt_mask, im_h, im_w = _case(**case)
    h, w, _ = bg_prob.shape
    tc = jtg.TargetConfig(easy_enable=True, easy_threshold=0.85,
                          anchors_per_batch=64 if case.get("levels") else 256)
    want = jtg.anchor_targets(
        jnp.asarray(bg_prob), BASE, jnp.asarray(gt), jnp.asarray(gt_mask),
        im_h=jnp.float32(im_h), im_w=jnp.float32(im_w), valid_h=h - 1,
        valid_w=w, tc=tc)
    got = ttg.anchor_targets(
        torch.from_numpy(bg_prob), BASE, torch.from_numpy(gt),
        torch.from_numpy(gt_mask), im_h=im_h, im_w=im_w, valid_h=h - 1,
        valid_w=w, tc=ttg.TargetConfig(**vars(tc)))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for k in ("easy", "n_fg", "n_bg"):
        assert got[k].item() == np.asarray(want[k]).item(), k
    for k in ("bbox_targets", "inside_weights", "outside_weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["accuracy"].item(),
                               np.asarray(want["accuracy"]), rtol=1e-6)
    if case.get("levels"):       # the selection really cut through ties
        labels = got["labels"].numpy()
        scores = bg_prob.reshape(-1)
        chosen = scores[labels == 0]
        rest = scores[(labels == -1) & np.isin(scores, chosen)]
        assert rest.size > 0


def test_bottom_k_ties_go_to_the_lower_index():
    scores = torch.tensor([0.5, 0.2, 0.5, 0.2, 0.9, 0.2])
    sel = torch.tensor([True, True, True, True, True, False])
    mask = ttg._bottom_k_mask(scores, 4, torch.tensor(3), sel)
    assert mask.tolist() == [True, True, False, True, False, False]
