"""The port's anchor max-IoU (smallhardface_tpu_torch/ops/iou.py and its
plain version ops/bbox.max_iou_chunked) against the JAX package's Pallas
kernel (interpret mode, G ≤ 512), its chunked XLA scan, and the numpy
bbox_overlaps oracle (G up to 2048), including images with no gt and
masked rows. The argmax must be equal and the max IoU within 1e-6. The
kernel itself is tested on the card in tests/test_torch_port_cuda.py.

The kernel's gt culling (per block, with the walks of a full list, and per
warp) is modelled here in numpy float32 (``_cull_model``) and held to the
bit against the plain version and the Pallas kernel, over the cases of
``ops/iou_cases.k3_case`` that the card test runs through the kernel."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from smallhardface_tpu.ops import bbox_jax, bbox_np
from smallhardface_tpu.ops.pallas_iou import pallas_max_iou
from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.ops import iou
from smallhardface_tpu_torch.ops.iou_cases import (BLOCK, CAP, K3_CASES,
                                                  k3_case)

BASE = anchors_mod.generate_anchors(base_size=16, ratios=[1],
                                    scales=[1, 2, 4], shifts=[0],
                                    strides=[8, 8, 8])


def _inputs(g, n_masked, seed, h=24, w=32):
    """Dense anchors over an (h, w) stride-8 grid and g gt boxes of which
    the last n_masked are masked (garbage coordinates)."""
    rng = np.random.RandomState(seed)
    anchors = anchors_mod.dense_anchors(h, w, 8, BASE).astype(np.float32)
    x1 = rng.uniform(-10, 8 * w, g)
    y1 = rng.uniform(-10, 8 * h, g)
    s = rng.uniform(4, 90, g)
    gt = np.stack([x1, y1, x1 + s, y1 + s * rng.uniform(0.7, 1.3, g)],
                  1).astype(np.float32)
    mask = np.ones(g, bool)
    if n_masked:
        mask[g - n_masked:] = False
        gt[g - n_masked:] = rng.uniform(-1e3, 1e3, (n_masked, 4))
    return anchors, gt, mask


def _port(anchors, gt, mask):
    best, idx = iou.max_iou_reference(torch.from_numpy(anchors),
                                      torch.from_numpy(gt),
                                      torch.from_numpy(mask))
    return best.numpy(), idx.numpy()


def _numpy_oracle(anchors, gt, mask):
    if not mask.any():
        return np.zeros(len(anchors)), np.zeros(len(anchors), np.int64)
    ov = bbox_np.bbox_overlaps(anchors, gt)
    ov[:, ~mask] = -1.0
    return np.maximum(ov.max(1), 0.0), ov.argmax(1)


@pytest.mark.parametrize("g,n_masked", [(1, 0), (8, 3), (64, 0), (512, 100),
                                        (8, 8)])
def test_vs_pallas_kernel(g, n_masked):
    anchors, gt, mask = _inputs(g, n_masked, seed=g + n_masked)
    want_best, want_idx = pallas_max_iou(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask),
        interpret=True)
    best, idx = _port(anchors, gt, mask)
    np.testing.assert_array_equal(idx, np.asarray(want_idx))
    np.testing.assert_allclose(best, np.asarray(want_best), rtol=0, atol=1e-6)


@pytest.mark.parametrize("g,n_masked", [(64, 10), (2048, 300), (3, 3)])
def test_vs_chunked_scan_and_numpy(g, n_masked):
    anchors, gt, mask = _inputs(g, n_masked, seed=100 + g)
    best, idx = _port(anchors, gt, mask)
    j_best, j_idx = bbox_jax.max_iou_chunked(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask))
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    np.testing.assert_allclose(best, np.asarray(j_best), rtol=0, atol=1e-6)
    n_best, n_idx = _numpy_oracle(anchors, gt, mask)
    np.testing.assert_array_equal(idx, n_idx)
    np.testing.assert_allclose(best, n_best, rtol=0, atol=1e-6)


def test_cpu_wrapper_is_the_plain_version_and_uncounted():
    anchors, gt, mask = _inputs(16, 4, seed=5)
    before = iou.max_iou.launches
    a = iou.max_iou(*map(torch.from_numpy, (anchors, gt, mask)))
    b = iou.max_iou_reference(*map(torch.from_numpy, (anchors, gt, mask)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert iou.max_iou.launches == before


def _may_overlap(u, q):
    """The kernel's cull test for gt rows q against the box u, in float32:
    the pair test's expressions for the width and the height."""
    one = np.float32(1)
    return ((np.minimum(u[2], q[:, 2]) - np.maximum(u[0], q[:, 0]) + one > 0)
            & (np.minimum(u[3], q[:, 3]) - np.maximum(u[1], q[:, 1]) + one
               > 0))


def _union(a):
    return np.concatenate([a[:, :2].min(0), a[:, 2:].max(0)])


def _walk(a, gt, lst, best, idx):
    """One warp's pass over the block's list `lst` (gt indices in gt order):
    keep those that may overlap the warp's union box, then the exact loop,
    four kept gt at a time, dividing only where inter > 0, union > 0 and
    best * union - inter is not > 0 for the best before the four (float64
    holds the product exactly), with a strict >. Updates best, idx."""
    one = np.float32(1)
    lst = np.asarray(lst, np.int64)
    kept = lst[_may_overlap(_union(a), gt[lst])] if len(lst) else lst
    area = ((a[:, 2] - a[:, 0] + one) * (a[:, 3] - a[:, 1] + one))[:, None]
    for k in range(0, len(kept), 4):
        ids = kept[np.minimum(np.arange(k, k + 4), len(kept) - 1)]
        q = gt[ids][None]
        q_area = (q[..., 2] - q[..., 0] + one) * (q[..., 3] - q[..., 1] + one)
        iw = np.maximum(np.minimum(a[:, 2:3], q[..., 2])
                        - np.maximum(a[:, 0:1], q[..., 0]) + one, 0)
        ih = np.maximum(np.minimum(a[:, 3:4], q[..., 3])
                        - np.maximum(a[:, 1:2], q[..., 1]) + one, 0)
        inter = iw * ih
        union = area + q_area - inter
        need = (inter > 0) & (union > 0) & ~(
            best[:, None].astype(np.float64) * union - inter > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            iou_b = np.where(need, inter / union, np.float32(0))
        assert iou_b.dtype == np.float32
        for t in range(4):
            take = iou_b[:, t] > best
            best[:] = np.where(take, iou_b[:, t], best)
            idx[:] = np.where(take, ids[t], idx)


def _cull_model(anchors, gt, mask, flushes=None):
    """csrc/iou.cu in numpy float32. For each block of 256 consecutive
    anchors, the gt stream 256 at a time, and those that are unmasked and
    may overlap the block's union box go to the block's list in gt order;
    when a step would take the list past CAP gt, and at the end, every warp
    of 32 anchors walks the list (``_walk``), keeping its best across the
    walks, and the list starts again (each such (block start, gt start) is
    appended to `flushes`). An anchor that beat no gt gets the first
    unmasked gt, or 0."""
    live = np.flatnonzero(mask)
    first = live[0] if len(live) else 0
    best = np.zeros(len(anchors), np.float32)
    idx = np.full(len(anchors), -1, np.int64)
    for b0 in range(0, len(anchors), BLOCK):
        blk = slice(b0, min(b0 + BLOCK, len(anchors)))
        ub = _union(anchors[blk])
        warps = [slice(w0, min(w0 + 32, blk.stop))
                 for w0 in range(b0, blk.stop, 32)]

        def walk(lst):
            for w in warps:
                b, i = best[w].copy(), idx[w].copy()
                _walk(anchors[w], gt, lst, b, i)
                best[w], idx[w] = b, i
        lst = []
        for g0 in range(0, len(gt), BLOCK):
            q = np.arange(g0, min(g0 + BLOCK, len(gt)))
            step = q[mask[q] & _may_overlap(ub, gt[q])].tolist()
            if len(lst) + len(step) > CAP:
                walk(lst)
                if flushes is not None:
                    flushes.append((b0, g0))
                lst = []
            lst += step
        walk(lst)
    return best, np.where(idx >= 0, idx, first).astype(np.int32)


def _pallas_any_g(anchors, gt, mask):
    """The Pallas kernel (interpret mode) over 512-gt chunks, merged as the
    plain version merges its chunks: a strict > in chunk order from -1,
    chunks without an unmasked gt skipped. Equal to a kernel over all G."""
    best = np.full(len(anchors), -1, np.float32)
    idx = np.zeros(len(anchors), np.int32)
    for g0 in range(0, len(gt), 512):
        if not mask[g0:g0 + 512].any():
            continue
        b, i = map(np.asarray, pallas_max_iou(
            jnp.asarray(anchors), jnp.asarray(gt[g0:g0 + 512]),
            jnp.asarray(mask[g0:g0 + 512]), interpret=True))
        take = b > best
        best, idx = np.where(take, b, best), np.where(take, i + g0, idx)
    return np.maximum(best, 0), idx


@pytest.mark.parametrize("case", K3_CASES)
def test_cull_model_vs_plain_and_pallas(case):
    """The culling model equals the plain version and the Pallas kernel to
    the bit; for G > 512 the JAX package's chunked XLA scan is held to the
    argmax and 1e-6, since XLA's CPU build rounds its IoU a few ulp away
    from one fp32 rounding per operation."""
    anchors, gt, mask = k3_case(case)
    best, idx = _cull_model(anchors, gt, mask)
    p_best, p_idx = _port(anchors, gt, mask)
    np.testing.assert_array_equal(idx, p_idx)
    np.testing.assert_array_equal(best, p_best)
    k_best, k_idx = _pallas_any_g(anchors, gt, mask)
    np.testing.assert_array_equal(idx, k_idx)
    np.testing.assert_array_equal(best, k_best)
    if len(gt) > 512:
        j_best, j_idx = bbox_jax.max_iou_chunked(
            jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask))
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
        np.testing.assert_allclose(best, np.asarray(j_best), rtol=0,
                                   atol=1e-6)


def test_cull_cases_reach_the_cull():
    """The cases exercise what they name: boundary gt kept at width 1 that
    decide some anchor's argmax, gt culled, duplicates that tie, a block
    whose list fills and is walked early with identical gt on both sides
    of the walk, the first of which some anchor takes."""
    anchors, gt, mask = k3_case("edges_integer")
    best, idx = _cull_model(anchors, gt, mask)
    assert (best > 0).any()
    # some anchors' best gt touches their warp's union box at width 1
    u = np.stack([np.concatenate([anchors[w0:w0 + 32, :2].min(0),
                                  anchors[w0:w0 + 32, 2:].max(0)])
                  for w0 in range(0, len(anchors), 32)])[np.arange(
                      len(anchors)) // 32]
    q = gt[idx]
    iw_u = np.minimum(u[:, 2], q[:, 2]) - np.maximum(u[:, 0], q[:, 0]) + 1
    ih_u = np.minimum(u[:, 3], q[:, 3]) - np.maximum(u[:, 1], q[:, 1]) + 1
    assert ((best > 0) & ((iw_u == 1) | (ih_u == 1))).any()
    anchors, gt, mask = k3_case("duplicates")
    best, idx = _cull_model(anchors, gt, mask)
    same = (gt[:, None] == gt[None]).all(2) & mask[None]
    first_copy = same.argmax(1)         # the first unmasked copy of each gt
    assert (same.sum(1) > 1)[idx[best > 0]].any()
    assert (first_copy[idx[best > 0]] == idx[best > 0]).all()
    anchors, gt, mask = k3_case("masked_first")
    best, idx = _cull_model(anchors, gt, mask)
    assert ((best == 0) & (idx == 37)).any() and (idx >= 37).all()
    anchors, gt, mask = k3_case("block_overflow")
    flushes = []
    best, idx = _cull_model(anchors, gt, mask, flushes)
    assert flushes and flushes[0][0] == 0
    g0 = flushes[0][1]
    block = slice(0, BLOCK)
    after = (gt[None, g0:] == gt[idx[block], None]).all(2) & mask[None, g0:]
    assert ((best[block] > 0) & (idx[block] < g0) & after.any(1)).any()
