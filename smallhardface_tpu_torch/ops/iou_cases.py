"""Inputs for the anchor max-IoU kernel (csrc/iou.cu, K3) that could break
its gt culling, shared by chip_smoke.py, the card tests
(tests/test_torch_port_cuda.py) and the CPU tests of a numpy model of the
culling (tests/test_torch_port_iou.py).

- ``crowd_gt``: faces of 10-40 px in crowded rows, as on WIDER's crowd
  images;
- ``band_gt``: faces packed into one box, with copies a fixed distance
  apart in gt order, so that one block of anchors keeps more gt than its
  list holds and ties straddle the point where the block walks the list;
- ``k3_case``: the named cases of ``K3_CASES`` over a small anchor grid.
"""

from __future__ import annotations

import numpy as np

from smallhardface_tpu_torch.ops import anchors as anchors_mod

BASE = anchors_mod.generate_anchors(base_size=16, ratios=[1],
                                    scales=[1, 2, 4], shifts=[0],
                                    strides=[8, 8, 8])
# the kernel's block of anchors and the gt its list holds (csrc/iou.cu)
BLOCK, CAP = 256, 1024
K3_CASES = ("edges_integer", "edges_half", "near_ties", "duplicates",
            "masked_first", "all_masked_0", "all_masked_1", "all_masked_33",
            "all_masked_513", "ragged_n", "permuted", "border", "crowd",
            "block_overflow")


def crowd_gt(rng, g, h, w):
    """g faces of 10-40 px in crowded rows over an h×w image: one row for
    every 64 faces at a random height, each face at a random place along its
    row, a few pixels above or below it."""
    rows = rng.uniform(0, h - 40, max(1, g // 64))
    s = rng.uniform(10, 40, g)
    x1 = rng.uniform(0, w - 40, g)
    y1 = rows[rng.randint(0, len(rows), g)] + rng.normal(0, 5, g)
    return np.stack([x1, y1, x1 + s, y1 + s], 1).reshape(g, 4).astype(
        np.float32)


def band_gt(rng, g, box, copy_at=CAP, every=7):
    """g faces of 10-40 px inside box (x1, y1, x2, y2), as a dense stand of
    a stadium crowd; gt i + copy_at repeats gt i for every `every`-th i, so
    that identical gt lie on both sides of the kernel's list walk when one
    block keeps all of them."""
    x1, y1, x2, y2 = box
    s = rng.uniform(10, 40, g)
    bx = x1 + rng.uniform(0, 1, g) * np.maximum(x2 - x1 - s, 0)
    by = y1 + rng.uniform(0, 1, g) * np.maximum(y2 - y1 - s, 0)
    gt = np.stack([bx, by, bx + s, by + s], 1).reshape(g, 4)
    i = np.arange(0, max(0, min(copy_at, g - copy_at)), every)
    gt[i + copy_at] = gt[i]
    return gt.astype(np.float32)


def _union(a):
    return np.concatenate([a[:, :2].min(0), a[:, 2:].max(0)])


def _random_gt(rng, g, h, w, smin=4, smax=90):
    x1, y1 = rng.uniform(-10, 8 * w, g), rng.uniform(-10, 8 * h, g)
    s = rng.uniform(smin, smax, g)
    return np.stack([x1, y1, x1 + s, y1 + s * rng.uniform(0.7, 1.3, g)],
                    1).reshape(g, 4).astype(np.float32)


def k3_case(name, h=20, w=30, seed=0):
    """Inputs that could break K3's gt culling, over the dense anchors of
    an (h, w) stride-8 grid: (anchors (N, 4) float32, gt (G, 4) float32,
    mask (G,) bool). At w = 30 a row holds 90 anchors, so warps of 32
    straddle rows, and N = 1800 is not a multiple of 32.

    - edges_integer / edges_half: beside the union box U of every fifth
      warp, on each side, one gt at iw(U) (or ih(U)) = 1, which must be
      kept, and one at 0, which may be culled; edges_half shifts the
      anchors by half a pixel and adds gt at 0.5 and -0.5;
    - near_ties: runs of gt shifted by 2e-5 px from an anchor, so that
      their IoUs with it rise (or fall) a few ulp at a time, then repeat;
    - duplicates: G = 1100, boxes repeated in the same 32-group, in another
      32-group and in the next two 512-chunks; the lower index must win;
    - masked_first: 37 masked rows (boxes equal to anchors) before the
      first unmasked gt, which every anchor that overlaps nothing takes;
    - all_masked_G: G = 0, 1, 33 or 513 rows, all masked;
    - ragged_n: N = 1795;
    - permuted: the anchors in a random order, where the culling is weak;
    - border: boxes at negative coordinates over the border anchors;
    - crowd: ``crowd_gt``, 600 faces of 10-40 px in rows;
    - block_overflow: 2048 gt, of which about 1750 lie in the union box of
      the first block of 256 anchors (``band_gt``, ties 1024 apart) and the
      rest, interleaved, far from it, with a few masked: that block keeps
      more than its list holds (CAP) and walks the list before the end.
    """
    rng = np.random.RandomState(seed)
    anchors = anchors_mod.dense_anchors(h, w, 8, BASE).astype(np.float32)
    if name.startswith("edges"):
        ds = (0.0, 1.0)
        if name == "edges_half":
            anchors = anchors + np.float32(0.5)
            ds = (0.0, 0.5, 1.0, 1.5)
        boxes = []
        for w0 in range(0, len(anchors), 5 * 32):
            x1, y1, x2, y2 = _union(anchors[w0:w0 + 32])
            cx, cy = x1 + np.floor((x2 - x1) / 2), y1 + np.floor((y2 - y1) / 2)
            for d in ds:                      # width or height 1 - d over U
                boxes += [[x2 + d, cy, x2 + d + 20, cy + 20],
                          [x1 - d - 20, cy, x1 - d, cy + 20],
                          [cx, y2 + d, cx + 20, y2 + d + 20],
                          [cx, y1 - d - 20, cx + 20, y1 - d]]
        gt = np.asarray(boxes, np.float32)
        mask = np.ones(len(gt), bool)
    elif name == "near_ties":
        boxes = []
        for j in rng.choice(len(anchors), 12, replace=False):
            shifts = 0.01 - 2e-5 * np.arange(6)      # IoUs a few ulp apart
            if j % 2:
                shifts = shifts[::-1]
            boxes += [anchors[j] + [d, 0, d, 0] for d in shifts]
            boxes += [anchors[j] + [shifts[-1], 0, shifts[-1], 0]] * 2
        gt = np.asarray(boxes, np.float32)
        mask = np.ones(len(gt), bool)
    elif name == "duplicates":
        gt = _random_gt(rng, 1100, h, w)
        for j in range(0, 40, 3):
            gt[j + 1] = gt[j + 40] = gt[j + 600] = gt[j + 1030] = gt[j]
        mask = np.ones(len(gt), bool)
        mask[rng.randint(0, 1100, 30)] = False
    elif name == "masked_first":
        gt = _random_gt(rng, 100, h // 2, w // 2)
        gt[:37] = anchors[rng.randint(0, len(anchors), 37)]
        mask = np.arange(100) >= 37
        mask[[50, 61, 99]] = False
    elif name.startswith("all_masked"):
        g = int(name.rsplit("_", 1)[1])
        gt = _random_gt(rng, g, h, w)
        mask = np.zeros(g, bool)
    elif name in ("ragged_n", "permuted"):
        if name == "ragged_n":
            anchors = anchors[:-5]
        else:
            anchors = anchors[rng.permutation(len(anchors))]
        gt = _random_gt(rng, 300, h, w)
        mask = rng.uniform(size=300) > 0.1
    elif name == "border":
        x1, y1 = rng.uniform(-40, 10, 64), rng.uniform(-40, 10, 64)
        s = rng.uniform(5, 60, 64)
        gt = np.concatenate([np.stack([x1, y1, x1 + s, y1 + s], 1),
                             _random_gt(rng, 64, h, w)]).astype(np.float32)
        mask = rng.uniform(size=128) > 0.1
    elif name == "crowd":
        gt = crowd_gt(rng, 600, 8 * h, 8 * w)
        mask = np.ones(600, bool)
    elif name == "block_overflow":
        gt = band_gt(rng, 2048, _union(anchors[:BLOCK]))
        far = rng.uniform(size=2048) < 0.15
        far[np.arange(0, CAP, 7)] = far[np.arange(0, CAP, 7) + CAP] = False
        gt[far] = _random_gt(rng, int(far.sum()), h, w) + np.float32(
            [0, 8 * h, 0, 8 * h])
        mask = rng.uniform(size=2048) > 0.03
    else:
        raise ValueError(name)
    return anchors, gt, mask
