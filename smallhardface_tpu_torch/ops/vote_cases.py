"""Inputs for the vote kernel V1 (csrc/vote.cu) and its plain version,
shared by the card tests (tests/test_torch_port_cuda.py) and
chip_smoke.py. Each returns (V, 5) float32 rows [x1, y1, x2, y2, score]
sorted by descending score (ties in drawing order), the candidates first.
"""

from __future__ import annotations

import numpy as np


def _sorted(dets):
    order = np.argsort(-dets[:, 4], kind="stable")
    return np.ascontiguousarray(dets[order], np.float32)


def integer_dets(rng, v):
    """Integer boxes within [0, 127] and dyadic scores k/256: every product
    score*coordinate and every sum over up to 512 rows is exact in float32,
    so a merged box does not depend on the order of its sum."""
    if v > 512:
        raise ValueError("integer_dets keeps its sums exact up to 512 rows")
    x1y1 = rng.randint(0, 101, (v, 2))
    wh = rng.randint(0, 27, (v, 2))
    score = rng.randint(13, 256, v) / 256.0
    return _sorted(np.column_stack([x1y1, x1y1 + wh, score]))


def crowd_dets(rng, v, centres=6, spread=12.0, size=(20.0, 90.0)):
    """v boxes around a few centres, as a crowd of faces gives them: long
    clusters that merge many rows each."""
    c = rng.uniform(100, 900, (centres, 2))[rng.randint(0, centres, v)]
    s = rng.uniform(*size, v)
    ctr = c + rng.normal(0, spread, (v, 2))
    score = rng.uniform(0.05, 1.0, v)
    return _sorted(np.column_stack([ctr - s[:, None] / 2,
                                    ctr + s[:, None] / 2, score]))


def chain_dets(v):
    """v disjoint integer boxes on a grid, no two overlapping: v singleton
    steps, the longest chain (the vote emits only the last row, NMS every
    row). Scores 1 - k / (2 v), distinct and descending."""
    side = int(np.ceil(np.sqrt(v)))
    k = np.arange(v)
    x1, y1 = (k % side) * 12.0, (k // side) * 12.0
    score = 1.0 - k / (2.0 * v)
    return _sorted(np.column_stack([x1, y1, x1 + 9, y1 + 9, score]))


def one_cluster_dets(rng, v):
    """v integer boxes that each overlap the first one at IoU >= 0.5: one
    cluster takes every row. Scores k/256 (dyadic) up to 256 rows, so that
    a merged box is exact; uniform beyond."""
    x1y1 = 100 + rng.randint(0, 3, (v, 2))
    wh = 40 + rng.randint(0, 3, (v, 2))
    score = (rng.randint(13, 256, v) / 256.0 if v <= 256
             else rng.uniform(0.05, 1.0, v))
    return _sorted(np.column_stack([x1y1, x1y1 + wh, score]))


def threshold_dets():
    """Pairs whose IoU is exactly 0.4 in float32 (inter 2 over union 5, and
    inter 40 over union 100): at thresh 0.4 the vote (>=) merges each pair
    and NMS (>) keeps both rows. The last two rows overlap nothing."""
    return np.array([[0, 0, 0, 1, 0.9],         # 1 x 2, area 2
                     [0, 0, 0, 4, 0.8],         # 1 x 5: inter 2, union 5
                     [50, 50, 59, 59, 0.7],     # 10 x 10, area 100
                     [50, 50, 59, 53, 0.6],     # 10 x 4 inside: 40 / 100
                     [200, 200, 209, 209, 0.5],
                     [300, 300, 304, 304, 0.4]], np.float32)


def degenerate_dets():
    """Zero-area and inverted boxes among ordinary ones: a head whose IoU
    with itself is 0 / 0 (NaN) or that overlaps nothing still belongs to
    its own cluster, so every step removes a row."""
    return np.array([[5, 5, 4, 9, 0.95],        # width 0: area 0
                     [0, 0, 10, 10, 0.9],
                     [5, 5, 3, 3, 0.85],        # inverted: area (-1)(-1)
                     [0, 0, 10, 10, 0.8],
                     [5, 5, 4, 4, 0.75],        # 0 x 0
                     [20, 20, 10, 10, 0.7],     # inverted: area 81
                     [1, 1, 10, 10, 0.65],
                     [40, 40, 60, 60, 0.6]], np.float32)


def _padded(dets, v):
    """dets padded to v rows with score -inf."""
    out = np.zeros((v, 5), np.float32)
    out[:len(dets)] = dets
    out[len(dets):, 4] = -np.inf
    return out


# the edge cases of V1's phases (csrc/vote.cu), on the CPU
# (tests/test_torch_port_vote_walk.py) and on the card
EDGE_CASES = ("v45_integer", "v100_floats", "n_valid_0", "n_valid_1",
              "n_valid_part", "n_valid_v", "one_cluster", "one_cluster_floats",
              "no_overlap", "at_threshold", "degenerate", "thresh_0",
              "v1100_two_tiles")


def edge_case(name):
    """(dets (V, 5) float32, n_valid, thresh, exact): with exact, every
    output of the vote is exact in float32 (integer boxes, dyadic scores),
    so the kernel must equal the plain loop to the bit."""
    rng = np.random.RandomState(len(name))
    if name == "v45_integer":           # V not a multiple of 32
        return integer_dets(rng, 45), 45, 0.4, True
    if name == "v100_floats":
        return crowd_dets(rng, 100, centres=12), 100, 0.4, False
    if name == "n_valid_0":
        return _padded(integer_dets(rng, 40)[:0], 40), 0, 0.4, True
    if name == "n_valid_1":
        return _padded(integer_dets(rng, 1), 33), 1, 0.4, True
    if name == "n_valid_part":
        d = integer_dets(rng, 70)
        d[50:, 4] = -np.inf
        return d, 50, 0.4, True
    if name == "n_valid_v":
        return integer_dets(rng, 300), 300, 0.5, True
    if name == "one_cluster":
        return one_cluster_dets(rng, 200), 200, 0.4, True
    if name == "one_cluster_floats":
        return one_cluster_dets(rng, 500), 500, 0.4, False
    if name == "no_overlap":
        return chain_dets(130), 130, 0.4, True
    if name == "at_threshold":
        return threshold_dets(), 6, 0.4, True
    if name == "degenerate":
        return degenerate_dets(), 8, 0.4, True
    if name == "thresh_0":              # every row with a positive union
        return integer_dets(rng, 64), 64, 0.0, True
    if name == "v1100_two_tiles":       # a second column tile, skipped tiles
        return crowd_dets(rng, 1100, centres=200, spread=40), 1100, 0.4, False
    raise KeyError(name)
