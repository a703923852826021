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
