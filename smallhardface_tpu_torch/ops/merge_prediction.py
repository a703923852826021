"""Min-background merge of several class-score maps.

Counterpart of ``smallhardface_tpu/ops/merge_prediction.py`` (the
reference's MergePrediction Python layer, lib/layers/merge_prediction.py
:16-53): given N score maps for the same spatial grid, softmax each over
the 2-way class axis, take the smallest background probability per
position (the "strongest" prediction), and emit the merged (bg, 1-bg)
map. Available for model surgery; no shipped template uses it.
"""

from __future__ import annotations

import torch


def merge_prediction(score_maps):
    """score_maps: (N, 2, H', W) raw logits stacked over sources (the
    Caffe blob layout with 2-way class channels), a tensor or an array.
    Returns (1, 2, H', W) merged probabilities, on the input's device."""
    x = torch.as_tensor(score_maps)
    n, _, h, w = x.shape
    probs = torch.softmax(x.reshape(n, 2, -1, w), dim=1)
    strongest = probs[:, 0].amin(dim=0)
    merged = torch.stack([strongest, 1.0 - strongest])
    return merged.reshape(1, 2, h, w)
