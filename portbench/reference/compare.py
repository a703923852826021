"""The comparisons that decide ``correct``, and their limits.

Detections (the evaluation cells): per image, each reference row is
matched greedily, in descending score, to the program's unmatched row of
highest IoU, if that IoU reaches ``iou`` and the scores differ by at most
``tol``. The image's unmatched share is 1 − 2·matches / (rows of both).
The numbers compared (``DECIDES``): fp32, the worst image's share in
percent; int8, the mean over the images in percent, and the count of
images past half unmatched, so that one wrong image of a batch fails the
run where the mean would hide it. A row that the reference's own fp32
rounding would move stays matched; a cluster that breaks another way does
not.

Training: each step's loss as a relative gap; the first gradient and the
change of the weights after the reference steps as the worst leaf's gap
of norms, against the reference's norm of that leaf or of the median
leaf, whichever is larger.

The limits (``LIMITS``) were set from chip runs of the program and of the
control on many seeds; PERF.md gives the readings.
"""

from __future__ import annotations

import numpy as np

# (iou, score tolerance) of a match, per rule
RULES = {"strict": (0.99, 1e-3), "mid": (0.9, 1e-2), "loose": (0.5, 5e-2)}
# the numbers that decide correct, per configured precision: (name, iou,
# tolerance, "worst" image, "mean" over the images or "past_half": the
# images whose share exceeds a half). fp32 detections are held to the
# strict rule, image by image. The int8 chain turns a last-bit difference
# of its fp32 stem or of its calibration into whole steps of its grid,
# and the vote turns those into other clusters, so int8 detections are
# held to the loose rule: on the mean over the compared images, the
# number whose readings the 4-bit control stays farthest from, and image
# by image, none past half (PERF.md)
DECIDES = {"float32": [("det_unmatched_pct.strict", 0.99, 1e-3, "worst")],
           "int8": [("det_unmatched_mean_pct.loose", 0.5, 5e-2, "mean"),
                    ("det_images_past_half.loose", 0.5, 5e-2,
                     "past_half")]}

# name → limit; a reading above its limit is not correct
LIMITS = {
    "det_unmatched_pct.strict": 1.3,
    "det_unmatched_mean_pct.loose": 48.0,
    "det_images_past_half.loose": 0.5,
    "loss_gap": 1e-2,
    "grad_gap": 9e-4,
    "change_gap": 5e-2,
}


def _iou(a, b):
    """(n, m) IoU of boxes a (n, 4) and b (m, 4), +1 pixel convention, in
    float64."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    iw = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0]) + 1).clip(0)
    ih = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1]) + 1).clip(0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def unmatched_share(ref, prog, iou, tol):
    """The unmatched share of one image's rows (see the module's note)."""
    ref = np.asarray(ref, np.float32).reshape(-1, 5)
    prog = np.asarray(prog, np.float32).reshape(-1, 5)
    if len(ref) + len(prog) == 0:
        return 0.0
    if len(ref) == 0 or len(prog) == 0:
        return 1.0
    m = _iou(ref[:, :4], prog[:, :4])
    ok = np.abs(ref[:, None, 4].astype(np.float64) - prog[None, :, 4]) <= tol
    m = np.where(ok & (m >= iou), m, -1.0)
    taken = np.zeros(len(prog), bool)
    matches = 0
    for i in np.argsort(-ref[:, 4], kind="stable"):
        row = np.where(taken, -1.0, m[i])
        j = int(np.argmax(row))
        if row[j] >= 0:
            taken[j] = True
            matches += 1
    return 1.0 - 2.0 * matches / (len(ref) + len(prog))


def detections(pairs, precision):
    """pairs: [(reference rows, program rows)] of the compared images.
    Returns {each of the precision's deciding numbers}, and under "diag."
    the worst and the mean share of each rule, for the record."""
    out = {}
    for name, iou, tol, over in DECIDES[precision]:
        share = np.array([unmatched_share(r, p, iou, tol) for r, p in pairs])
        out[name] = (float(np.sum(share > 0.5)) if over == "past_half"
                     else 100.0 * float(share.max() if over == "worst"
                                        else share.mean()))
    for rule, (iou, tol) in RULES.items():
        share = [unmatched_share(r, p, iou, tol) for r, p in pairs]
        out[f"diag.worst.{rule}"] = 100.0 * float(max(share))
        out[f"diag.mean.{rule}"] = 100.0 * float(np.mean(share))
    return out


def leaf_gap(prog, ref, skip=()):
    """The worst leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)
    over {leaf: tensor} dicts; leaves in ``skip`` are left out."""
    keys = [k for k in ref if k not in skip]
    rn = {k: float(ref[k].double().norm()) for k in keys}
    pn = {k: float(prog[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def judge(numbers):
    """(correct, [(name, value, limit)]) for the compared numbers."""
    rows = [(k, float(v), LIMITS[k]) for k, v in numbers.items()
            if k in LIMITS]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and bool(rows), rows
