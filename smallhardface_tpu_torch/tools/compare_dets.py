"""Compare two detection sets (e.g. converted-weights run vs a reference
run) — the parity-debugging companion to the detections cache
(lib/test.py:303-316 caching contract: all_boxes[class][image] = (N, 5)).
The port's copy of ``smallhardface_tpu/tools/compare_dets.py``, on the
port's ``ops/bbox_np``.

Inputs may be detections.pkl files OR WIDER result artifacts — a
directory of per-image txts or a result.tar.gz as written by
datasets.wider.evaluate_detections (the command line forces
TEST.NO_CACHE, so txts/tars are what a CLI run leaves behind; boxes there
are the integer x,y,w,h the WIDER protocol consumes).

Usage: python -m smallhardface_tpu_torch.tools.compare_dets A B
           [--iou 0.5] [--score-tol 0.01]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import tarfile
import tempfile

import numpy as np


def _load_wider_txt_dir(root):
    """{relative image path: (N, 5) [x1,y1,x2,y2,score]} from a WIDER
    result tree (…/detections/<event>/<img>.txt, wider.py writer)."""
    out = {}
    for f in sorted(glob.glob(os.path.join(root, "**", "*.txt"),
                              recursive=True)):
        lines = open(f).read().strip().splitlines()
        dets = []
        for ln in lines[2:]:
            x, y, w, h, s = (float(v) for v in ln.split()[:5])
            dets.append([x, y, x + w, y + h, s])
        key = os.path.relpath(f, root)
        out[key] = np.asarray(dets, np.float32).reshape(-1, 5)
    return out


def load_any(path):
    """Returns all_boxes-style [None, {name: (N,5)}] from a pkl, a WIDER
    txt directory, or a result.tar.gz."""
    if os.path.isdir(path):
        return [None, _load_wider_txt_dir(path)]
    if path.endswith((".tar.gz", ".tgz")):
        with tempfile.TemporaryDirectory() as td:
            with tarfile.open(path) as tf:
                tf.extractall(td, filter="data")
            return [None, _load_wider_txt_dir(td)]
    with open(path, "rb") as f:
        return pickle.load(f)


def _one_way(a, b, iou_thresh, score_tol):
    from smallhardface_tpu_torch.ops import bbox_np
    iou = bbox_np.bbox_overlaps(a[:, :4], b[:, :4])
    best = iou.argmax(axis=1)
    ok = (iou[np.arange(len(a)), best] >= iou_thresh) & \
         (np.abs(a[:, 4] - b[best, 4]) <= score_tol)
    return float(ok.mean())


def match_rate(a, b, iou_thresh, score_tol):
    """Symmetric match rate: min over both directions, so both missing and
    spurious detections lower the score."""
    if len(a) == 0 and len(b) == 0:
        return 1.0
    if len(a) == 0 or len(b) == 0:
        return 0.0
    return min(_one_way(a, b, iou_thresh, score_tol),
               _one_way(b, a, iou_thresh, score_tol))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--score-tol", type=float, default=0.01)
    args = p.parse_args()

    da = load_any(args.a)
    db = load_any(args.b)
    assert len(da) == len(db), "class count mismatch"
    for cls in range(1, len(da)):
        ca, cb = da[cls], db[cls]
        assert isinstance(ca, dict) == isinstance(cb, dict), (
            "cannot compare a detections.pkl (index-keyed list) against a "
            "WIDER txt/tar artifact (path-keyed dict) — convert one side "
            "first (both inputs must be the same kind)")
        if isinstance(ca, dict):
            keys = sorted(ca)
            assert keys == sorted(cb), "image sets differ"
            pairs = [(ca[k], cb[k]) for k in keys]
            names = keys
        else:
            assert len(ca) == len(cb), "image count mismatch"
            pairs = list(zip(ca, cb))
            names = list(range(len(pairs)))
        rates, count_a, count_b = [], 0, 0
        for a, b in pairs:
            a = np.asarray(a).reshape(-1, 5)
            b = np.asarray(b).reshape(-1, 5)
            count_a += len(a)
            count_b += len(b)
            rates.append(match_rate(a, b, args.iou, args.score_tol))
        if not rates:
            print(f"class {cls}: no images")
            continue
        worst = int(np.argmin(rates))
        print(f"class {cls}: images {len(pairs)}, "
              f"dets {count_a} vs {count_b}, "
              f"mean match-rate {np.mean(rates):.4f}, "
              f"worst image {names[worst]} ({np.min(rates):.4f})")


if __name__ == "__main__":
    main()
