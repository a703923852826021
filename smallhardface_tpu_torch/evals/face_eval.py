"""Generic VOC-style PR/AP evaluation for AFW / Pascal Faces detection
files — the role of the external marcopede face-eval kit the reference
shells out to (external/marcopede-face-eval-f2870fd85d48/
VOCpr.py, plot_AP.py): greedy max-IoU matching per detection in descending
score order, one match per ground truth, "difficult" boxes ignored.
The port's copy of ``smallhardface_tpu/evals/face_eval.py``.

Detections come in the writer format of datasets.afw / datasets.pascalface:
  <image_id> <score> <xmin> <ymin> <xmax> <ymax>
Ground truth is a text file of
  <image_id> <xmin> <ymin> <xmax> <ymax> [difficult(0/1)]

Usage:
  python -m smallhardface_tpu_torch.evals.face_eval --det afw_res.txt \
      --gt afw_gt.txt [--iou 0.5] [--plot pr.png]
"""

from __future__ import annotations

import argparse
import collections

import numpy as np


def _iou(box, gts):
    x1 = np.maximum(box[0], gts[:, 0])
    y1 = np.maximum(box[1], gts[:, 1])
    x2 = np.minimum(box[2], gts[:, 2])
    y2 = np.minimum(box[3], gts[:, 3])
    iw = np.maximum(0.0, x2 - x1 + 1)
    ih = np.maximum(0.0, y2 - y1 + 1)
    inter = iw * ih
    area_b = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    area_g = (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
    return inter / (area_b + area_g - inter)


def voc_pr(gt, dets, iou_thresh=0.5):
    """gt: {image_id: (boxes (G,4), difficult (G,) bool)};
    dets: list of (image_id, score, x1, y1, x2, y2).
    Returns (recall, precision, ap)."""
    n_pos = sum(int((~d).sum()) for _, d in gt.values())
    matched = {k: np.zeros(len(v[0]), bool) for k, v in gt.items()}
    order = sorted(range(len(dets)), key=lambda i: -dets[i][1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for rank, i in enumerate(order):
        img, _score, *box = dets[i]
        if img not in gt or len(gt[img][0]) == 0:
            fp[rank] = 1
            continue
        boxes, difficult = gt[img]
        ious = _iou(np.asarray(box, np.float64), boxes)
        g = int(np.argmax(ious))
        if ious[g] > iou_thresh:
            if difficult[g]:
                continue           # ignored, neither tp nor fp
            if not matched[img][g]:
                matched[img][g] = True
                tp[rank] = 1
            else:
                fp[rank] = 1
        else:
            fp[rank] = 1
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recall = tp_c / max(n_pos, 1)
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    ap = voc_ap(recall, precision)
    return recall, precision, ap


def voc_ap(rec, prec):
    mrec = np.concatenate([[0], rec, [1]])
    mpre = np.concatenate([[0], prec, [0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def read_detections(path):
    """Our writer format AND the marcopede kit's published baseline files
    (detections/{AFW,PASCAL}/*.txt: `name.jpg score x1 y1 x2 y2`) — image
    ids are normalized by stripping a trailing image extension so both
    match the ground-truth ids."""
    dets = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            img = parts[0]
            for ext in (".jpg", ".jpeg", ".png"):
                if img.lower().endswith(ext):
                    img = img[:-len(ext)]
                    break
            dets.append((img, float(parts[1]), float(parts[2]),
                         float(parts[3]), float(parts[4]), float(parts[5])))
    return dets


def read_gt(path):
    gt = collections.defaultdict(lambda: ([], []))
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            img = parts[0]
            for ext in (".jpg", ".jpeg", ".png"):
                if img.lower().endswith(ext):
                    img = img[:-len(ext)]
                    break
            boxes, diff = gt[img]
            boxes.append([float(v) for v in parts[1:5]])
            diff.append(bool(int(parts[5])) if len(parts) > 5 else False)
    return {k: (np.asarray(b, np.float64), np.asarray(d, bool))
            for k, (b, d) in gt.items()}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--det", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--plot", default="")
    p.add_argument("--baselines", default="",
                   help="directory of published baseline detection files "
                        "(the marcopede kit ships them under detections/"
                        "{AFW,PASCAL}/*.txt); each is scored against the "
                        "same ground truth and overlaid on the PR plot, "
                        "like the kit's plot_AP.py")
    args = p.parse_args()
    gt = read_gt(args.gt)
    rec, prec, ap = voc_pr(gt, read_detections(args.det), args.iou)
    print(f"AP@{args.iou}: {ap:.4f}  (max recall {rec[-1] if len(rec) else 0:.4f})")
    curves = [("ours", rec, prec, ap)]
    if args.baselines:
        import glob
        import os
        for fn in sorted(glob.glob(os.path.join(args.baselines, "*.txt"))):
            label = os.path.splitext(os.path.basename(fn))[0]
            b_rec, b_prec, b_ap = voc_pr(gt, read_detections(fn), args.iou)
            print(f"  baseline {label}: AP@{args.iou} = {b_ap:.4f}")
            curves.append((label, b_rec, b_prec, b_ap))
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 7))
        # best first, ours drawn on top — the kit's presentation
        curves.sort(key=lambda c: -c[3])
        for label, r, pcurve, a in curves:
            kw = ({"color": "green", "linewidth": 2.5, "zorder": 50}
                  if label == "ours" else {"linewidth": 1.5})
            ax.plot(r, pcurve, label=f"{label} (AP {100 * a:.1f})", **kw)
        ax.set_xlabel("Recall", fontsize=14)
        ax.set_ylabel("Precision", fontsize=14)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.grid(True)
        ax.legend(loc="lower left", fontsize=10)
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"PR curve written to {args.plot}")


if __name__ == "__main__":
    main()
