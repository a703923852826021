"""WIDER FACE evaluation protocol (python port of the official MATLAB
toolkit, behaviorally matching lib/wider_eval_tools/
wider_eval.py:10-222). The port's copy of
``smallhardface_tpu/evals/wider_eval.py``:

  read per-event predictions → global min-max score normalization →
  per-image greedy matching with an ignore list → 1000-threshold PR →
  VOC AP, for the easy/medium/hard settings in a 3-way process pool.

`mimic_eval_bug=True` reproduces the official toolkit's IoU-rounding bug
(each overlap is rounded to 0/1 before the argmax; ties then resolve to the
first ground-truth box — wider_eval.py:88-90). Python-2 `round` rounds half
away from zero; that behavior is preserved here.
"""

from __future__ import annotations

import copy
import functools
import logging
import math
import multiprocessing

import numpy as np
from scipy import io as sio

logger = logging.getLogger(__name__)

EVENT_NUM = 61
THRESH_NUM = 1000


def _round_half_away(x):
    """Python-2 round(): half away from zero."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def read_pred(pred_dir, gt_mat_path):
    """Load per-image prediction files named after the gt event/image lists;
    rows are (x, y, w, h, score) sorted by descending score."""
    gt_data = sio.loadmat(gt_mat_path)
    pred_list = []
    # The official toolkit hard-codes 61 events; derive the count from the
    # mat itself so smaller (synthetic) ground-truth sets evaluate too.
    n_events = gt_data["event_list"].shape[0]
    for i in range(n_events):
        img_list = gt_data["file_list"][i][0]
        event = gt_data["event_list"][i][0][0]
        bbx_list = []
        for j in range(img_list.shape[0]):
            name = img_list[j][0][0]
            path = f"{pred_dir}/{event}/{name}.txt"
            try:
                with open(path) as f:
                    lines = [x.strip() for x in f.readlines()]
                n = int(lines[1])
                bbx = np.zeros((n, 5))
                for k in range(n):
                    bbx[k] = [float(v) for v in lines[k + 2].split()]
                bbx_list.append(bbx[bbx[:, -1].argsort()[::-1]])
            except Exception:
                logger.error("Fail to parse the prediction file %s %s",
                             event, name)
                bbx_list.append(None)
        pred_list.append(bbx_list)
    return pred_list


def norm_score(org_pred_list):
    """Global min-max normalization of all scores (wider_eval.py:41-56)."""
    max_score, min_score = 0.0, np.inf
    for preds in org_pred_list:
        stacked = np.vstack([p for p in preds if p is not None and p.size])
        max_score = max(max_score, stacked[:, -1].max())
        min_score = min(min_score, stacked[:, -1].min())
    out = []
    for preds in org_pred_list:
        event_out = []
        for p in preds:
            if p is None:
                event_out.append(p)
                continue
            q = p.copy()
            # Guard the degenerate all-one-score case (e.g. random-weight
            # smoke runs): the reference would divide by zero here.
            span = max_score - min_score
            q[:, -1] = (q[:, -1] - min_score) / span if span > 0 else 1.0
            event_out.append(q)
        out.append(event_out)
    return out


def _box_overlap(gts, box):
    """IoU of one box against all gts, +1 convention; degenerate unions
    treated as inf (→ IoU 0), negative intersections zeroed
    (wider_eval.py:59-74)."""
    x1 = np.maximum(gts[:, 0], box[0])
    y1 = np.maximum(gts[:, 1], box[1])
    x2 = np.minimum(gts[:, 2], box[2])
    y2 = np.minimum(gts[:, 3], box[3])
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    inter = w * h
    garea = (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
    barea = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    union = garea + barea - inter
    union = np.where(union == 0, np.inf, union)
    o = inter / union
    o[w <= 0] = 0
    o[h <= 0] = 0
    return o


def image_evaluation(pred_info, gt_bbx, ignore, iou_thresh, mimic_eval_bug):
    """Greedy per-image matching (wider_eval.py:77-100). Both inputs are in
    (x, y, w, h) form and converted to corners in place, as the original
    does. Returns (pred_recall, proposal_list)."""
    pred_recall = np.zeros((pred_info.shape[0], 1))
    recall_list = np.zeros((gt_bbx.shape[0], 1))
    proposal_list = np.ones((pred_info.shape[0], 1))
    pred_info[:, 2] = pred_info[:, 2] + pred_info[:, 0]
    pred_info[:, 3] = pred_info[:, 3] + pred_info[:, 1]
    gt_bbx[:, 2] = gt_bbx[:, 2] + gt_bbx[:, 0]
    gt_bbx[:, 3] = gt_bbx[:, 3] + gt_bbx[:, 1]
    for h in range(pred_info.shape[0]):
        overlap_list = _box_overlap(gt_bbx, pred_info[h, :4])
        if mimic_eval_bug:
            overlap_list = np.array(
                [_round_half_away(v) for v in overlap_list], dtype=np.float64)
        idx = int(np.argmax(overlap_list))
        max_overlap = overlap_list[idx]
        if max_overlap >= iou_thresh:
            if ignore[idx] == 0:
                recall_list[idx] = -1
                proposal_list[h] = -1
            elif recall_list[idx] == 0:
                recall_list[idx] = 1
        pred_recall[h] = np.count_nonzero(recall_list == 1)
    return pred_recall, proposal_list


def image_pr_info(pred_info, proposal_list, pred_recall):
    """Per-image contribution to the PR curve at the 1000 score thresholds
    (wider_eval.py:103-116), vectorized: scores are descending (read_pred
    sorts), so the last index ≥ thresh and the prefix proposal count come
    from a searchsorted + cumsum instead of a python loop per threshold."""
    img_pr_info = np.zeros((THRESH_NUM, 2))
    scores = pred_info[:, -1]
    threshs = 1.0 - (np.arange(1, THRESH_NUM + 1)) / THRESH_NUM
    # scores descending: count of entries >= thresh via searchsorted on the
    # ascending reversal; r_index = count - 1
    counts = len(scores) - np.searchsorted(scores[::-1], threshs,
                                           side="left")
    prop_cum = np.cumsum(proposal_list[:, 0] == 1)
    valid = counts > 0
    r_index = counts[valid] - 1
    img_pr_info[valid, 0] = prop_cum[r_index]
    img_pr_info[valid, 1] = pred_recall[r_index, 0]
    return img_pr_info


def voc_ap(rec, prec):
    mrec = np.hstack([0, rec, 1])
    mpre = np.hstack([0, prec, 0])
    for i in range(mpre.shape[0] - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])


def _evaluate_setting(args):
    norm_pred_list, gt_dir, mimic_eval_bug, iou_thresh = args
    gt_data = sio.loadmat(gt_dir)
    org_pr_curve = np.zeros((THRESH_NUM, 2))
    count_face = 0
    img_list = np.vstack([e[0] for e in gt_data["file_list"]])
    gt_bbx_list = np.vstack([e[0] for e in gt_data["face_bbx_list"]])
    pred_list = functools.reduce(lambda a, b: a + b, norm_pred_list)
    sub_gt_list = np.vstack([e[0] for e in gt_data["gt_list"]])
    for j in range(img_list.shape[0]):
        gt_bbx = copy.copy(gt_bbx_list[j][0])
        pred_info = pred_list[j]
        keep_index = sub_gt_list[j][0] - 1
        count_face += keep_index.shape[0]
        if gt_bbx.size == 0 or pred_info is None or pred_info.size == 0:
            continue
        pred_info = copy.copy(pred_info)
        ignore = np.zeros((gt_bbx.shape[0], 1))
        if keep_index.size > 0:
            ignore[keep_index] = 1
        pred_recall, proposal_list = image_evaluation(
            pred_info, gt_bbx, ignore, iou_thresh, mimic_eval_bug)
        org_pr_curve += image_pr_info(pred_info, proposal_list, pred_recall)
    pr_curve = np.zeros((THRESH_NUM, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        pr_curve[:, 0] = org_pr_curve[:, 1] / org_pr_curve[:, 0]
        pr_curve[:, 1] = org_pr_curve[:, 1] / count_face
    pr_curve[np.isnan(pr_curve)] = 0
    return pr_curve


def wider_eval(pred_dir, gt_dir_base, silent=True, parallel=True,
               mimic_eval_bug=True, iou_thresh=0.5):
    """Returns ([easy_ap, medium_ap, hard_ap], pr_curves)."""
    gt_dir = f"{gt_dir_base}/wider_face_val.mat"
    pred_list = read_pred(pred_dir, gt_dir)
    norm_pred_list = norm_score(pred_list)
    settings = ["easy_val", "medium_val", "hard_val"]
    work = [(norm_pred_list, f"{gt_dir_base}/wider_{s}.mat",
             mimic_eval_bug, iou_thresh) for s in settings]
    if parallel:
        with multiprocessing.Pool(3) as pool:
            pr_curves = pool.map(_evaluate_setting, work)
    else:
        pr_curves = [_evaluate_setting(w) for w in work]
    ap = [voc_ap(pr[:, 1], pr[:, 0]) for pr in pr_curves]
    return ap, pr_curves
