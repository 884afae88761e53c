"""WIDER Face validation AP — protocol-exact, vectorized + native matching.
A copy of ``yunet_tpu/eval/widerface.py`` (numpy only), whose matcher is
this package's ``native.wider_match``.

Re-implements the official evaluation used by the reference
(core/evaluation/widerface.py:274-346): global score min-max normalization,
per-image greedy IoU-0.5 matching honoring the per-difficulty keep lists
(easy/medium/hard .mat files), a 1000-threshold PR accumulation, and VOC AP
integration. The per-(pred,gt) matching loop — which the reference farms to
a multiprocessing.Pool(8) — runs in the native C++ kernel here
(csrc/host_nms.cpp:wider_match), with the 1000-threshold PR
curve vectorized via searchsorted.

Prediction format matches the reference harness: per event, per image stem,
an (n, 5) array of [x, y, w, h, score] rows sorted score-descending.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native

THRESH_NUM = 1000


def load_gt(gt_dir: str):
    """Load the 4 official .mat files (same files the reference ships in
    data/widerface/labelv2/val/gt/)."""
    from scipy.io import loadmat

    gt = loadmat(os.path.join(gt_dir, "wider_face_val.mat"))
    subsets = {
        "easy": loadmat(os.path.join(gt_dir, "wider_easy_val.mat")),
        "medium": loadmat(os.path.join(gt_dir, "wider_medium_val.mat")),
        "hard": loadmat(os.path.join(gt_dir, "wider_hard_val.mat")),
    }
    return (gt["face_bbx_list"], gt["event_list"], gt["file_list"],
            {k: v["gt_list"] for k, v in subsets.items()})


def norm_scores(pred: Dict[str, Dict[str, np.ndarray]]
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """Global min-max normalization of all scores to [0, 1]
    (reference norm_score, widerface.py:159-180)."""
    lo, hi = np.inf, -np.inf
    for event in pred.values():
        for v in event.values():
            if len(v):
                lo = min(lo, v[:, -1].min())
                hi = max(hi, v[:, -1].max())
    diff = hi - lo
    if not np.isfinite(diff) or diff == 0:
        return pred
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for event, imgs in pred.items():
        out[event] = {}
        for name, v in imgs.items():
            if len(v):
                v = v.copy()
                v[:, -1] = (v[:, -1] - lo) / diff
            out[event][name] = v
    return out


def _img_pr_info(pred_scores: np.ndarray, proposal: np.ndarray,
                 pred_recall: np.ndarray) -> np.ndarray:
    """Vectorized 1000-threshold PR for one image
    (reference img_pr_info, widerface.py:223-243)."""
    n = pred_scores.shape[0]
    pr = np.zeros((THRESH_NUM, 2))
    if n == 0:
        return pr
    # thresholds t: 1 - (t+1)/1000; r_index = last pred with score >= thr
    thr = 1.0 - (np.arange(THRESH_NUM) + 1.0) / THRESH_NUM
    # scores are descending; count = #scores >= thr via searchsorted on -s
    counts = np.searchsorted(-pred_scores, -thr, side="right")
    cum_prop = np.cumsum(proposal == 1)
    has = counts > 0
    r = np.clip(counts - 1, 0, n - 1)
    pr[has, 0] = cum_prop[r[has]]
    pr[has, 1] = pred_recall[r[has]]
    return pr


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC all-points AP (reference voc_ap, widerface.py:254-271)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def wider_evaluation(pred: Dict[str, Dict[str, np.ndarray]], gt_dir: str,
                     iou_thresh: float = 0.5,
                     verbose: bool = False) -> List[float]:
    """Returns [easy, medium, hard] APs."""
    pred = norm_scores(pred)
    facebox_list, event_list, file_list, gt_lists = load_gt(gt_dir)
    aps = []
    for setting in ("easy", "medium", "hard"):
        gt_list = gt_lists[setting]
        count_face = 0
        pr_curve = np.zeros((THRESH_NUM, 2))
        for i in range(len(event_list)):
            event_name = str(event_list[i][0][0])
            img_list = file_list[i][0]
            pred_list = pred[event_name]
            sub_gt_list = gt_list[i][0]
            gt_bbx_list = facebox_list[i][0]
            for j in range(len(img_list)):
                img_name = str(img_list[j][0][0])
                pred_info = pred_list[img_name]
                gt_boxes = gt_bbx_list[j][0].astype(np.float64)
                keep_index = sub_gt_list[j][0]
                count_face += len(keep_index)
                if len(gt_boxes) == 0 or len(pred_info) == 0:
                    continue
                keep_mask = np.zeros(gt_boxes.shape[0], np.int32)
                if len(keep_index) != 0:
                    ki = np.asarray(keep_index).reshape(-1).astype(np.int64)
                    keep_mask[ki - 1] = 1
                pred_recall, proposal = native.wider_match(
                    pred_info.astype(np.float32),
                    gt_boxes.astype(np.float32), keep_mask, iou_thresh)
                pr_curve += _img_pr_info(pred_info[:, 4], proposal,
                                         pred_recall)
        with np.errstate(divide="ignore", invalid="ignore"):
            propose = np.where(pr_curve[:, 0] > 0,
                               pr_curve[:, 1] / pr_curve[:, 0], 0.0)
            recall = pr_curve[:, 1] / max(count_face, 1)
        ap = voc_ap(recall, propose)
        aps.append(ap)
        if verbose:
            print(f"{setting}: AP = {ap:.5f}")
    return aps


# ---------------------------------------------------------------------------
# generic VOC-style mAP for the in-training eval hook
# (reference core/evaluation/mean_ap.py:522-753, metric='mAP' at IoU 0.5)
# ---------------------------------------------------------------------------

def _tpfp(det: np.ndarray, gt: np.ndarray, gt_ignore: np.ndarray,
          iou_thr: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy TP/FP flags for one image, score-desc det (n, 5)."""
    n, m = det.shape[0], gt.shape[0]
    tp = np.zeros(n)
    fp = np.zeros(n)
    if m == 0 and gt_ignore.shape[0] == 0:
        fp[:] = 1
        return tp, fp
    order = np.argsort(-det[:, 4], kind="stable")
    covered = np.zeros(m, bool)
    all_gt = np.concatenate([gt, gt_ignore], 0) if gt_ignore.size else gt
    n_real = m
    for oi in order:
        box = det[oi, :4]
        if all_gt.shape[0]:
            lt = np.maximum(box[:2], all_gt[:, :2])
            rb = np.minimum(box[2:], all_gt[:, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[:, 0] * wh[:, 1]
            a1 = max((box[2] - box[0]) * (box[3] - box[1]), 0)
            a2 = np.clip(all_gt[:, 2] - all_gt[:, 0], 0, None) * \
                np.clip(all_gt[:, 3] - all_gt[:, 1], 0, None)
            iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
            k = int(iou.argmax())
            if iou[k] >= iou_thr:
                if k < n_real:
                    if not covered[k]:
                        covered[k] = True
                        tp[oi] = 1
                    else:
                        fp[oi] = 1
                # matched an ignore region: neither tp nor fp
                continue
        fp[oi] = 1
    return tp, fp


def eval_map(det_results: Sequence[np.ndarray],
             annotations: Sequence[Dict[str, np.ndarray]],
             iou_thr: float = 0.5) -> float:
    """Single-class VOC mAP over a dataset.

    det_results: per image (n, 5) [x1 y1 x2 y2 score].
    annotations: per image {"bboxes": (m, 4), "bboxes_ignore": (k, 4)}.
    """
    all_tp, all_fp, all_scores = [], [], []
    num_gts = 0
    for det, ann in zip(det_results, annotations):
        gt = ann["bboxes"].reshape(-1, 4)
        ig = ann.get("bboxes_ignore", np.zeros((0, 4))).reshape(-1, 4)
        num_gts += gt.shape[0]
        tp, fp = _tpfp(det.reshape(-1, 5), gt, ig, iou_thr)
        all_tp.append(tp)
        all_fp.append(fp)
        all_scores.append(det.reshape(-1, 5)[:, 4])
    tp = np.concatenate(all_tp)
    fp = np.concatenate(all_fp)
    scores = np.concatenate(all_scores)
    order = np.argsort(-scores, kind="stable")
    tp_c = np.cumsum(tp[order])
    fp_c = np.cumsum(fp[order])
    rec = tp_c / max(num_gts, 1)
    prec = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    return voc_ap(rec, prec)
