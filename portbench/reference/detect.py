"""Plain detection: the reference forward with running BN statistics,
score fusion sigmoid(cls) * sigmoid(obj), decode, then greedy NMS per
image over the candidates at or above the score threshold, the top_k
highest first (ties to the lower prior index), a candidate suppressed by
a kept one of higher rank at IoU > the threshold (reference
yunet_head.py:get_bboxes with mmcv's nms; no +1 in the areas).

Besides its detections, each frame's result holds what the check holds
served rows to: the candidates (every prior at or above the score
threshold, at most top_k) and the near set, every prior scoring at least
NEAR times the threshold, so that a served row whose score rounds up
across the threshold still finds the prior that gave it."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .model import Forward, decode, full_f32, priors

NEAR = 0.5


def greedy_nms(boxes: np.ndarray, iou_thr: float) -> List[int]:
    """Keep list of (n, 4) xyxy boxes already in rank order."""
    x1, y1, x2, y2 = (boxes[:, i].astype(np.float64) for i in range(4))
    area = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    alive = np.ones(len(boxes), bool)
    keep = []
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        keep.append(i)
        iw = np.clip(np.minimum(x2[i], x2) - np.maximum(x1[i], x1), 0, None)
        ih = np.clip(np.minimum(y2[i], y2) - np.maximum(y1[i], y1), 0, None)
        inter = iw * ih
        iou = inter / np.maximum(area[i] + area - inter, 1e-9)
        alive &= ~(iou > iou_thr)
        alive[: i + 1] = False
    return keep


def detect_frames(m: dict, test: dict, sd: Dict[str, torch.Tensor],
                  frames: np.ndarray, *, top_k: int, device,
                  precision: str = "f32", block: int = 16) -> List[dict]:
    """frames (N, H, W, 3) uint8 BGR, each its own canvas -> one dict a
    frame: bboxes (n, 5) [x1 y1 x2 y2 score], kps (n, 2K), the box and
    keypoints and score of every candidate (``candidates_geom``,
    ``candidates_score``) and of the near set (``near_geom``,
    ``near_score``)."""
    h, w = frames.shape[1:3]
    pri = priors(m, h, w, device)
    out = []
    with torch.no_grad(), full_f32():
        for s in range(0, len(frames), block):
            x = torch.from_numpy(frames[s:s + block]).to(device).float()
            flat = Forward(m, sd, precision=precision)(
                x.permute(0, 3, 1, 2))
            scores = torch.sigmoid(flat["cls"][..., 0]) * \
                torch.sigmoid(flat["obj"][..., 0])
            boxes, kps = decode(pri, flat["bbox"], flat.get("kps"))
            for i in range(x.shape[0]):
                sc = scores[i].cpu().numpy()
                geom = boxes[i].cpu().numpy()
                if kps is not None:
                    geom = np.concatenate([geom, kps[i].cpu().numpy()], 1)
                near = np.flatnonzero(sc >= NEAR * test["score_thr"])
                cand = np.flatnonzero(sc >= test["score_thr"])
                cand = cand[np.argsort(-sc[cand], kind="stable")][:top_k]
                keep = greedy_nms(geom[cand, :4], test["nms_iou_thr"])
                kept = cand[keep]
                out.append({
                    "bboxes": np.concatenate(
                        [geom[kept, :4], sc[kept, None]], 1),
                    "kps": geom[kept, 4:],
                    "candidates_geom": geom[cand],
                    "candidates_score": sc[cand],
                    "near_geom": geom[near], "near_score": sc[near]})
    return out
