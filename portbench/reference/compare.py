"""The comparison that decides ``correct``: served detections against the
reference's priors, frame by frame.

Every served row is held to the reference prior nearest to it: of the
frame's near set (every prior scoring at least half the score threshold,
so that a row whose score rounds up across the threshold still finds
its own prior), the one whose box corners and keypoints lie closest (the
largest |coordinate difference|). Where two priors of a face score
within rounding of each other either may be the one NMS keeps, and their
boxes lie pixels apart, so a served row is held to the prior that gave
it, not to the reference's kept set. Four numbers come out, each the
worst over the frames:

  score_gap   |score - the nearest prior's score|, over every served row;
  geom_gap    the distance in pixels to the nearest prior, over every
              served row;
  overlap     the largest IoU of two served detections of one frame: NMS
              keeps no pair above its threshold;
  uncovered   the highest score of a reference candidate (at or above the
              score threshold) that no served detection overlaps at an
              IoU of at least the NMS threshold less NMS_BAND: each
              candidate is served or was suppressed by a served
              detection. A candidate's fate at the threshold may flip
              with rounding, and flips chain, so the served set is not
              compared with the reference's kept set itself; a candidate
              whose score rounds down across the score threshold reads
              about that threshold, and a served set cut anywhere above
              it reads the highest score it cut.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

NMS_BAND = 0.05
NUMBERS = ("score_gap", "geom_gap", "overlap", "uncovered")


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) x (m, 4) xyxy -> (n, m)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-9)


def frame_gaps(got: dict, want: dict, iou_thr: float) -> Dict[str, float]:
    """The four numbers for one frame: got holds bboxes (n, 5) [x1 y1 x2
    y2 score] and kps (n, 2K); want holds the reference's candidates
    (``candidates_geom`` (c, 4 + 2K), ``candidates_score`` (c,)) and
    near set (``near_geom``, ``near_score``)."""
    gb = np.asarray(got["bboxes"], np.float64)
    gk = np.asarray(got["kps"], np.float64)
    near = np.asarray(want["near_geom"], np.float64)
    ns = np.asarray(want["near_score"], np.float64)
    cand = np.asarray(want["candidates_geom"], np.float64)
    cs = np.asarray(want["candidates_score"], np.float64)
    out = dict.fromkeys(NUMBERS, 0.0)
    if len(gb):
        if not len(near):
            return dict(out, score_gap=np.inf, geom_gap=np.inf)
        geom = np.concatenate([gb[:, :4], gk], 1)
        dist = np.abs(geom[:, None] - near[None]).max(-1)
        closest = dist.argmin(-1)
        out["geom_gap"] = float(dist.min(-1).max())
        out["score_gap"] = float(np.abs(gb[:, 4] - ns[closest]).max())
    if len(gb) > 1:
        pair = _iou(gb[:, :4], gb[:, :4])
        np.fill_diagonal(pair, 0.0)
        out["overlap"] = float(pair.max())
    if len(cand):
        cover = (_iou(cand[:, :4], gb[:, :4]).max(1) if len(gb)
                 else np.zeros(len(cand)))
        bare = cover < iou_thr - NMS_BAND
        if bare.any():
            out["uncovered"] = float(cs[bare].max())
    return out
