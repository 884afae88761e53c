"""The WIDER val ground-truth writer of ``tools/make_synth_wider.py``
(``write_gt_mats``; numpy and scipy). The image renderers there draw with
OpenCV and are not part of this package."""

from __future__ import annotations

import os

import numpy as np


def write_gt_mats(gt_dir, per_event):
    """Official-format GT .mat files (reference widerface.py:63-81 reader).

    per_event: {event: [(stem, boxes (n, 4) xyxy, kps, ignore (n,) bool),
    ...]}. Difficulty subsets mirror WIDER: hard = all faces, medium =
    faces with height >= 30px, easy = height >= 60px (1-based keep
    indices). Ignore faces stay in face_bbx_list but appear in NO keep
    list — detections matching them are neither TP nor FP (reference
    widerface.py:183-220).
    """
    from scipy.io import savemat

    os.makedirs(gt_dir, exist_ok=True)
    names = sorted(per_event)
    e = len(names)
    event_list = np.empty((e, 1), object)
    file_list = np.empty((e, 1), object)
    facebox_list = np.empty((e, 1), object)
    subsets = {"easy": 60.0, "medium": 30.0, "hard": 0.0}
    gt_lists = {s: np.empty((e, 1), object) for s in subsets}
    for i, name in enumerate(names):
        imgs = per_event[name]
        m = len(imgs)
        event_list[i, 0] = np.asarray([name])
        fl = np.empty((m, 1), object)
        fb = np.empty((m, 1), object)
        gls = {s: np.empty((m, 1), object) for s in subsets}
        for j, (stem, boxes, _kps, ign) in enumerate(imgs):
            fl[j, 0] = np.asarray([stem])
            xywh = np.concatenate(
                [boxes[:, :2], boxes[:, 2:4] - boxes[:, :2]], 1)
            fb[j, 0] = xywh.astype(np.float64)
            heights = xywh[:, 3]
            for s, thr in subsets.items():
                keep = np.flatnonzero((heights >= thr) & ~ign) + 1
                # integer dtype like the official mats; the evaluator
                # indexes with these directly
                gls[s][j, 0] = keep.astype(np.int32).reshape(-1, 1)
        file_list[i, 0] = fl
        facebox_list[i, 0] = fb
        for s in subsets:
            gt_lists[s][i, 0] = gls[s]
    savemat(os.path.join(gt_dir, "wider_face_val.mat"), {
        "face_bbx_list": facebox_list, "event_list": event_list,
        "file_list": file_list})
    for s in subsets:
        savemat(os.path.join(gt_dir, f"wider_{s}_val.mat"),
                {"gt_list": gt_lists[s]})
