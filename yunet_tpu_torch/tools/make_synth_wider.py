"""Parts of ``tools/make_synth_wider.py``: the WIDER val ground-truth
writer (``write_gt_mats``; numpy and scipy) and the base-tier image
renderer (``make_image``, the TFLite exporter's default int8 calibration
images; it draws with OpenCV, imported when it runs). The hard tier's
renderers are not part of this package."""

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


def _skin(rng):
    # BGR skin-ish tones with variation
    b = rng.randint(90, 160)
    g = rng.randint(120, 190)
    r = rng.randint(170, 240)
    return int(b), int(g), int(r)


def draw_face(img, cx, cy, s, rng):
    """Render one face of nominal size s centered at (cx, cy).

    Returns (bbox_xyxy, kps (5,3)) in image coordinates.
    """
    import cv2

    angle = float(rng.uniform(-12, 12))
    axes = (max(int(0.40 * s), 2), max(int(0.50 * s), 2))
    cv2.ellipse(img, ((cx, cy), (2 * axes[0], 2 * axes[1]), angle),
                _skin(rng), -1, lineType=cv2.LINE_AA)
    # canonical landmark layout with jitter
    j = 0.02 * s
    pts = np.asarray([
        [cx - 0.18 * s, cy - 0.13 * s],   # left eye
        [cx + 0.18 * s, cy - 0.13 * s],   # right eye
        [cx, cy + 0.06 * s],              # nose tip
        [cx - 0.14 * s, cy + 0.27 * s],   # left mouth corner
        [cx + 0.14 * s, cy + 0.27 * s],   # right mouth corner
    ], np.float32) + rng.uniform(-j, j, (5, 2)).astype(np.float32)
    dark = (int(rng.randint(10, 60)),) * 3
    er = max(int(0.07 * s), 1)
    for p in pts[:2]:
        cv2.circle(img, (int(p[0]), int(p[1])), er, dark, -1,
                   lineType=cv2.LINE_AA)
    cv2.circle(img, (int(pts[2][0]), int(pts[2][1])), max(er // 2, 1),
               (60, 80, 120), -1, lineType=cv2.LINE_AA)
    cv2.line(img, (int(pts[3][0]), int(pts[3][1])),
             (int(pts[4][0]), int(pts[4][1])),
             (40, 40, 120), max(er // 2, 1), lineType=cv2.LINE_AA)
    bbox = np.asarray([cx - 0.42 * s, cy - 0.52 * s,
                       cx + 0.42 * s, cy + 0.52 * s], np.float32)
    kps = np.concatenate([pts, np.ones((5, 1), np.float32)], 1)
    return bbox, kps


def make_background(rng, h, w):
    """Smooth gradient + noise + box/circle distractors (non-face clutter)."""
    import cv2

    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    base = rng.uniform(30, 160, (1, 1, 3)).astype(np.float32)
    grad = rng.uniform(-60, 60, (1, 1, 3)).astype(np.float32)
    img = base + yy * grad + xx * rng.uniform(-60, 60, (1, 1, 3))
    img = img + rng.normal(0, 12, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    for _ in range(rng.randint(2, 8)):
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        if rng.uniform() < 0.5:
            x0, y0 = rng.randint(0, w), rng.randint(0, h)
            cv2.rectangle(img, (x0, y0),
                          (x0 + rng.randint(8, w // 3),
                           y0 + rng.randint(8, h // 3)), color, -1)
        else:
            cv2.circle(img, (rng.randint(0, w), rng.randint(0, h)),
                       rng.randint(4, min(h, w) // 5), color, -1)
    return img


def _try_place(boxes, cand, thr):
    for b in boxes:
        ix = max(0.0, min(cand[2], b[2]) - max(cand[0], b[0]))
        iy = max(0.0, min(cand[3], b[3]) - max(cand[1], b[1]))
        if ix * iy > thr * min((cand[2] - cand[0]) * (cand[3] - cand[1]),
                               (b[2] - b[0]) * (b[3] - b[1])):
            return False
    return True


def make_image(rng, w, h):
    """One base-tier synthetic image + its face annotations: the original's
    ``make_image(rng, w, h)`` (TIERS["base"]: 1-14 faces from 12 px to
    half the short side, no crowds, truncation, occlusion, distractors,
    ignore marks or degradation), drawing the same random numbers.

    Returns (img, boxes (n,4) xyxy, kps (n,5,3), ignore (n,) bool)."""
    img = make_background(rng, h, w)
    boxes, kpss = [], []
    rng.uniform()                              # the crowd draw (never)
    n = int(rng.randint(1, 15))
    sizes = np.exp(rng.uniform(np.log(12), np.log(0.5 * min(w, h)), n))
    for s in sizes:
        s = float(s)
        rng.uniform()                          # the truncation draw
        placed = False
        for _try in range(25):
            cx = rng.uniform(0.55 * s, w - 0.55 * s)
            cy = rng.uniform(0.6 * s, h - 0.6 * s)
            cand = np.asarray([cx - 0.5 * s, cy - 0.6 * s,
                               cx + 0.5 * s, cy + 0.6 * s], np.float32)
            if _try_place(boxes, cand, 0.15):
                placed = True
                break
        if not placed:
            continue
        bbox, kps = draw_face(img, cx, cy, s, rng)
        # annotation boxes are clipped to the image like real labelv2
        bbox = np.asarray([max(bbox[0], 0.0), max(bbox[1], 0.0),
                           min(bbox[2], float(w)), min(bbox[3], float(h))],
                          np.float32)
        if bbox[2] - bbox[0] < 2.0 or bbox[3] - bbox[1] < 2.0:
            continue   # clipped away
        boxes.append(bbox)
        kpss.append(kps)
    if not boxes:   # guarantee at least one face
        s = 0.25 * min(w, h)
        bbox, kps = draw_face(img, w / 2, h / 2, s, rng)
        boxes.append(bbox)
        kpss.append(kps)
    boxes = np.stack(boxes)
    kpss = np.stack(kpss)
    heights = boxes[:, 3] - boxes[:, 1]
    ign = rng.uniform(size=len(boxes)) < 0.0
    ign |= heights < 4.0   # sub-detectable slivers are always ignore
    if ign.all():          # keep >= 1 usable face per image
        ign[int(np.argmax(heights))] = False
    return img, boxes, kpss, ign
