"""Generate a synthetic WIDER-Face-shaped dataset on disk — counterpart of
``tools/make_synth_wider.py``, drawing the same random numbers and the
same pixels for the same seed.

  python -m yunet_tpu_torch.tools.make_synth_wider --out data/synth_wider \\
      --tier hard --train-n 600 --val-n 64

Layout (the WIDER layout: labelv2 files, images, val GT .mat files):

  <out>/train/images/<event>/<stem>.jpg       mixed resolutions
  <out>/train/labelv2.txt                     # path W H + face rows
  <out>/val/images/... , <out>/val/labelv2.txt
  <out>/val/gt/wider_{face,easy,medium,hard}_val.mat

Faces are structured renders (skin-tone ellipse, dark eyes, nose, mouth)
with the canonical 5-landmark layout, so a detector can learn
localization and keypoint regression from this data. Difficulty subsets
mirror WIDER semantics: easy within medium within hard by face size.

Two difficulty tiers (--tier):

  base  clean renders, faces >= 12 px.
  hard  a WIDER-hard-like operating point: faces down to ~5 px, dense
        crowd images (tens of tiny faces), partial occlusion (occluded
        landmarks annotated invisible, labelv2 -1 rows), border
        truncation, image-level blur/noise/low-contrast, face-like
        distractors that are NOT annotated, and ignore regions (labelv2
        5-value ignore lines; in the val GT face_bbx_list but in no keep
        list, the official ignore semantics).

The renderers draw with OpenCV, imported when they run: this is a tool
for a host that has OpenCV. ``write_gt_mats`` needs only numpy and scipy.
"""

from __future__ import annotations

import argparse
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


# Difficulty tiers. "base" is the clean set; "hard" approximates the
# WIDER-hard operating point, whose difficulty comes from tiny, occluded
# and crowded faces.
TIERS = {
    "base": dict(min_face=12, max_faces=14, smax_frac=0.5,
                 crowd_frac=0.0, crowd_faces=(0, 0), occl_frac=0.0,
                 trunc_frac=0.0, ignore_frac=0.0, distractors=(0, 0),
                 degrade=False),
    # tinier faces, crowds and stronger blur than base: a trained
    # yunet_n lands mid-range on hard AP here instead of ~1.0
    "hard": dict(min_face=4, max_faces=18, smax_frac=0.45,
                 crowd_frac=0.35, crowd_faces=(24, 110), occl_frac=0.35,
                 trunc_frac=0.20, ignore_frac=0.06, distractors=(3, 12),
                 degrade=True),
}


def occlude_face(img, bbox, kps, rng):
    """Cover 25-55% of the face from one side with a solid occluder;
    landmarks under it become invisible (labelv2 all -1 row -> weight 0)."""
    import cv2

    x1, y1, x2, y2 = bbox
    w, h = x2 - x1, y2 - y1
    frac = rng.uniform(0.25, 0.55)
    side = rng.randint(4)
    if side == 0:    # left strip
        ox1, oy1, ox2, oy2 = x1, y1, x1 + frac * w, y2
    elif side == 1:  # right strip
        ox1, oy1, ox2, oy2 = x2 - frac * w, y1, x2, y2
    elif side == 2:  # bottom strip
        ox1, oy1, ox2, oy2 = x1, y2 - frac * h, x2, y2
    else:            # top strip
        ox1, oy1, ox2, oy2 = x1, y1, x2, y1 + frac * h
    color = tuple(int(c) for c in rng.randint(0, 200, 3))
    cv2.rectangle(img, (int(ox1), int(oy1)), (int(ox2), int(oy2)),
                  color, -1)
    covered = ((kps[:, 0] >= ox1) & (kps[:, 0] <= ox2)
               & (kps[:, 1] >= oy1) & (kps[:, 1] <= oy2))
    kps[covered] = -1.0
    return kps


def draw_distractor(img, cx, cy, s, rng):
    """Face-LIKE clutter that is not annotated: skin-tone blobs that are
    featureless, feature-scrambled, or layout-inverted."""
    import cv2

    kind = rng.randint(3)
    axes = (max(int(0.40 * s), 2), max(int(0.50 * s), 2))
    cv2.ellipse(img, ((cx, cy), (2 * axes[0], 2 * axes[1]),
                      float(rng.uniform(-30, 30))),
                _skin(rng), -1, lineType=cv2.LINE_AA)
    dark = (int(rng.randint(10, 60)),) * 3
    er = max(int(0.07 * s), 1)
    if kind == 1:      # scrambled: dots at random interior positions
        for _ in range(rng.randint(2, 5)):
            px = cx + rng.uniform(-0.30, 0.30) * s
            py = cy + rng.uniform(-0.40, 0.40) * s
            cv2.circle(img, (int(px), int(py)), er, dark, -1,
                       lineType=cv2.LINE_AA)
    elif kind == 2:    # inverted layout: mouth above, eyes below
        cv2.line(img, (int(cx - 0.15 * s), int(cy - 0.25 * s)),
                 (int(cx + 0.15 * s), int(cy - 0.25 * s)),
                 (40, 40, 120), max(er // 2, 1), lineType=cv2.LINE_AA)
        for dx in (-0.18 * s, 0.18 * s):
            cv2.circle(img, (int(cx + dx), int(cy + 0.15 * s)), er, dark,
                       -1, lineType=cv2.LINE_AA)


def degrade_image(img, rng):
    """Low contrast + blur + sensor noise (applied image-wide AFTER all
    drawing, so tiny faces genuinely approach the detectability floor)."""
    import cv2

    out = img.astype(np.float32)
    alpha = rng.uniform(0.45, 1.0)          # contrast compression
    beta = rng.uniform(-20, 40)             # brightness shift
    out = out * alpha + beta
    sigma = rng.uniform(0.0, 2.8)
    if sigma > 0.3:
        k = int(sigma * 3) * 2 + 1
        out = cv2.GaussianBlur(out, (k, k), sigma)
    out = out + rng.normal(0, rng.uniform(2, 14), out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


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


def make_image(rng, w, h, tier=TIERS["base"]):
    """One synthetic image + its face annotations.

    Returns (img, boxes (n,4) xyxy, kps (n,5,3), ignore (n,) bool)."""
    img = make_background(rng, h, w)
    boxes, kpss = [], []
    min_face = tier["min_face"]
    crowd = rng.uniform() < tier["crowd_frac"]
    if crowd:
        n = int(rng.randint(tier["crowd_faces"][0],
                            tier["crowd_faces"][1] + 1))
        # tiny faces scattered around a few cluster centers
        centers = rng.uniform([0.15 * w, 0.15 * h], [0.85 * w, 0.85 * h],
                              (rng.randint(1, 4), 2))
        sizes = np.exp(rng.uniform(np.log(min_face), np.log(28.0), n))
        spread = 0.18 * min(w, h) * rng.uniform(1.0, 2.5)
        overlap_thr = 0.35
    else:
        n = int(rng.randint(1, tier["max_faces"] + 1))
        smax = tier["smax_frac"] * min(w, h)
        sizes = np.exp(rng.uniform(np.log(min_face), np.log(smax), n))
        centers, spread, overlap_thr = None, None, 0.15
    for s in sizes:
        s = float(s)
        trunc = rng.uniform() < tier["trunc_frac"]
        placed = False
        for _try in range(25):
            if centers is not None:
                c = centers[rng.randint(len(centers))]
                cx = float(np.clip(c[0] + rng.normal(0, spread),
                                   0.55 * s, w - 0.55 * s))
                cy = float(np.clip(c[1] + rng.normal(0, spread),
                                   0.6 * s, h - 0.6 * s))
            elif trunc:
                # center near a border so the box clips (partial face)
                edge = rng.randint(4)
                if edge == 0:
                    cx, cy = rng.uniform(-0.2 * s, 0.35 * s), \
                        rng.uniform(0.6 * s, h - 0.6 * s)
                elif edge == 1:
                    cx, cy = w + rng.uniform(-0.35 * s, 0.2 * s), \
                        rng.uniform(0.6 * s, h - 0.6 * s)
                elif edge == 2:
                    cx, cy = rng.uniform(0.55 * s, w - 0.55 * s), \
                        rng.uniform(-0.2 * s, 0.4 * s)
                else:
                    cx, cy = rng.uniform(0.55 * s, w - 0.55 * s), \
                        h + rng.uniform(-0.4 * s, 0.2 * s)
            else:
                cx = rng.uniform(0.55 * s, w - 0.55 * s)
                cy = rng.uniform(0.6 * s, h - 0.6 * s)
            cand = np.asarray([cx - 0.5 * s, cy - 0.6 * s,
                               cx + 0.5 * s, cy + 0.6 * s], np.float32)
            if _try_place(boxes, cand, overlap_thr):
                placed = True
                break
        if not placed:
            continue
        bbox, kps = draw_face(img, cx, cy, s, rng)
        if tier["occl_frac"] and rng.uniform() < tier["occl_frac"]:
            kps = occlude_face(img, bbox, kps, rng)
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
    lo, hi = tier["distractors"]
    if hi:
        for _ in range(rng.randint(lo, hi + 1)):
            s = float(np.exp(rng.uniform(np.log(min_face),
                                         np.log(0.3 * min(w, h)))))
            for _try in range(15):
                cx = rng.uniform(0.55 * s, max(w - 0.55 * s, 0.56 * s))
                cy = rng.uniform(0.6 * s, max(h - 0.6 * s, 0.61 * s))
                cand = np.asarray([cx - 0.5 * s, cy - 0.6 * s,
                                   cx + 0.5 * s, cy + 0.6 * s], np.float32)
                if _try_place(boxes, cand, 0.05):   # keep off real faces
                    draw_distractor(img, cx, cy, s, rng)
                    break
    if tier["degrade"]:
        img = degrade_image(img, rng)
    boxes = np.stack(boxes)
    kpss = np.stack(kpss)
    heights = boxes[:, 3] - boxes[:, 1]
    ign = rng.uniform(size=len(boxes)) < tier["ignore_frac"]
    ign |= heights < 4.0   # sub-detectable slivers are always ignore
    if ign.all():          # keep >= 1 usable face per image
        ign[int(np.argmax(heights))] = False
    return img, boxes, kpss, ign


_RESOLUTIONS = [(1024, 768), (1024, 680), (900, 600), (800, 600),
                (768, 1024), (640, 480), (512, 384), (1000, 562),
                (600, 800), (512, 768)]


def _face_lines(boxes, kpss, ign):
    """labelv2 rows: full 19-value lines for usable faces, 5-value
    ``x1 y1 x2 y2 1`` ignore lines (data/labelv2.py parse contract)."""
    lines = []
    for b, k, i in zip(boxes, kpss, ign):
        vals = [f"{v:.1f}" for v in b]
        if i:
            lines.append(" ".join(vals) + " 1")
            continue
        for p in k:
            if np.all(p == -1):
                vals += ["-1", "-1", "-1"]   # occluded: invisible
            else:
                vals += [f"{p[0]:.1f}", f"{p[1]:.1f}", f"{p[2]:.0f}"]
        lines.append(" ".join(vals))
    return lines


def generate_split(out_dir, n_images, seed, events=4, jpeg_quality=90,
                   tier=TIERS["base"]):
    """Write images + labelv2.txt; return per-event annotation lists."""
    import cv2

    rng = np.random.RandomState(seed)
    img_root = os.path.join(out_dir, "images")
    lines = []
    per_event = {}
    for i in range(n_images):
        ev = f"{i % events}--Synth"
        ev_dir = os.path.join(img_root, ev)
        os.makedirs(ev_dir, exist_ok=True)
        w, h = _RESOLUTIONS[rng.randint(len(_RESOLUTIONS))]
        img, boxes, kpss, ign = make_image(rng, w, h, tier)
        stem = f"synth_{i:04d}"
        path = os.path.join(ev_dir, stem + ".jpg")
        q = (int(rng.randint(45, jpeg_quality + 1)) if tier["degrade"]
             else jpeg_quality)
        assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, q])
        lines.append(f"# {ev}/{stem}.jpg {w} {h}")
        lines.extend(_face_lines(boxes, kpss, ign))
        per_event.setdefault(ev, []).append((stem, boxes, kpss, ign))
    with open(os.path.join(out_dir, "labelv2.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return per_event


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="data/synth_wider")
    p.add_argument("--train-n", type=int, default=600)
    p.add_argument("--val-n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jpeg-quality", type=int, default=90)
    p.add_argument("--tier", choices=sorted(TIERS), default="base")
    args = p.parse_args(argv)

    tier = TIERS[args.tier]
    train_dir = os.path.join(args.out, "train")
    val_dir = os.path.join(args.out, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    generate_split(train_dir, args.train_n, args.seed,
                   jpeg_quality=args.jpeg_quality, tier=tier)
    per_event = generate_split(val_dir, args.val_n, args.seed + 7919,
                               jpeg_quality=args.jpeg_quality, tier=tier)
    write_gt_mats(os.path.join(val_dir, "gt"), per_event)
    print(f"wrote {args.train_n} train + {args.val_n} val images "
          f"({args.tier} tier) under {args.out}")
    return args.out


if __name__ == "__main__":
    main()
