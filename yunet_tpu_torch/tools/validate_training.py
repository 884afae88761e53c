"""End-to-end training validation: overfit a tiny synthetic face dataset
and verify the trained detector localizes every face — counterpart of
``tools/validate_training.py``.

Proves the full loop (SimOTA assignment -> losses -> gradients -> BN ->
decode -> NMS) without WIDER Face images: 8 images at 160^2, 600 steps,
then recall@IoU0.5 of the f32 detector at score 0.3 (the gate: >= 0.9)
and the mean keypoint error of the matched faces.

The faces are drawn with OpenCV (``make_dataset``, JAX's drawing). A host
without OpenCV (the card host) reads the same arrays from an ``.npz``:
tests/fixtures/validate_training_160.npz holds ``make_dataset(8, 160,
RandomState(0), 8)``, the set ``run()`` draws by default.

  python -m yunet_tpu_torch.tools.validate_training --steps 600 \\
      --data tests/fixtures/validate_training_160.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures",
    "validate_training_160.npz")
MAX_GTS = 8
DATA_KEYS = ("imgs", "bboxes", "kps", "valid")


def make_face(img, cx, cy, s, rng):
    """Draw a crude synthetic 'face'; returns (bbox, kps (5,3))."""
    import cv2

    x1, y1 = int(cx - s / 2), int(cy - s / 2)
    x2, y2 = int(cx + s / 2), int(cy + s / 2)
    cv2.ellipse(img, (int(cx), int(cy)), (int(s * 0.45), int(s * 0.5)),
                0, 0, 360, (140, 170, 210), -1)
    eye_y = cy - s * 0.15
    kps = []
    for dx in (-s * 0.2, s * 0.2):
        cv2.circle(img, (int(cx + dx), int(eye_y)), max(1, int(s * 0.07)),
                   (20, 20, 30), -1)
        kps.append((cx + dx, eye_y))
    kps.append((cx, cy + s * 0.05))  # nose
    cv2.circle(img, (int(cx), int(cy + s * 0.05)), max(1, int(s * 0.05)),
               (60, 80, 120), -1)
    mouth_y = cy + s * 0.28
    for dx in (-s * 0.15, s * 0.15):
        kps.append((cx + dx, mouth_y))
    cv2.line(img, (int(cx - s * 0.15), int(mouth_y)),
             (int(cx + s * 0.15), int(mouth_y)), (40, 40, 70), 2)
    bbox = [x1, y1, x2, y2]
    return bbox, [(x, y, 1.0) for x, y in kps]


def make_dataset(n_imgs, img_size, rng, max_gts):
    """(imgs (N, S, S, 3) f32, bboxes (N, G, 4), kps (N, G, 5, 3),
    valid (N, G)) of seeded synthetic faces."""
    imgs, bboxes, kpss, valids = [], [], [], []
    for _ in range(n_imgs):
        img = np.full((img_size, img_size, 3),
                      rng.randint(40, 90), np.uint8)
        noise = rng.randint(0, 30, img.shape).astype(np.uint8)
        img = img + noise
        n = rng.randint(2, 5)
        bb = np.zeros((max_gts, 4), np.float32)
        kk = np.zeros((max_gts, 5, 3), np.float32)
        placed = 0
        for _ in range(n):
            s = rng.uniform(24, 56)
            cx = rng.uniform(s, img_size - s)
            cy = rng.uniform(s, img_size - s)
            # avoid heavy overlap with already-placed faces
            ok = all(abs(cx - bb[j, 0:2].mean()) + abs(cy - bb[j, 1]) > s
                     for j in range(placed)) if placed else True
            if not ok:
                continue
            box, kps = make_face(img, cx, cy, s, rng)
            bb[placed] = box
            kk[placed] = kps
            placed += 1
        imgs.append(img.astype(np.float32))
        bboxes.append(bb)
        kpss.append(kk)
        valids.append(np.arange(max_gts) < placed)
    return (np.stack(imgs), np.stack(bboxes), np.stack(kpss),
            np.stack(valids))


def save_data(path, data) -> None:
    """Write make_dataset's arrays (images as uint8: their values are
    whole numbers in [0, 255])."""
    imgs = data[0]
    if not np.array_equal(imgs, imgs.astype(np.uint8)):
        raise ValueError("images are not whole numbers in [0, 255]")
    np.savez_compressed(path, imgs=imgs.astype(np.uint8),
                        **dict(zip(DATA_KEYS[1:], data[1:])))


def load_data(path=FIXTURE):
    """make_dataset's arrays from an .npz written by save_data."""
    with np.load(path) as z:
        return (z["imgs"].astype(np.float32), z["bboxes"], z["kps"],
                z["valid"])


def train_config(img_size, max_gts=MAX_GTS):
    """yunet_n with the overfit run's data and schedule."""
    from ..config import yunet_n
    cfg = yunet_n()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_size=img_size,
                                 max_gts=max_gts),
        train=dataclasses.replace(cfg.train, lr=0.005, warmup_iters=100,
                                  lr_decay_epochs=(10 ** 9,)))


def train_batch(data, device):
    imgs, bbs, kks, vals = data
    return {
        "image": torch.from_numpy(imgs).to(device),
        "gt_bboxes": torch.from_numpy(bbs).to(device),
        "gt_labels": torch.zeros(bbs.shape[:2], dtype=torch.int32,
                                 device=device),
        "gt_kps": torch.from_numpy(kks).to(device),
        "gt_valid": torch.from_numpy(vals).to(device),
    }


def run(steps=600, img_size=160, n_imgs=8, seed=0, verbose=True, *,
        data=None, device="cuda", state_dict=None):
    """Overfit and score; returns (recall, mean keypoint error in px).
    data: make_dataset's arrays (default: drawn from RandomState(seed)
    with OpenCV). device: where the step and the detector run.
    state_dict: the initial YuNet weights (default: the seeded init)."""
    from ..eval.detect import Detector
    from ..train import init_train_state, make_train_step

    if data is None:
        data = make_dataset(n_imgs, img_size, np.random.RandomState(seed),
                            MAX_GTS)
    imgs, bbs, kks, vals = data
    n_imgs, img_size = imgs.shape[0], imgs.shape[1]
    batch = train_batch(data, device)
    cfg = train_config(img_size, bbs.shape[1])
    ts, opt = init_train_state(cfg, steps_per_epoch=10 ** 6,
                               total_batch=n_imgs, device=device,
                               state_dict=state_dict)
    step = make_train_step(cfg, ts.model, opt, img_size=img_size)
    for i in range(steps):
        ts, m = step(ts, batch)
        if verbose and (i + 1) % 100 == 0:
            print(f"step {i + 1}: loss {float(m['loss']):.3f} "
                  f"(bbox {float(m['loss_bbox']):.3f} "
                  f"obj {float(m['loss_obj']):.3f}) "
                  f"num_pos {float(m['num_pos']):.0f}", flush=True)

    det = Detector(cfg, ts.model, device=device, dtype=torch.float32)
    matched, total, kps_err = 0, 0, []
    for i in range(n_imgs):
        r = det.detect(imgs[i].astype(np.uint8), mode="AUTO",
                       score_thr=0.3)
        gt = bbs[i][vals[i]]
        gt_kps = kks[i][vals[i]]
        total += gt.shape[0]
        for g in range(gt.shape[0]):
            if r["bboxes"].shape[0] == 0:
                continue
            x1 = np.maximum(r["bboxes"][:, 0], gt[g, 0])
            y1 = np.maximum(r["bboxes"][:, 1], gt[g, 1])
            x2 = np.minimum(r["bboxes"][:, 2], gt[g, 2])
            y2 = np.minimum(r["bboxes"][:, 3], gt[g, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            a1 = ((r["bboxes"][:, 2] - r["bboxes"][:, 0])
                  * (r["bboxes"][:, 3] - r["bboxes"][:, 1]))
            a2 = (gt[g, 2] - gt[g, 0]) * (gt[g, 3] - gt[g, 1])
            iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
            j = int(iou.argmax())
            if iou[j] >= 0.5:
                matched += 1
                pred_kp = r["kps"][j].reshape(5, 2)
                kps_err.append(np.abs(pred_kp
                                      - gt_kps[g, :, :2]).mean())
    recall = matched / max(total, 1)
    mean_kp_err = float(np.mean(kps_err)) if kps_err else float("inf")
    if verbose:
        print(f"overfit recall@IoU0.5: {recall:.3f} ({matched}/{total}); "
              f"mean kps error {mean_kp_err:.1f}px")
    return recall, mean_kp_err


def main(argv=None, *, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--img-size", type=int, default=160)
    p.add_argument("--data", default=None,
                   help="an .npz of make_dataset's arrays (e.g. "
                   "tests/fixtures/validate_training_160.npz) in place of "
                   "drawing them with OpenCV")
    args = p.parse_args(argv)
    data = load_data(args.data) if args.data else None
    if data is not None and data[0].shape[1] != args.img_size:
        p.error(f"--data holds {data[0].shape[1]}^2 images, not "
                f"{args.img_size}^2")
    recall, kp_err = run(steps=args.steps, img_size=args.img_size,
                         data=data, device=device)
    if recall < 0.9:
        raise SystemExit(f"FAIL: recall {recall:.3f} < 0.9")
    print("PASS")
    return recall, kp_err


if __name__ == "__main__":
    main()
