"""WIDER Face val evaluation on the port — counterpart of
``tools/test_widerface.py`` (reference tools/test_widerface.py parity).

Modes (same numbering as the reference, :84-96):
  0  -> 640x640 letterboxed
  1  -> 1100x1650 letterboxed
  2  -> origin size, padded to /32 (the headline protocol)
  N>30 -> NxN letterboxed

  python -m yunet_tpu_torch.tools.test_widerface yunet_n weights.pth \\
      --mode 2 --cache-dir data/widerface/val_cache --device-nms

Weights: a reference ``.pth`` or a flat ``.npz`` of JAX parameter leaves
(``apis.init_detector``). Images come from ``cv2.imread`` under
``--img-prefix``, or, with ``--cache-dir``, from the decoded ``.npy``
cache (``data/cache.py``; no OpenCV needed). A missing image raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from ..apis import init_detector
from ..config import get_config
from ..data import parse_labelv2
from ..data.cache import load_cached
from ..eval import wider_evaluation, widerface_eval_mode
from ..utils.autorank import AutoRank


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate on WIDER Face val")
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("checkpoint")
    p.add_argument("--mode", type=int, default=2)
    p.add_argument("--thr", type=float, default=-1.0,
                   help="override score_thr")
    p.add_argument("--ann", default=None, help="val labelv2.txt path")
    p.add_argument("--img-prefix", default=None)
    p.add_argument("--gt-dir", default=None)
    p.add_argument("--out", default=None,
                   help="dump per-image txt predictions here")
    p.add_argument("--bucket", type=int, default=32,
                   help="origin-size pad divisor (the reference pads /32)")
    p.add_argument("--eval-log", default="./eval.log")
    p.add_argument("--device-nms", action="store_true",
                   help="run the whole-batch NMS kernel in the sweep and "
                   "read back only packed top-k rows (caps detections at "
                   "750/image)")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N images (debug)")
    p.add_argument("--cache-dir", default=None,
                   help="read images from this decoded .npy cache "
                   "(data/cache.py layout) instead of decoding the JPEGs")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """Run the protocol; returns [easy, medium, hard] APs. ``device``: where
    the Detector runs (the tests pass the CPU)."""
    args = parse_args(argv)
    cfg = get_config(args.config)
    if args.thr > 0:
        cfg = dataclasses.replace(cfg, test=dataclasses.replace(
            cfg.test, score_thr=args.thr))
    ann = args.ann or cfg.data.val_ann
    img_prefix = args.img_prefix or cfg.data.val_img_prefix
    gt_dir = args.gt_dir or os.path.join(os.path.dirname(ann), "gt")

    det = init_detector(cfg, args.checkpoint, device=device)
    try:
        mode = widerface_eval_mode(args.mode)
    except ValueError as e:
        raise SystemExit(str(e))

    records = parse_labelv2(ann, test_mode=True)
    if args.limit:
        records = records[:args.limit]
    results = {}
    t0 = time.time()
    done = [0]

    def record_result(rec, out):
        bb = out["bboxes"]
        # xyxy -> xywh rows for the official protocol
        xywh = np.concatenate(
            [bb[:, :2], bb[:, 2:4] - bb[:, :2], bb[:, 4:5]], axis=1)
        event, name = rec.filename.split("/")
        results.setdefault(event, {})[name[:-4]] = xywh.astype(np.float64)

    if args.cache_dir is None:
        import cv2

        def load(rec):
            img = cv2.imread(os.path.join(img_prefix, rec.filename))
            if img is None:
                raise SystemExit(f"missing image {rec.filename}")
            return img
    else:
        def load(rec):
            img = load_cached(args.cache_dir, rec.filename)
            if img is None:
                raise SystemExit(f"missing image {rec.filename}")
            return img

    def progress(idx, res):
        done[0] += 1
        if done[0] % 200 == 0:
            print(f"{done[0]}/{len(records)} images, "
                  f"{done[0] / (time.time() - t0):.1f} img/s")

    outs = det.detect_sweep(
        [((lambda r=rec: load(r)), (rec.height, rec.width))
         for rec in records],
        mode, pad_divisor=args.bucket, on_result=progress,
        use_device_nms=args.device_nms)
    for rec, out in zip(records, outs):
        record_result(rec, out)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for event, imgs in results.items():
            os.makedirs(os.path.join(args.out, event), exist_ok=True)
            for name, rows in imgs.items():
                with open(os.path.join(args.out, event,
                                       name + ".txt"), "w") as f:
                    f.write(f"{event}/{name}.jpg\n{len(rows)}\n")
                    for r in rows:
                        f.write(f"{r[0]:.1f} {r[1]:.1f} {r[2]:.1f} "
                                f"{r[3]:.1f} {r[4]:.5f}\n")

    aps = wider_evaluation(results, gt_dir, verbose=True)
    print(f"AP easy/medium/hard: {aps[0]:.4f} {aps[1]:.4f} {aps[2]:.4f}")
    AutoRank(args.eval_log).update(
        {"easy": aps[0], "medium": aps[1], "hard": aps[2]},
        tag=f"{args.config} mode={args.mode} ckpt={args.checkpoint}")
    return aps


if __name__ == "__main__":
    main()
