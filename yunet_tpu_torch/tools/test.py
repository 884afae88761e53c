"""Generic evaluation entry — counterpart of ``tools/test.py`` (reference
tools/test.py role): run inference over the val set and report the
in-training metric (VOC mAP @0.5 on the labelv2 annotations), optionally
dumping raw results.

  python -m yunet_tpu_torch.tools.test yunet_n weights.pth --eval mAP \\
      --cache-dir data/widerface/val_cache

Weights: whatever ``apis.read_weights`` reads (a reference ``.pth``, a
flat ``.npz`` of JAX parameter leaves, a training ``ckpt_*`` directory).
Images come from ``cv2.imread`` under ``--img-prefix``, or, with
``--cache-dir``, from the decoded ``.npy`` cache (``data/cache.py``; no
OpenCV needed). A missing image raises.
"""

from __future__ import annotations

import argparse
import ast
import os
import pickle
import time

from ..apis import read_weights
from ..config import get_config
from ..data import parse_labelv2
from ..data.cache import load_cached
from ..eval.detect import Detector
from ..eval.widerface import eval_map


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("checkpoint")
    p.add_argument("--eval", default="mAP", choices=["mAP", "none"])
    p.add_argument("--out", default=None, help="pickle results here")
    p.add_argument("--ann", default=None)
    p.add_argument("--img-prefix", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--mode", default="(640, 640)",
                   help="detector resize mode")
    p.add_argument("--cache-dir", default=None,
                   help="read images from this decoded .npy cache "
                   "(data/cache.py layout) instead of decoding the JPEGs")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """Returns the mAP@0.5 (None with ``--eval none``). ``device``: where
    the Detector runs (the tests pass the CPU)."""
    args = parse_args(argv)
    cfg = get_config(args.config)
    ann = args.ann or cfg.data.val_ann
    img_prefix = args.img_prefix or cfg.data.val_img_prefix
    det = Detector(cfg, read_weights(cfg, args.checkpoint), device=device)
    try:
        mode = ast.literal_eval(args.mode)
    except (ValueError, SyntaxError):
        mode = args.mode

    if args.cache_dir is None:
        import cv2

        def load(rec):
            return cv2.imread(os.path.join(img_prefix, rec.filename))
    else:
        def load(rec):
            return load_cached(args.cache_dir, rec.filename)

    records = parse_labelv2(ann, test_mode=True)
    if args.limit:
        records = records[:args.limit]
    dets, anns = [], []
    t0 = time.time()
    for i, rec in enumerate(records):
        img = load(rec)
        if img is None:
            raise SystemExit(f"missing {rec.filename}")
        r = det.detect(img, mode=mode)
        dets.append(r["bboxes"])
        anns.append({"bboxes": rec.bboxes,
                     "bboxes_ignore": rec.bboxes_ignore})
        if (i + 1) % 200 == 0:
            print(f"{i + 1}/{len(records)} "
                  f"({(i + 1) / (time.time() - t0):.1f} img/s)")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(dets, f)
        print(f"wrote {args.out}")
    if args.eval == "mAP":
        ap = eval_map(dets, anns, iou_thr=0.5)
        print(f"mAP@0.5: {ap:.4f}")
        return ap
    return None


if __name__ == "__main__":
    main()
