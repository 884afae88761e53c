"""Single-image face detection CLI — counterpart of
``tools/detect_image.py`` (reference tools/detect_image.py parity).

  python -m yunet_tpu_torch.tools.detect_image yunet_n weights.pth \\
      photo.npy --out result.npy --fused --device-nms

Weights: whatever ``apis.read_weights`` reads (a reference ``.pth``, a
flat ``.npz`` of JAX parameter leaves, a training ``ckpt_*`` directory),
as JAX's CLI reads them through its ``load_weights``.
Images: an ``.npy`` (HWC uint8 BGR, the ``data/cache.py`` format) is read
and written with numpy, a ``.ppm`` written with numpy, so the card host
needs no OpenCV; any other format goes through ``cv2``, imported for it
alone. Boxes and landmarks are drawn in numpy with the pixels of
``cv2.rectangle(..., 2)`` and ``cv2.circle(..., 1, ..., 2)``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..apis import read_weights
from ..config import get_config
from ..eval.detect import Detector

BOX_BGR = (0, 0, 255)
KPS_BGR = (255, 0, 0)
# the pixels cv2.circle(img, c, 1, color, 2) sets around c
_DOT = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
        if dy * dy + dx * dx <= 5]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Detect faces in one image")
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("checkpoint",
                   help=".pth (reference), flat .npz or ckpt_* directory")
    p.add_argument("image", help=".npy (HWC uint8 BGR) or an image file")
    p.add_argument("--out", default="result.jpg",
                   help=".npy or .ppm (numpy), other formats through cv2")
    p.add_argument("--mode", default="AUTO",
                   help="ORIGIN | AUTO | VGA | 'W,H'")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--device-nms", action="store_true",
                   help="run NMS on the device instead of the host")
    p.add_argument("--fused", action="store_true",
                   help="BN-folded trunk with the fused ConvDP kernel")
    p.add_argument("--no-kps", action="store_true")
    return p.parse_args(argv)


def _cv2(path):
    try:
        import cv2
    except ImportError:
        raise SystemExit(f"{path}: reading or writing this format needs "
                         "OpenCV (cv2), which is not installed; use .npy")
    return cv2


def read_image(path: str) -> np.ndarray:
    """HWC uint8 BGR: an .npy with numpy, other formats with cv2."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise SystemExit(f"{path}: expected HWC uint8 BGR, got "
                             f"{img.dtype} {img.shape}")
        return img
    img = _cv2(path).imread(path)
    if img is None:
        raise SystemExit(f"cannot read image: {path}")
    return img


def write_image(path: str, img: np.ndarray) -> None:
    """.npy and .ppm (binary RGB) with numpy, other formats with cv2."""
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.endswith(".ppm"):
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(np.ascontiguousarray(img[..., ::-1]).tobytes())
    elif not _cv2(path).imwrite(path, img):
        raise SystemExit(f"cannot write image: {path}")


def _fill(img, y0, y1, x0, x1, color) -> None:
    """img[y0:y1 + 1, x0:x1 + 1] = color, clipped to the image."""
    h, w = img.shape[:2]
    y0, x0, y1, x1 = max(y0, 0), max(x0, 0), min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def draw_box(img, x1, y1, x2, y2, color=BOX_BGR) -> None:
    """cv2.rectangle(img, (x1, y1), (x2, y2), color, 2): the one-pixel
    outline, each pixel widened by its four neighbours."""
    xa, xb = sorted((x1, x2))
    ya, yb = sorted((y1, y2))
    for y in (ya, yb):
        _fill(img, y - 1, y + 1, xa, xb, color)
        _fill(img, y, y, xa - 1, xb + 1, color)
    for x in (xa, xb):
        _fill(img, ya, yb, x - 1, x + 1, color)
        _fill(img, ya - 1, yb + 1, x, x, color)


def draw_point(img, x, y, color=KPS_BGR) -> None:
    """cv2.circle(img, (x, y), 1, color, 2) for a centre in the image:
    the pixels within sqrt(5) of it. (For a centre off the image's left
    edge OpenCV leaves out a pixel or two of the part inside.)"""
    for dy, dx in _DOT:
        _fill(img, y + dy, y + dy, x + dx, x + dx, color)


def main(argv=None, *, device="cuda"):
    """Detect, print and draw, as JAX's CLI does; returns the result
    dict. ``device``: where the detector runs (the tests pass "cpu")."""
    args = parse_args(argv)
    cfg = get_config(args.config)
    cfg = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, score_thr=args.score_thresh,
        nms_iou_thr=args.nms_thresh))
    det = Detector(cfg, read_weights(cfg, args.checkpoint), device=device,
                   fused=args.fused)

    img = read_image(args.image)
    result = det.detect(img, mode=args.mode,
                        use_device_nms=args.device_nms)
    img = img.copy()
    boxes, kps = result["bboxes"], result["kps"]
    print(f"{boxes.shape[0]} faces")
    for i in range(boxes.shape[0]):
        x1, y1, x2, y2 = (int(v) for v in boxes[i, :4].astype(int))
        draw_box(img, x1, y1, x2, y2)
        if not args.no_kps:
            for k in range(kps.shape[1] // 2):
                px, py = kps[i, 2 * k:2 * k + 2].astype(int)
                draw_point(img, int(px), int(py))
        print(f"  [{x1} {y1} {x2} {y2}] score {boxes[i, 4]:.3f}")
    write_image(args.out, img)
    print("output:", args.out)
    return result


if __name__ == "__main__":
    main()
