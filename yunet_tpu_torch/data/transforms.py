"""Host-side augmentation pipeline — a copy of
``yunet_tpu/data/transforms.py`` (numpy), with ``cv2.resize`` replaced by
``ops/resize.py:resize`` (the same bytes for uint8, no OpenCV).

The signature augmentation is RandomSquareCrop (reference
datasets/pipelines/transforms.py:975-1169, SCRFD-style): pick a square side
= scale * short_side with scale drawn from ``crop_choice``; the crop window
may extend beyond the image (the canvas is gray-128 padded); retry up to
250 placements until at least one GT center falls strictly inside; keep
only boxes whose centers are inside, clip them to the window and translate.
If a scale round fails and max(choice) <= 1, the next round multiplies the
scale by 1.2 (transforms.py:1047-1053).

Horizontal flip swaps the landmark order [1, 0, 2, 4, 3] (eyes and mouth
corners) before mirroring x (transforms.py:473-486). Flip maps x -> w - x
(no -1), bboxes map x1' = w - x2.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize

KPS_FLIP_ORDER = (1, 0, 2, 4, 3)
PAD_VALUE = 128


def _centers_in_patch(boxes: np.ndarray, patch: np.ndarray) -> np.ndarray:
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    return ((c[:, 0] > patch[0]) & (c[:, 1] > patch[1])
            & (c[:, 0] < patch[2]) & (c[:, 1] < patch[3]))


def random_square_crop(img: np.ndarray, bboxes: np.ndarray,
                       kps: np.ndarray, bboxes_ignore: np.ndarray,
                       crop_choice: Sequence[float],
                       rng: np.random.RandomState, *,
                       scale: float = None):
    """Returns (img, bboxes, kps, bboxes_ignore) for the cropped patch.

    ``scale`` lets the caller pre-draw the first scale from the same rng
    (rng.choice(crop_choice)) — used by the reduced-JPEG-decode path,
    which needs the scale before the image is loaded. The random stream
    is identical either way.
    """
    h, w = img.shape[:2]
    short_side = min(w, h)
    max_scale = max(crop_choice)
    if scale is None:
        scale = float(rng.choice(crop_choice))
    first = True
    while True:
        if not first and max_scale <= 1.0:
            scale = scale * 1.2
        elif not first:
            scale = float(rng.choice(crop_choice))
        first = False
        for _ in range(250):
            cw = int(scale * short_side)
            ch = cw
            left = 0 if w == cw else (
                rng.randint(0, w - cw + 1) if w > cw
                else rng.randint(w - cw, 1))
            top = 0 if h == ch else (
                rng.randint(0, h - ch + 1) if h > ch
                else rng.randint(h - ch, 1))
            patch = np.asarray(
                [int(left), int(top), int(left + cw), int(top + ch)],
                np.int64)
            mask = _centers_in_patch(bboxes, patch)
            if not mask.any():
                continue
            new_boxes = bboxes[mask].copy()
            new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:],
                                          patch[2:].astype(np.float32))
            new_boxes[:, :2] = np.maximum(new_boxes[:, :2],
                                          patch[:2].astype(np.float32))
            new_boxes -= np.tile(patch[:2], 2).astype(np.float32)
            new_kps = kps[mask].copy()
            new_kps[:, :, 0] = np.clip(new_kps[:, :, 0], patch[0], patch[2])
            new_kps[:, :, 1] = np.clip(new_kps[:, :, 1], patch[1], patch[3])
            new_kps[:, :, 0] -= patch[0]
            new_kps[:, :, 1] -= patch[1]
            if bboxes_ignore.shape[0]:
                imask = _centers_in_patch(bboxes_ignore, patch)
                new_ign = bboxes_ignore[imask].copy()
                new_ign[:, 2:] = np.minimum(new_ign[:, 2:],
                                            patch[2:].astype(np.float32))
                new_ign[:, :2] = np.maximum(new_ign[:, :2],
                                            patch[:2].astype(np.float32))
                new_ign -= np.tile(patch[:2], 2).astype(np.float32)
            else:
                new_ign = bboxes_ignore

            canvas = np.full((ch, cw, 3), PAD_VALUE, img.dtype)
            src = patch.copy()
            src[0] = max(0, src[0])
            src[1] = max(0, src[1])
            src[2] = min(w, src[2])
            src[3] = min(h, src[3])
            dst_x = max(0, -patch[0])
            dst_y = max(0, -patch[1])
            canvas[dst_y:dst_y + (src[3] - src[1]),
                   dst_x:dst_x + (src[2] - src[0])] = \
                img[src[1]:src[3], src[0]:src[2]]
            return canvas, new_boxes, new_kps, new_ign


def resize_with_targets(img: np.ndarray, bboxes: np.ndarray,
                        kps: np.ndarray, bboxes_ignore: np.ndarray,
                        out_size: Tuple[int, int]):
    """Resize (keep_ratio=False) to (out_w, out_h) scaling targets
    (reference Resize + _resize_keypoints, transforms.py:284-293). The
    image goes through the torch resize on the CPU, which gives
    cv2.resize's bytes for uint8."""
    h, w = img.shape[:2]
    out_w, out_h = out_size
    # np.require copies only an array torch.from_numpy cannot take
    # (read-only or not C-contiguous); resize never writes its input
    img = resize(torch.from_numpy(np.require(img, requirements=["C", "W"])),
                 (out_w, out_h)).numpy()
    sx, sy = out_w / w, out_h / h
    scale4 = np.asarray([sx, sy, sx, sy], np.float32)
    bboxes = bboxes * scale4
    bboxes_ignore = bboxes_ignore * scale4 if bboxes_ignore.size \
        else bboxes_ignore
    kps = kps.copy()
    kps[:, :, 0] *= sx
    kps[:, :, 1] *= sy
    return img, bboxes, kps, bboxes_ignore


def horizontal_flip(img: np.ndarray, bboxes: np.ndarray, kps: np.ndarray,
                    bboxes_ignore: np.ndarray):
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img[:, ::-1])

    def flip_boxes(b):
        if not b.size:
            return b
        out = b.copy()
        out[:, 0] = w - b[:, 2]
        out[:, 2] = w - b[:, 0]
        return out

    new_kps = kps[:, KPS_FLIP_ORDER, :].copy() if kps.size else kps
    if new_kps.size:
        new_kps[:, :, 0] = w - new_kps[:, :, 0]
    return img, flip_boxes(bboxes), new_kps, flip_boxes(bboxes_ignore)
