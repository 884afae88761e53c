"""Extended augmentation library — counterpart of
``yunet_tpu/data/aug_extra.py``, drawing the same random numbers
(available but not in the shipped recipe, matching the reference's
pipeline library surface, datasets/pipelines/transforms.py:1211+):

  photometric_distortion  — brightness/contrast/saturation/hue jitter
                            (reference PhotoMetricDistortion semantics:
                            random order of contrast, BGR<->HSV hops)
  expand                  — paste into a larger mean-filled canvas
  min_iou_random_crop     — IoU-constrained crop (keypoint-aware)
  mosaic4                 — 4-image mosaic with keypoint support
                            (the reference extended Mosaic for keypoints,
                            transforms.py:2279-2419)

All functions are host-side transforms over numpy arrays
(img f32 BGR, bboxes (n,4), kps (n,K,3)) and keep the framework's
fixed-shape batch contract downstream. OpenCV is not used: its colour
conversions and its perspective warp are torch ops on CPU tensors
(``ops/color.py``, byte-equal to OpenCV 5.0; ``ops/warp.py``, float32
images only), and its resize is ``ops/resize.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.color import bgr_to_hsv, hsv_to_bgr
from ..ops.resize import resize
from ..ops.warp import warp_perspective


def _u8_op(op, img: np.ndarray) -> np.ndarray:
    """A uint8 colour op of ops/color.py on a numpy image."""
    return op(torch.from_numpy(np.ascontiguousarray(img))).numpy()


def _resize(img: np.ndarray, dsize) -> np.ndarray:
    """OpenCV's INTER_LINEAR resize to dsize = (width, height) on a numpy
    image."""
    return resize(torch.from_numpy(np.ascontiguousarray(img)),
                  dsize).numpy()


def photometric_distortion(img: np.ndarray, rng: np.random.RandomState, *,
                           brightness_delta: float = 32,
                           contrast_range: Tuple[float, float] = (0.5, 1.5),
                           saturation_range: Tuple[float, float] = (0.5,
                                                                    1.5),
                           hue_delta: float = 18) -> np.ndarray:
    img = img.astype(np.float32).copy()
    if rng.randint(2):
        img += rng.uniform(-brightness_delta, brightness_delta)
    contrast_first = rng.randint(2)
    if contrast_first and rng.randint(2):
        img *= rng.uniform(*contrast_range)
    hsv = _u8_op(bgr_to_hsv, np.clip(img, 0, 255).astype(
        np.uint8)).astype(np.float32)
    if rng.randint(2):
        hsv[..., 1] *= rng.uniform(*saturation_range)
    if rng.randint(2):
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) \
            % 180
    img = _u8_op(hsv_to_bgr, np.clip(hsv, 0, 255).astype(
        np.uint8)).astype(np.float32)
    if not contrast_first and rng.randint(2):
        img *= rng.uniform(*contrast_range)
    return np.clip(img, 0, 255)


def expand(img: np.ndarray, bboxes: np.ndarray, kps: np.ndarray,
           rng: np.random.RandomState, *,
           mean: Sequence[float] = (0.0, 0.0, 0.0),
           ratio_range: Tuple[float, float] = (1.0, 4.0)):
    h, w = img.shape[:2]
    ratio = rng.uniform(*ratio_range)
    nh, nw = int(h * ratio), int(w * ratio)
    top = rng.randint(0, nh - h + 1)
    left = rng.randint(0, nw - w + 1)
    canvas = np.empty((nh, nw, 3), img.dtype)
    canvas[...] = np.asarray(mean, img.dtype)
    canvas[top:top + h, left:left + w] = img
    bboxes = bboxes + np.tile([left, top], 2).astype(np.float32)
    kps = kps.copy()
    if kps.size:
        kps[..., 0] += left
        kps[..., 1] += top
    return canvas, bboxes, kps


def min_iou_random_crop(img: np.ndarray, bboxes: np.ndarray,
                        kps: np.ndarray, labels: np.ndarray,
                        rng: np.random.RandomState, *,
                        min_ious: Sequence[float] = (0.1, 0.3, 0.5, 0.7,
                                                     0.9),
                        min_crop_size: float = 0.3, max_tries: int = 50):
    """IoU-constrained crop keeping center-inside boxes (keypoint-aware)."""
    h, w = img.shape[:2]
    choices = (1.0,) + tuple(min_ious)
    while True:
        min_iou = float(rng.choice(choices))
        if min_iou == 1.0:
            return img, bboxes, kps, labels
        for _ in range(max_tries):
            cw = rng.uniform(min_crop_size * w, w)
            ch = rng.uniform(min_crop_size * h, h)
            if ch / cw < 0.5 or ch / cw > 2:
                continue
            left = rng.uniform(0, w - cw)
            top = rng.uniform(0, h - ch)
            patch = np.asarray([left, top, left + cw, top + ch])
            if bboxes.shape[0]:
                lt = np.maximum(bboxes[:, :2], patch[:2])
                rb = np.minimum(bboxes[:, 2:], patch[2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                area = ((bboxes[:, 2] - bboxes[:, 0]) *
                        (bboxes[:, 3] - bboxes[:, 1]))
                iou = inter / np.maximum(area, 1e-9)
                if iou.min() < min_iou:
                    continue
                c = (bboxes[:, :2] + bboxes[:, 2:]) / 2
                mask = ((c[:, 0] > patch[0]) & (c[:, 1] > patch[1])
                        & (c[:, 0] < patch[2]) & (c[:, 1] < patch[3]))
                if not mask.any():
                    continue
            else:
                mask = np.zeros((0,), bool)
            patch_i = patch.astype(np.int64)
            new_img = img[patch_i[1]:patch_i[3], patch_i[0]:patch_i[2]]
            nb = bboxes[mask].copy()
            nk = kps[mask].copy()
            nl = labels[mask]
            if nb.size:
                nb[:, :2] = np.maximum(nb[:, :2], patch[:2])
                nb[:, 2:] = np.minimum(nb[:, 2:], patch[2:])
                nb -= np.tile(patch[:2], 2)
            if nk.size:
                nk[..., 0] = np.clip(nk[..., 0], patch[0],
                                     patch[2]) - patch[0]
                nk[..., 1] = np.clip(nk[..., 1], patch[1],
                                     patch[3]) - patch[1]
            return new_img, nb.astype(np.float32), nk, nl


def mosaic4(samples, rng: np.random.RandomState, *, out_size: int = 1280,
            center_ratio: Tuple[float, float] = (0.5, 1.5),
            pad_val: float = 114.0):
    """Stitch 4 (img, bboxes, kps) samples into one mosaic canvas with
    keypoint handling (kps visibility zeroed when clipped out)."""
    s = out_size // 2
    canvas = np.full((out_size, out_size, 3), pad_val, np.float32)
    cx = int(rng.uniform(*center_ratio) * s)
    cy = int(rng.uniform(*center_ratio) * s)
    all_b, all_k = [], []
    locs = ["tl", "tr", "bl", "br"]
    for loc, (img, bboxes, kps) in zip(locs, samples):
        h, w = img.shape[:2]
        scale = min(2 * s / max(h, w), 1.0) if max(h, w) > 2 * s else 1.0
        if scale != 1.0:
            img = _resize(img, (int(w * scale), int(h * scale)))
            h, w = img.shape[:2]
            bboxes = bboxes * scale
            kps = kps.copy()
            kps[..., :2] *= scale
        if loc == "tl":
            x1, y1 = max(cx - w, 0), max(cy - h, 0)
            x2, y2 = cx, cy
            sx, sy = w - (x2 - x1), h - (y2 - y1)
        elif loc == "tr":
            x1, y1 = cx, max(cy - h, 0)
            x2, y2 = min(cx + w, out_size), cy
            sx, sy = 0, h - (y2 - y1)
        elif loc == "bl":
            x1, y1 = max(cx - w, 0), cy
            x2, y2 = cx, min(cy + h, out_size)
            sx, sy = w - (x2 - x1), 0
        else:
            x1, y1 = cx, cy
            x2, y2 = min(cx + w, out_size), min(cy + h, out_size)
            sx, sy = 0, 0
        canvas[y1:y2, x1:x2] = img[sy:sy + (y2 - y1), sx:sx + (x2 - x1)]
        dx, dy = x1 - sx, y1 - sy
        if bboxes.shape[0]:
            b = bboxes + np.tile([dx, dy], 2).astype(np.float32)
            k = kps.copy()
            k[..., 0] += dx
            k[..., 1] += dy
            # keep boxes whose centers are on the canvas
            c = (b[:, :2] + b[:, 2:]) / 2
            mask = ((c[:, 0] > 0) & (c[:, 1] > 0)
                    & (c[:, 0] < out_size) & (c[:, 1] < out_size))
            b = np.clip(b[mask], 0, out_size)
            k = k[mask]
            if k.size:
                out = ((k[..., 0] < 0) | (k[..., 0] > out_size)
                       | (k[..., 1] < 0) | (k[..., 1] > out_size))
                k[..., 2] = np.where(out, 0.0, k[..., 2])
                k[..., 0] = np.clip(k[..., 0], 0, out_size)
                k[..., 1] = np.clip(k[..., 1], 0, out_size)
            all_b.append(b)
            all_k.append(k)
    bboxes = (np.concatenate(all_b) if all_b
              else np.zeros((0, 4), np.float32))
    kps = (np.concatenate(all_k) if all_k
           else np.zeros((0, 5, 3), np.float32))
    return canvas, bboxes, kps


def cutout(img: np.ndarray, rng: np.random.RandomState, *,
           n_holes=(1, 3), candidates=((0.05, 0.05), (0.1, 0.1)),
           with_ratio: bool = True, fill_in=(0, 0, 0)) -> np.ndarray:
    """CutOut (reference transforms.py:2144-2206): drop n random regions.

    candidates: list of (w, h) shapes in pixels (with_ratio=False) or
    fractions of the image size (with_ratio=True); hole top-left is sampled
    anywhere on the image and the extent clipped.
    """
    img = img.copy()
    h, w = img.shape[:2]
    lo, hi = (n_holes if isinstance(n_holes, (tuple, list))
              else (n_holes, n_holes))
    for _ in range(rng.randint(lo, hi + 1)):
        x1 = rng.randint(0, w)
        y1 = rng.randint(0, h)
        cw, ch = candidates[rng.randint(0, len(candidates))]
        if with_ratio:
            cw, ch = int(cw * w), int(ch * h)
        img[y1:min(y1 + int(ch), h), x1:min(x1 + int(cw), w)] = fill_in
    return img


def _affine_matrices(rng: np.random.RandomState, height: int, width: int, *,
                     max_rotate_degree: float, scaling_ratio_range,
                     max_shear_degree: float, max_translate_ratio: float):
    """translate @ shear @ rotate @ scale, the reference composition
    (transforms.py:2858-2883)."""
    ang = np.radians(rng.uniform(-max_rotate_degree, max_rotate_degree))
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    s = rng.uniform(*scaling_ratio_range)
    scale = np.diag([s, s, 1]).astype(np.float32)
    shx = np.tan(np.radians(rng.uniform(-max_shear_degree,
                                        max_shear_degree)))
    shy = np.tan(np.radians(rng.uniform(-max_shear_degree,
                                        max_shear_degree)))
    shear = np.array([[1, shx, 0], [shy, 1, 0], [0, 0, 1]], np.float32)
    tx = rng.uniform(-max_translate_ratio, max_translate_ratio) * width
    ty = rng.uniform(-max_translate_ratio, max_translate_ratio) * height
    trans = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float32)
    return trans @ shear @ rot @ scale, s


def warp_with_matrix(img: np.ndarray, bboxes: np.ndarray, kps: np.ndarray,
                     m: np.ndarray, *, border_val=(114, 114, 114)):
    """Apply a 3x3 homography to (img, boxes, kps): boxes are warped as
    4-corner hulls (min/max of warped corners), clipped, and kept when
    their center stays inside; keypoint visibility is zeroed for points
    warped outside. Shared by random_affine and the auto_augment
    geometric ops. img: float32 (``ops/warp.py``). Returns (img, bboxes,
    kps)."""
    h, w = img.shape[:2]
    out = warp_perspective(torch.from_numpy(np.ascontiguousarray(img)), m,
                           (w, h), border_value=border_val).numpy()
    if not bboxes.shape[0]:
        return out, bboxes, kps

    n = bboxes.shape[0]
    xs = bboxes[:, [0, 0, 2, 2]].reshape(-1)
    ys = bboxes[:, [1, 3, 3, 1]].reshape(-1)
    pts = np.vstack([xs, ys, np.ones_like(xs)])
    wp = m @ pts
    wp = wp[:2] / wp[2]
    wx = wp[0].reshape(n, 4)
    wy = wp[1].reshape(n, 4)
    wb = np.stack([wx.min(1), wy.min(1), wx.max(1), wy.max(1)], 1)
    wb[:, [0, 2]] = wb[:, [0, 2]].clip(0, w)
    wb[:, [1, 3]] = wb[:, [1, 3]].clip(0, h)
    # find_inside_bboxes: center within the canvas
    cx = (wb[:, 0] + wb[:, 2]) / 2
    cy = (wb[:, 1] + wb[:, 3]) / 2
    keep = (cx > 0) & (cy > 0) & (cx < w) & (cy < h) \
        & (wb[:, 2] > wb[:, 0]) & (wb[:, 3] > wb[:, 1])

    wk = kps.copy()
    if wk.size:
        kpts = np.concatenate(
            [wk[..., :2].reshape(-1, 2).T, np.ones((1, n * wk.shape[1]))])
        wpk = m @ kpts
        wpk = wpk[:2] / wpk[2]
        wk[..., 0] = wpk[0].reshape(n, -1)
        wk[..., 1] = wpk[1].reshape(n, -1)
        outside = ((wk[..., 0] < 0) | (wk[..., 0] > w)
                   | (wk[..., 1] < 0) | (wk[..., 1] > h))
        wk[..., 2] = np.where(outside, 0.0, wk[..., 2])
        wk[..., 0] = wk[..., 0].clip(0, w)
        wk[..., 1] = wk[..., 1].clip(0, h)
    return out, wb[keep].astype(np.float32), wk[keep].astype(np.float32)


def random_affine(img: np.ndarray, bboxes: np.ndarray, kps: np.ndarray,
                  rng: np.random.RandomState, *,
                  max_rotate_degree: float = 10.0,
                  max_translate_ratio: float = 0.1,
                  scaling_ratio_range=(0.5, 1.5),
                  max_shear_degree: float = 2.0,
                  border_val=(114, 114, 114)):
    """RandomAffine (reference transforms.py:2787-2949), keypoint-aware.
    Returns (img, bboxes, kps)."""
    h, w = img.shape[:2]
    m, _ = _affine_matrices(
        rng, h, w, max_rotate_degree=max_rotate_degree,
        scaling_ratio_range=scaling_ratio_range,
        max_shear_degree=max_shear_degree,
        max_translate_ratio=max_translate_ratio)
    return warp_with_matrix(img, bboxes, kps, m, border_val=border_val)


def mixup(img, bboxes, kps, mix_img, mix_bboxes, mix_kps,
          rng: np.random.RandomState, *, img_scale=(640, 640),
          ratio_range=(0.5, 1.5), flip_ratio: float = 0.5,
          pad_val: float = 114.0):
    """MixUp (reference transforms.py:2523-2755), keypoint-aware.

    The retrieved image is keep-ratio-resized onto an img_scale canvas,
    scale-jittered, maybe flipped, random-cropped to the target size, and
    blended 0.5/0.5; its boxes/kps get the same resize/flip/offset chain
    (flip also reorders landmarks like RandomFlip). Returns
    (img, bboxes, kps) with the retrieved annotations appended (boxes whose
    centers fall outside are dropped).
    """
    from .transforms import KPS_FLIP_ORDER

    if mix_bboxes.shape[0] == 0:
        return img, bboxes, kps

    jit = rng.uniform(*ratio_range)
    do_flip = rng.uniform(0, 1) > flip_ratio

    canvas = np.full((img_scale[0], img_scale[1], 3), pad_val, np.float32)
    r = min(img_scale[0] / mix_img.shape[0], img_scale[1] / mix_img.shape[1])
    resized = _resize(mix_img.astype(np.float32),
                      (int(mix_img.shape[1] * r), int(mix_img.shape[0] * r)))
    canvas[:resized.shape[0], :resized.shape[1]] = resized
    r *= jit
    canvas = _resize(canvas, (int(canvas.shape[1] * jit),
                              int(canvas.shape[0] * jit)))
    if do_flip:
        canvas = canvas[:, ::-1]

    oh, ow = canvas.shape[:2]
    th, tw = img.shape[:2]
    padded = np.zeros((max(oh, th), max(ow, tw), 3), np.float32)
    padded[:oh, :ow] = canvas
    yo = rng.randint(0, padded.shape[0] - th + 1) \
        if padded.shape[0] > th else 0
    xo = rng.randint(0, padded.shape[1] - tw + 1) \
        if padded.shape[1] > tw else 0
    crop = padded[yo:yo + th, xo:xo + tw]
    out = 0.5 * img.astype(np.float32) + 0.5 * crop

    b = mix_bboxes.astype(np.float32) * r
    k = mix_kps.astype(np.float32).copy()
    k[..., :2] *= r
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, ow)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, oh)
    if do_flip:
        b[:, [0, 2]] = ow - b[:, [2, 0]]
        k[..., 0] = ow - k[..., 0]
        k = k[:, KPS_FLIP_ORDER, :]
    b[:, [0, 2]] -= xo
    b[:, [1, 3]] -= yo
    k[..., 0] -= xo
    k[..., 1] -= yo
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, tw)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, th)
    outside = ((k[..., 0] < 0) | (k[..., 0] > tw)
               | (k[..., 1] < 0) | (k[..., 1] > th))
    k[..., 2] = np.where(outside, 0.0, k[..., 2])
    k[..., 0] = k[..., 0].clip(0, tw)
    k[..., 1] = k[..., 1].clip(0, th)
    cx = (b[:, 0] + b[:, 2]) / 2
    cy = (b[:, 1] + b[:, 3]) / 2
    keep = (cx > 0) & (cy > 0) & (cx < tw) & (cy < th) \
        & (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
    bboxes = np.concatenate([bboxes, b[keep]]).astype(np.float32)
    kps = np.concatenate([kps, k[keep]]).astype(np.float32)
    return out, bboxes, kps
