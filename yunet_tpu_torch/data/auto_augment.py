"""AutoAugment policy library — counterpart of
``yunet_tpu/data/auto_augment.py``, drawing the same random numbers
(reference mmdet/datasets/pipelines/auto_augment.py), keypoint-aware and
functional.

The reference implements the detection AutoAugment search space of
"Learning Data Augmentation Strategies for Object Detection"
(arxiv 1906.11172): a list of policies, each a sequence of transforms;
one policy is drawn per sample. Geometric ops (Shear/Rotate/Translate,
auto_augment.py:113-712) move boxes with the image; photometric ops
(Color/Equalize/Brightness/Contrast, :713-900) leave annotations alone.

This module keeps the same level->magnitude maps (level_to_value with
_MAX_LEVEL=10, enhance_level_to_value a*level/10+b) and per-op prob /
random-negative semantics, expressed as pure functions over
(img, bboxes (n,4), kps (n,K,3), rng). Geometric ops additionally carry
the keypoints through the shared homography machinery
(aug_extra.warp_with_matrix) — the reference has no keypoints in these
ops, so kp handling follows the framework's RandomAffine convention
(visibility zeroed when warped outside).

OpenCV is not used: the rotation matrix is closed-form float64, the grey
image is ``ops/color.py:bgr_to_gray`` (byte-equal to OpenCV 5.0) repeated
over three channels, and the warps are ``ops/warp.py`` (float32 images).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from ..ops.color import bgr_to_gray
from .aug_extra import warp_with_matrix

_MAX_LEVEL = 10


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """OpenCV's getRotationMatrix2D: the (2, 3) float64 affine matrix of a
    rotation by ``angle`` degrees (counter-clockwise positive) about
    ``center`` (x, y, taken as float32 as OpenCV's Point2f), scaled."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def _gray(img: np.ndarray) -> np.ndarray:
    """The uint8 grey image of np.clip(img, 0, 255) as uint8 BGR."""
    u8 = np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8))
    return bgr_to_gray(torch.from_numpy(u8)).numpy()


def level_to_value(level: float, max_value: float) -> float:
    return (level / _MAX_LEVEL) * max_value


def enhance_level_to_value(level: float, a: float = 1.8,
                           b: float = 0.1) -> float:
    return (level / _MAX_LEVEL) * a + b


def _maybe_negative(value: float, rng, prob: float) -> float:
    return -value if rng.rand() < prob else value


# ---- geometric --------------------------------------------------------


def shear(img, bboxes, kps, rng, *, level: float, prob: float = 0.5,
          direction: str = "horizontal", max_shear_magnitude: float = 0.3,
          random_negative_prob: float = 0.5, img_fill_val: float = 128):
    """Shear along one axis (reference Shear, auto_augment.py:113-330)."""
    if rng.rand() > prob:
        return img, bboxes, kps
    mag = _maybe_negative(level_to_value(level, max_shear_magnitude),
                          rng, random_negative_prob)
    if direction == "horizontal":
        m = np.array([[1, mag, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    else:
        m = np.array([[1, 0, 0], [mag, 1, 0], [0, 0, 1]], np.float32)
    return warp_with_matrix(img, bboxes, kps, m,
                            border_val=(img_fill_val,) * 3)


def rotate(img, bboxes, kps, rng, *, level: float, prob: float = 0.5,
           max_rotate_angle: float = 30.0, scale: float = 1.0,
           center=None, random_negative_prob: float = 0.5,
           img_fill_val: float = 128):
    """Rotate about the image center (reference Rotate,
    auto_augment.py:331-545; positive angle = clockwise, mmcv.imrotate
    convention)."""
    if rng.rand() > prob:
        return img, bboxes, kps
    angle = _maybe_negative(level_to_value(level, max_rotate_angle),
                            rng, random_negative_prob)
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    m2 = rotation_matrix_2d(center, -angle, scale)  # cw-positive
    m = np.concatenate([m2, [[0, 0, 1]]]).astype(np.float32)
    return warp_with_matrix(img, bboxes, kps, m,
                            border_val=(img_fill_val,) * 3)


def translate(img, bboxes, kps, rng, *, level: float, prob: float = 0.5,
              direction: str = "horizontal",
              max_translate_offset: float = 250.0,
              random_negative_prob: float = 0.5,
              img_fill_val: float = 128):
    """Translate along one axis (reference Translate,
    auto_augment.py:546-712; offset in pixels, int-truncated)."""
    if rng.rand() > prob:
        return img, bboxes, kps
    off = int(_maybe_negative(
        level_to_value(level, max_translate_offset), rng,
        random_negative_prob))
    dx, dy = (off, 0) if direction == "horizontal" else (0, off)
    m = np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float32)
    return warp_with_matrix(img, bboxes, kps, m,
                            border_val=(img_fill_val,) * 3)


# ---- photometric (annotations untouched) ------------------------------


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = b.astype(np.float32) + factor * (
        a.astype(np.float32) - b.astype(np.float32))
    return np.clip(out, 0, 255)


def adjust_color(img, rng, *, level: float, prob: float = 0.5):
    """Blend with the grayscale image (mmcv.adjust_color semantics)."""
    if rng.rand() > prob:
        return img
    factor = enhance_level_to_value(level)
    gray3 = np.repeat(_gray(img)[..., None], 3, axis=-1)
    return _blend(img, gray3, factor).astype(img.dtype)


def adjust_brightness(img, rng, *, level: float, prob: float = 0.5):
    """Blend with black (mmcv.adjust_brightness semantics)."""
    if rng.rand() > prob:
        return img
    factor = enhance_level_to_value(level)
    return _blend(img, np.zeros_like(img), factor).astype(img.dtype)


def adjust_contrast(img, rng, *, level: float, prob: float = 0.5):
    """Blend with the mean-gray image (mmcv.adjust_contrast)."""
    if rng.rand() > prob:
        return img
    factor = enhance_level_to_value(level)
    gray = _gray(img)
    mean = np.full_like(img, round(float(gray.mean())), dtype=img.dtype)
    return _blend(img, mean, factor).astype(img.dtype)


def equalize(img, rng, *, prob: float = 0.5):
    """Per-channel histogram equalization (mmcv.imequalize / PIL
    ImageOps.equalize semantics: scale by (cum_hist + step//2) / step)."""
    if rng.rand() > prob:
        return img
    u8 = np.clip(img, 0, 255).astype(np.uint8)
    out = np.empty_like(u8)
    for c in range(u8.shape[-1]):
        ch = u8[..., c]
        histo = np.bincount(ch.ravel(), minlength=256)
        nonzero = histo[histo > 0]
        step = (int(histo.sum()) - int(nonzero[-1])) // 255 \
            if nonzero.size else 0
        if step == 0:
            out[..., c] = ch
            continue
        lut = (np.concatenate([[0], np.cumsum(histo)[:-1]])
               + step // 2) // step
        out[..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out.astype(img.dtype)


# ---- policies ----------------------------------------------------------

_GEOMETRIC = {"Shear": shear, "Rotate": rotate, "Translate": translate}
_PHOTOMETRIC = {"Color": adjust_color, "Brightness": adjust_brightness,
                "Contrast": adjust_contrast, "Equalize": equalize}


def apply_policy(img, bboxes, kps, rng,
                 policy: Sequence[dict]):
    """Apply one policy (a sequence of transform dicts with a 'type' key,
    same schema as the reference AutoAugment policies)."""
    for aug in policy:
        kw = {k: v for k, v in aug.items() if k != "type"}
        t = aug["type"]
        if t in _GEOMETRIC:
            img, bboxes, kps = _GEOMETRIC[t](img, bboxes, kps, rng, **kw)
        elif t in _PHOTOMETRIC:
            img = _PHOTOMETRIC[t](img, rng, **kw)
        else:
            raise KeyError(f"unknown auto_augment transform '{t}'")
    return img, bboxes, kps


def auto_augment(img, bboxes, kps, rng,
                 policies: List[Sequence[dict]]):
    """Draw one policy uniformly and apply it (reference AutoAugment,
    auto_augment.py:47-109)."""
    assert policies, "policies must be non-empty"
    policy = policies[rng.randint(0, len(policies))]
    return apply_policy(img, bboxes, kps, rng, policy)


def default_policies() -> List[List[dict]]:
    """The v0 detection policy subset expressible with this op set
    (1906.11172 Table 1 flavor)."""
    return [
        [dict(type="Translate", level=6, prob=0.6),
         dict(type="Equalize", prob=0.8)],
        [dict(type="Shear", level=4, prob=0.4, direction="vertical"),
         dict(type="Brightness", level=6, prob=0.6)],
        [dict(type="Rotate", level=6, prob=0.6),
         dict(type="Color", level=6, prob=1.0)],
        [dict(type="Contrast", level=4, prob=0.6),
         dict(type="Translate", level=4, prob=0.4,
              direction="vertical")],
    ]
