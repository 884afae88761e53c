"""Decoded-image cache: one-time JPEG decode to mmap-able raw arrays — a
copy of ``yunet_tpu/data/cache.py``. Reading (``load_cached``) is numpy
only; decoding imports cv2 inside the functions that decode, so a host
without OpenCV reads a cache built elsewhere.

JPEG decode dominates the host aug pipeline (~5-10 img/s/core measured in
round 1 — a v5e-8 host cannot feed ~4,400 img/s of device demand from
JPEGs). The cache trades disk for decode: each image is decoded once into
a raw BGR uint8 ``.npy`` alongside ``cache_dir``, and training loads it
with ``np.load(mmap_mode='r')`` — RandomSquareCrop then only touches the
pages its crop actually reads, so the per-sample cost collapses to a few
page faults + the crop copy. Fills the perf role of the reference's
torch DataLoader worker pool scaling (datasets/builder.py:94-206) on
hosts where decode, not augmentation, is the wall.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def cache_path(cache_dir: str, filename: str) -> str:
    return os.path.join(cache_dir, filename + ".npy")


def build_decoded_cache(ann_file: str, img_prefix: str, cache_dir: str, *,
                        workers: int = 0, verbose: bool = True) -> int:
    """Decode every image in the labelv2 annotation set into cache_dir.

    Idempotent: existing entries are kept. Returns the number of images
    decoded this call.
    """
    from .labelv2 import parse_labelv2

    records = parse_labelv2(ann_file, test_mode=True)
    todo = [r.filename for r in records
            if not os.path.exists(cache_path(cache_dir, r.filename))]
    if not todo:
        return 0

    args = [(img_prefix, cache_dir, f) for f in todo]
    if workers > 1:
        import multiprocessing as mp
        with mp.get_context("fork").Pool(workers) as pool:
            for i, _ in enumerate(pool.imap_unordered(_decode_one, args,
                                                      chunksize=16)):
                if verbose and (i + 1) % 500 == 0:
                    print(f"decoded {i + 1}/{len(todo)}")
    else:
        for i, a in enumerate(args):
            _decode_one(a)
            if verbose and (i + 1) % 500 == 0:
                print(f"decoded {i + 1}/{len(todo)}")
    return len(todo)


def _decode_one(args) -> None:
    import cv2

    img_prefix, cache_dir, filename = args
    out = cache_path(cache_dir, filename)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    img = cv2.imread(os.path.join(img_prefix, filename), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(os.path.join(img_prefix, filename))
    tmp = out + ".tmp.npy"
    np.save(tmp, np.ascontiguousarray(img))
    os.replace(tmp, out)


def load_cached(cache_dir: str, filename: str) -> Optional[np.ndarray]:
    """mmap the cached raw image; None if not cached."""
    p = cache_path(cache_dir, filename)
    if not os.path.exists(p):
        return None
    return np.load(p, mmap_mode="r")


# libjpeg's scaled decode supports 1/2, 1/4, 1/8
_REDUCED_FLAGS = {}


def reduced_imread(path: str, reduction: int) -> Optional[np.ndarray]:
    """cv2.imread at 1/reduction resolution (reduction in {2,4,8})."""
    import cv2

    if not _REDUCED_FLAGS:
        _REDUCED_FLAGS.update({
            2: cv2.IMREAD_REDUCED_COLOR_2,
            4: cv2.IMREAD_REDUCED_COLOR_4,
            8: cv2.IMREAD_REDUCED_COLOR_8})
    return cv2.imread(path, _REDUCED_FLAGS[reduction])


def pick_reduction(short_side: int, scale: float, out_size: int) -> int:
    """Largest decode reduction in {1,2,4,8} that keeps the crop at or
    above the output resolution: the crop is scale*short_side pixels and
    lands on out_size, so decoding at 1/r is lossless-in-effect while
    scale*short_side/r >= out_size."""
    r = 1
    while r < 8 and scale * short_side / (r * 2) >= out_size:
        r *= 2
    return r
