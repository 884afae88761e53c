"""Measure host input-pipeline throughput (samples/s/core) in three
configurations: plain JPEG decode, reduced JPEG decode, decoded cache —
counterpart of ``tools/misc/bench_input_pipeline.py``, through the port's
``data/dataset.py`` and ``data/cache.py``.

With no real WIDER images in the environment this generates synthetic
JPEGs at WIDER-like resolutions. It writes and decodes JPEGs with OpenCV,
so it runs on a host that has OpenCV (the CPU host); it uses no device.

  python -m yunet_tpu_torch.tools.bench_input_pipeline --images 40 \\
      --rounds 120
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def make_dataset(root, n_images, rng):
    """Seeded synthetic JPEGs under root/images/0--Ev and their labelv2
    annotation (the bytes of JAX's tool); returns (ann, img_prefix)."""
    import cv2
    img_dir = os.path.join(root, "images", "0--Ev")
    os.makedirs(img_dir, exist_ok=True)
    lines = []
    for j in range(n_images):
        h = int(rng.choice([768, 900, 1024, 1152]))
        w = int(rng.choice([1024, 1200, 1400, 1600]))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(img_dir, f"img{j}.jpg"), img)
        faces = []
        for _ in range(rng.randint(1, 6)):
            x, y = rng.randint(0, w - 120), rng.randint(0, h - 120)
            bw = rng.randint(20, 100)
            kp = " ".join(f"{x + bw/2:.1f} {y + bw/2:.1f} 1.0"
                          for _ in range(5))
            faces.append(f"{x} {y} {x + bw} {y + bw} {kp}")  # xyxy
        lines.append(f"# 0--Ev/img{j}.jpg {w} {h}\n" + "\n".join(faces))
    ann = os.path.join(root, "labelv2.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    return ann, os.path.join(root, "images")


def bench(ds, n_samples, seed=0):
    rng_master = np.random.RandomState(seed)
    seeds = rng_master.randint(0, 2**31, n_samples)
    t0 = time.perf_counter()
    for i in range(n_samples):
        ds.get_train_sample(i % len(ds), np.random.RandomState(seeds[i]))
    return n_samples / (time.perf_counter() - t0)


def main(argv=None):
    """Returns {configuration: samples/s on one core}."""
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=40)
    p.add_argument("--rounds", type=int, default=120,
                   help="samples per configuration")
    p.add_argument("--root", default=None)
    args = p.parse_args(argv)

    import tempfile
    from ..data.cache import build_decoded_cache
    from ..data.dataset import SampleSpec, WiderFaceDataset

    root = args.root or tempfile.mkdtemp(prefix="input_bench_")
    rng = np.random.RandomState(0)
    ann, img_prefix = make_dataset(root, args.images, rng)
    spec = SampleSpec()
    results = {}

    ds = WiderFaceDataset(ann, img_prefix, spec)
    results["jpeg_full_decode"] = bench(ds, args.rounds)

    ds = WiderFaceDataset(ann, img_prefix, spec, reduced_decode=True)
    results["jpeg_reduced_decode"] = bench(ds, args.rounds)

    cache_dir = os.path.join(root, "decoded")
    t0 = time.perf_counter()
    build_decoded_cache(ann, img_prefix, cache_dir, verbose=False)
    build_s = time.perf_counter() - t0
    ds = WiderFaceDataset(ann, img_prefix, spec, decoded_cache=cache_dir)
    results["decoded_cache_mmap"] = bench(ds, args.rounds)

    print(f"one-time cache build: {args.images / build_s:.1f} img/s")
    for k, v in results.items():
        print(f"{k:22s} {v:8.1f} samples/s/core")
    return results


if __name__ == "__main__":
    main()
