"""Visualize post-pipeline training samples — counterpart of
``tools/misc/browse_dataset.py`` (reference tools/misc/browse_dataset.py
role), through ``train/hooks.py:AugDump``. It draws and writes JPEGs
with OpenCV, so it runs on a host that has OpenCV (the CPU host).

  python -m yunet_tpu_torch.tools.browse_dataset yunet_n \\
      --output-dir /tmp/aug -n 16
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import get_config
from ..data.dataset import SampleSpec, WiderFaceDataset
from ..train.hooks import AugDump


def main(argv=None):
    """Returns the number of samples written."""
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("--output-dir", default="./browse_out")
    p.add_argument("-n", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ann", default=None)
    p.add_argument("--img-prefix", default=None)
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    spec = SampleSpec(img_size=cfg.data.img_size, max_gts=cfg.data.max_gts,
                      crop_choice=cfg.data.crop_choice,
                      flip_ratio=cfg.data.flip_ratio)
    ds = WiderFaceDataset(args.ann or cfg.data.train_ann,
                          args.img_prefix or cfg.data.train_img_prefix,
                          spec)
    dump = AugDump(args.output_dir, max_images=args.n)
    rng = np.random.RandomState(args.seed)
    for _ in range(args.n):
        idx = rng.randint(len(ds))
        s = ds.get_train_sample(idx, rng)
        dump.update({k: v[None] for k, v in s.items()
                     if k != "num_overflow"})
    print(f"wrote {dump.n} samples to {args.output_dir}")
    return dump.n


if __name__ == "__main__":
    main()
