"""One-time decoded-image cache builder (see ``data/cache.py``) —
counterpart of ``tools/misc/build_decoded_cache.py``. It decodes JPEGs
with OpenCV, so it runs on a host that has OpenCV (the CPU host); the
cache it writes is read with numpy alone, on any host.

  python -m yunet_tpu_torch.tools.build_decoded_cache yunet_n \\
      --cache-dir data/decoded
  python -m yunet_tpu_torch.tools.train yunet_n --cfg-options \\
      data.decoded_cache=\\"data/decoded\\"
"""

from __future__ import annotations

import argparse
import os

from ..config import get_config
from ..data.cache import build_decoded_cache


def main(argv=None):
    """Returns the number of images decoded."""
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--ann", default=None)
    p.add_argument("--img-prefix", default=None)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    n = build_decoded_cache(
        args.ann or cfg.data.train_ann,
        args.img_prefix or cfg.data.train_img_prefix,
        args.cache_dir, workers=args.workers)
    print(f"decoded {n} new images into {args.cache_dir}")
    return n


if __name__ == "__main__":
    main()
