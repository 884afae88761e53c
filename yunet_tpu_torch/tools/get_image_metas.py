"""Collect per-image metadata (filename, width, height, face count) to a
pickle — counterpart of ``tools/misc/get_image_metas.py`` (reference
tools/misc/get_image_metas.py role: offline meta collection so eval
tooling can bucket by size without reading images).

  python -m yunet_tpu_torch.tools.get_image_metas yunet_n --split val \\
      --out metas.pkl
"""

from __future__ import annotations

import argparse
import pickle

from ..config import get_config
from ..data import parse_labelv2


def main(argv=None):
    """Writes the metas; returns them."""
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("--split", default="val", choices=["train", "val"])
    p.add_argument("--out", default="image_metas.pkl")
    p.add_argument("--ann", default=None)
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    ann = args.ann or (cfg.data.train_ann if args.split == "train"
                       else cfg.data.val_ann)
    records = parse_labelv2(ann, test_mode=args.split == "val")
    metas = [{"filename": r.filename, "width": r.width,
              "height": r.height, "num_faces": int(r.bboxes.shape[0]),
              "num_ignore": int(r.bboxes_ignore.shape[0]),
              "pad_shape_32": (-(-r.height // 32) * 32,
                               -(-r.width // 32) * 32)}
             for r in records]
    with open(args.out, "wb") as f:
        pickle.dump(metas, f)
    sizes = {m["pad_shape_32"] for m in metas}
    print(f"wrote {len(metas)} metas to {args.out}; "
          f"{len(sizes)} distinct /32-padded shapes")
    return metas


if __name__ == "__main__":
    main()
