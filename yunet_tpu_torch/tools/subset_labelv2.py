"""Write a deterministic subset of a labelv2 annotation file — counterpart
of ``tools/misc/subset_labelv2.py``.

Used to size a training split to the image-bank budget of one card
(``data/device_aug.py`` capacity guard): keep every Nth image record,
interleaved, which preserves the size and difficulty distribution.

labelv2 format (reference mmdet/datasets/retinaface.py:29-100):
  # <path> <W> <H>
  <face line>*

  python -m yunet_tpu_torch.tools.subset_labelv2 labelv2.txt \\
      --out half.txt --every 2
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("--out", required=True)
    ap.add_argument("--every", type=int, default=2,
                    help="keep every Nth image record (default 2)")
    ap.add_argument("--offset", type=int, default=0)
    args = ap.parse_args(argv)

    records = []   # list of [header, face lines...]
    with open(args.src) as f:
        for ln in f:
            if ln.startswith("#"):
                records.append([ln])
            elif records:
                records[-1].append(ln)
    kept = records[args.offset::args.every]
    with open(args.out, "w") as f:
        for rec in kept:
            f.writelines(rec)
    print(f"kept {len(kept)} of {len(records)} image records -> {args.out}")


if __name__ == "__main__":
    main()
