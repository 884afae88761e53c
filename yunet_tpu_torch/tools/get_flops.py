"""Model complexity report — counterpart of ``tools/get_flops.py``
(reference tools/get_flops.py parity).

  python -m yunet_tpu_torch.tools.get_flops yunet_n --shape 320 320
"""

from __future__ import annotations

import argparse

from ..config import get_config
from ..utils.flops import count_macs, count_params


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config",
                   help="yunet_n | yunet_s | scrfd_10g_bnkps | retinaface_r50")
    p.add_argument("--shape", type=int, nargs="+", default=[320, 320])
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    shape = (args.shape[0], args.shape[-1])
    macs = count_macs(cfg.model, shape)
    line = "=" * 30
    print(f"{line}\nInput shape: (3, {shape[0]}, {shape[1]})\n"
          f"Flops: {macs / 1e6:.2f} MFLOPs\n"
          f"Params: {count_params(cfg.model):,}\n{line}")


if __name__ == "__main__":
    main()
