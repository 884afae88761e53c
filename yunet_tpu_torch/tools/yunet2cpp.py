"""Generate facedetectcnn-data.cpp for libfacedetection — counterpart of
``tools/yunet2cpp.py`` (reference tools/yunet2cpp.py parity: conv-BN
folding, depthwise (9, C) layout, stem 3x3x3 repack + zero-pad to 32
channels). The file equals the JAX package's from the same weights.

  python -m yunet_tpu_torch.tools.yunet2cpp yunet_n weights.pth \\
      --output-file work_dirs/facedetectcnn-data.cpp
"""

from __future__ import annotations

import argparse
import os

from ..config import get_config
from ..export import generate_cpp
from ..utils.flops import count_macs, count_params
from .yunet2onnx import load_model


def main(argv=None):
    """Host-side tool: the weights load on the CPU. Returns the path."""
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("checkpoint")
    p.add_argument("--output-file",
                   default="./work_dirs/facedetectcnn-data.cpp")
    p.add_argument("--no-summary", action="store_true")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    model = load_model(cfg, args.checkpoint)

    if not args.no_summary:
        line = "=" * 30
        print(f"{line}\nInput shape: (3, 320, 320)\n"
              f"Flops: {count_macs(cfg.model) / 1e6:.2f} MFLOPs\n"
              f"Params: {count_params(cfg.model):,}\n{line}")

    src = generate_cpp(model, cfg.model)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_file)),
                exist_ok=True)
    with open(args.output_file, "w") as f:
        f.write(src)
    print("Convert successful!")
    print(f"From {args.config} with {args.checkpoint}\n"
          f"To {args.output_file}")
    return args.output_file


if __name__ == "__main__":
    main()
