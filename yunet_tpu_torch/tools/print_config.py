"""Print the fully-resolved config — counterpart of
``tools/misc/print_config.py`` (reference tools/misc/print_config.py).

  python -m yunet_tpu_torch.tools.print_config yunet_n \\
      --cfg-options train.lr=0.02
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..config import apply_overrides, get_config


def main(argv=None):
    """Prints the config as JSON; returns it as a dict."""
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("--cfg-options", nargs="*", default=[])
    args = p.parse_args(argv)

    cfg = dataclasses.asdict(apply_overrides(get_config(args.config),
                                             args.cfg_options))
    print(json.dumps(cfg, indent=2, default=str))
    return cfg


if __name__ == "__main__":
    main()
