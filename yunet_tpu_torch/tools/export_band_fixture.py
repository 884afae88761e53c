"""Export the hard-tier band-gate fixture — counterpart of
``tools/misc/export_band_fixture.py``, reading a port checkpoint and
writing JAX's file layout.

Loads a training checkpoint (``ckpt_*``, train/checkpoint.py; the EMA
shadow when it carries one), runs the mode-0 (640x640 letterbox) and the
mode-2 (origin-size) WIDER protocols over the val split through
``make_wider_eval_hook`` to record the APs, and writes one npz: the
parameter and BN-state leaves as ``p{i}`` / ``s{i}`` in jax.tree_util
flatten order (``utils/jax_params.py`` knows it) and a JSON ``meta``
record with JAX's keys, so ``tests/test_hard_band.py`` and
``utils/jax_params.py:load_flat_npz`` both read the file.

  python -m yunet_tpu_torch.tools.export_band_fixture \\
      --ckpt work_dirs/rehearsal/ckpt_00002400 \\
      --data data/synth_wider_hard --out work_dirs/band.npz \\
      --cache-dir data/synth_wider_hard/val_cache --device-nms

Without --cache-dir the val images are decoded from the JPEGs with
OpenCV; the card host has none, so it reads the decoded .npy cache.
"""

from __future__ import annotations

import argparse
import json
import os
import types

import numpy as np


def ema_checkpoint_state(cfg, ckpt):
    """(state dict with the EMA shadow in place of each parameter when the
    checkpoint carries one, step, whether it did) of a port checkpoint;
    the BN running statistics stay the model's, as in the eval hook."""
    from ..models.detector import YuNet
    from ..train.checkpoint import read_state

    state = read_state(ckpt)
    sd = dict(state["model"])
    if state["ema"] is not None:
        names = [n for n, _ in YuNet(cfg.model, device="cpu")
                 .named_parameters()]
        if len(names) != len(state["ema"]):
            raise ValueError(f"{ckpt}: {len(state['ema'])} EMA tensors for "
                             f"{len(names)} parameters")
        sd.update(zip(names, state["ema"]))
    return sd, int(state["step"]), state["ema"] is not None


def write_fixture(path, params, state, meta):
    """The flat leaves in jax.tree_util order and the JSON meta record,
    compressed; returns (n_params, n_state)."""
    from ..utils.jax_params import _leaves

    pleaves = [leaf for _, leaf in _leaves(params)]
    sleaves = [leaf for _, leaf in _leaves(state)]
    blob = {f"p{i}": np.asarray(leaf, np.float32)
            for i, leaf in enumerate(pleaves)}
    blob.update({f"s{i}": np.asarray(leaf, np.float32)
                 for i, leaf in enumerate(sleaves)})
    blob["meta"] = json.dumps({**meta, "n_params": len(pleaves),
                               "n_state": len(sleaves)})
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **blob)
    return len(pleaves), len(sleaves)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export the band-gate fixture "
                                "(flat leaves + recorded APs)")
    p.add_argument("--ckpt", default="work_dirs/rehearsal_r04/ckpt_00002400")
    p.add_argument("--data", default="data/synth_wider_hard")
    p.add_argument("--config", default="yunet_n")
    p.add_argument("--out", default="tests/fixtures/r04_ema.npz")
    p.add_argument("--tier", default="hard",
                   help="generator tier the val split was built with "
                   "(embedded in meta so the band gate regenerates the SAME "
                   "split)")
    p.add_argument("--cache-dir", default=None,
                   help="read val images from this decoded .npy cache "
                   "(data/cache.py layout) instead of decoding the JPEGs")
    p.add_argument("--device-nms", action="store_true",
                   help="the sweeps' NMS on the device (packed top-k rows)")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """Write the fixture; returns its meta record. ``device``: where the
    eval sweeps run (the tests pass the CPU)."""
    args = parse_args(argv)
    from ..config import get_config
    from ..eval.eval_hook import make_wider_eval_hook
    from ..models.detector import YuNet
    from ..utils.jax_params import jax_from_state_dict

    cfg = get_config(args.config)
    val = os.path.join(args.data, "val")
    ann = os.path.join(val, "labelv2.txt")
    sd, step, had_ema = ema_checkpoint_state(cfg, os.path.abspath(args.ckpt))
    print(f"checkpoint {args.ckpt} (step {step}, "
          f"{'EMA' if had_ema else 'raw'} params)")

    model = YuNet(cfg.model, device="cpu")
    model.load_state_dict(sd)
    fake_ts = types.SimpleNamespace(model=model, ema=None)
    aps = {}
    for key, mode in (("mode0_aps", (640, 640)), ("mode2_aps", "ORIGIN")):
        hook = make_wider_eval_hook(
            cfg, device=device, mode=mode, ann=ann,
            img_prefix=os.path.join(val, "images"),
            gt_dir=os.path.join(val, "gt"), use_ema=False,
            use_device_nms=args.device_nms, cache_dir=args.cache_dir)
        aps[key] = hook(fake_ts, step=step)
    print(f"mode-0 APs on {val}: {aps['mode0_aps']}")
    print(f"mode-2 (origin-size) APs on {val}: {aps['mode2_aps']}")

    params, state = jax_from_state_dict(sd, cfg.model)
    # the generator geometry, so the band gate regenerates the SAME val
    # split the APs were recorded on: the '# path' image header lines
    with open(ann) as f:
        val_n = sum(1 for ln in f if ln.startswith("#"))
    meta = {"step": step, "ckpt": args.ckpt, "data": args.data,
            "val_n": val_n, "tier": args.tier, **aps}
    n_params, n_state = write_fixture(args.out, params, state, meta)
    print(f"wrote {args.out} "
          f"({os.path.getsize(args.out) / 1024:.0f} KiB)")
    return {**meta, "n_params": n_params, "n_state": n_state}


if __name__ == "__main__":
    main()
