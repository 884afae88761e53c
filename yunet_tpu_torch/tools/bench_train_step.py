"""Interleaved A/B benchmark of the train step — counterpart of
``tools/misc/bench_train_step.py``.

Walls drift between calls and between hosts, so sequential benchmarks of
two variants are not comparable. This harness builds every requested
variant up front (one step each to warm up) and then interleaves
measurement windows (A, B, A, B, ...), reporting per-variant medians:
both variants see the same drift. Each window ends in a host readback of
the loss.

Variants are orthogonal flags (pass a comma list to A/B):
  --dtype f32|uint8          host batch image dtype (uint8 casts on the
                             device)
  --simota folded|xla        SimOTA: folded runs the streamed kernel;
                             xla the dense plain assignment
                             (train.pallas_simota=False)
  --bn-bias skip|keep        skip = BN-covered conv biases detached
                             (production), keep = plain autograd
  --bn-group N,...           GhostBN group sizes (train.bn_group)

JAX's flags without a counterpart, left out because each would time one
program under two names: --pool (three XLA lowerings of the port's one
max-pool), --remat (no port module honours model.remat_stages), --convdp
(no port module reads model.composed_dp: the trunk computes the factored
pw -> dw either way) and --simota v1 (the streamed kernel stands for both
of JAX's Pallas SimOTA kernels, so v1 is folded's program).

  python -m yunet_tpu_torch.tools.bench_train_step --batch 16 \\
      --simota folded,xla --windows 5
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import statistics
import sys
import time

import numpy as np
import torch


def make_batch(rng, tb, img, g, dtype, *, device="cpu"):
    """A seeded train batch in the JAX layout, drawn as JAX's make_batch
    draws it, as tensors on ``device``."""
    c = rng.uniform(40, img - 40, (tb, g, 2)).astype(np.float32)
    wh = rng.uniform(8, img // 5, (tb, g, 2)).astype(np.float32)
    kps = np.concatenate(
        [rng.uniform(20, img - 20, (tb, g, 5, 2)).astype(np.float32),
         np.ones((tb, g, 5, 1), np.float32)], -1)
    batch = {
        "image": rng.randint(0, 256, (tb, img, img, 3)).astype(dtype),
        "gt_bboxes": np.concatenate([c - wh / 2, c + wh / 2], -1),
        "gt_labels": np.zeros((tb, g), np.int32),
        "gt_kps": kps,
        "gt_valid": np.tile(np.arange(g) < 12, (tb, 1)),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@contextlib.contextmanager
def bn_bias(mode: str):
    """``keep``: BN-covered conv biases get plain gradients for the
    region (``models/layers.py:bn_covered_bias`` undone); ``skip``: as
    shipped."""
    from ..models import layers
    orig = layers.bn_covered_bias
    if mode == "keep":
        layers.bn_covered_bias = lambda conv: conv.bias
    elif mode != "skip":
        raise ValueError(f"--bn-bias {mode!r}: skip or keep")
    try:
        yield
    finally:
        layers.bn_covered_bias = orig


def main(argv=None, *, device="cuda"):
    """Returns {variant: {"imgs_per_s_median", "imgs_per_s_best",
    "windows", "device"}} and prints it as JSON. ``device``: where the
    step runs (the tests pass the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--max-gts", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--dtype", default="f32")
    ap.add_argument("--simota", default="folded")
    ap.add_argument("--bn-bias", default="skip",
                    help="skip = BN-covered conv biases detached "
                         "(production), keep = plain autograd")
    ap.add_argument("--bn-group", default="0",
                    help="comma list of GhostBN group sizes "
                         "(train.bn_group; 0 = whole-batch BN)")
    args = ap.parse_args(argv)

    from ..config import yunet_n
    from ..train import init_train_state, make_train_step

    for sim in args.simota.split(","):
        if sim not in ("folded", "xla"):
            ap.error(f"--simota {sim!r}: folded or xla")
    rng = np.random.RandomState(0)
    cfg = yunet_n()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, img_size=args.img_size,
                                      max_gts=args.max_gts))
    dev_name = (torch.cuda.get_device_name(device)
                if torch.device(device).type == "cuda" else "cpu")

    variants = []
    for dt, sim, bnb, bng in itertools.product(
            args.dtype.split(","), args.simota.split(","),
            args.bn_bias.split(","),
            [int(x) for x in args.bn_group.split(",")]):
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, bn_group=bng,
                                           pallas_simota=sim != "xla"))
        ts, opt = init_train_state(cfg, steps_per_epoch=1000,
                                   total_batch=args.batch, device=device)
        step = make_train_step(cfg, ts.model, opt, img_size=args.img_size)
        np_dt = np.uint8 if dt == "uint8" else np.float32
        batch = make_batch(rng, args.batch, args.img_size, args.max_gts,
                           np_dt, device=device)
        with bn_bias(bnb):
            ts, m = step(ts, batch)                       # warm up
        float(m["loss"])
        variants.append({"name": f"dtype={dt},simota={sim},bn_bias={bnb},"
                                 f"bn_group={bng}",
                         "step": step, "ts": ts, "batch": batch,
                         "bn_bias": bnb, "vals": []})
        print(f"built {variants[-1]['name']}", file=sys.stderr)

    for _ in range(args.windows):
        for v in variants:
            with bn_bias(v["bn_bias"]):
                t0 = time.perf_counter()
                ts = v["ts"]
                for _ in range(args.iters):
                    ts, m = v["step"](ts, v["batch"])
                float(m["loss"])          # host readback: the sync
                dt_s = time.perf_counter() - t0
            v["ts"] = ts
            v["vals"].append(args.iters * args.batch / dt_s)
        time.sleep(0.3)

    out = {}
    for v in variants:
        out[v["name"]] = {
            "imgs_per_s_median": round(statistics.median(v["vals"]), 1),
            "imgs_per_s_best": round(max(v["vals"]), 1),
            "windows": [round(x, 1) for x in v["vals"]],
            "device": dev_name,
        }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
