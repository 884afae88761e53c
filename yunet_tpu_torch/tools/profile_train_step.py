"""Profile the train step: device kernel times from a torch.profiler
trace — counterpart of ``tools/misc/profile_train_step.py``.

Runs one step to warm up, then ``--steps`` steps under
``utils/profiling.trace`` and prints the device time by category and the
top device kernels (one step's worth, averaged over the traced steps),
then the host time of the kernel wrappers' spans (``yunet.k1``, the
streamed SimOTA's). On the card the table names the port's kernels (e.g.
the streamed SimOTA's ``valid_best_kernel`` and ``topk_kernel``). A run
on the CPU has no device lane and ends in that error.

  python -m yunet_tpu_torch.tools.profile_train_step --batch 16 --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def device_aug_batch(batch, rng, tb, device, *, wire=16, n_imgs=64,
                     bank_hw=1152):
    """The device-aug program's batch, as JAX's tool draws it: the GT
    trimmed to the loader's ``wire`` slots, a seeded uint8 bank of
    ``n_imgs`` images at bank_hw^2 on ``device`` and seeded crops."""
    batch = dict(batch)
    batch.pop("image")
    for k in ("gt_bboxes", "gt_labels", "gt_kps", "gt_valid"):
        batch[k] = batch[k][:, :wire]
    batch["bank"] = torch.from_numpy(rng.randint(
        0, 256, (n_imgs, bank_hw, bank_hw, 3)).astype(np.uint8)).to(device)
    batch["aug_idx"] = rng.randint(0, n_imgs, (tb,)).astype(np.int32)
    batch["aug_y0"] = rng.uniform(0, 200, (tb,)).astype(np.float32)
    batch["aug_x0"] = rng.uniform(0, 200, (tb,)).astype(np.float32)
    batch["aug_side"] = rng.uniform(320, 960, (tb,)).astype(np.float32)
    batch["aug_flip"] = rng.rand(tb) < 0.5
    return batch


def main(argv=None, *, device="cuda"):
    """Returns the trace's (us, launches) Counters by kernel name, or None
    when the trace holds no device event (the error is printed)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--max-gts", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="trace directory (default: yunet_trace under the "
                    "temporary directory)")
    ap.add_argument("--device-aug", action="store_true",
                    help="profile the device-aug program: the bank in card "
                    "memory, the resample in the step")
    ap.add_argument("--ema", action="store_true",
                    help="include the EMA update (rehearsal config)")
    args = ap.parse_args(argv)

    from ..config import yunet_n
    from ..train import init_train_state, make_train_step
    from ..utils.profiling import default_trace_dir, trace
    from ..utils.trace_profile import (NoDeviceEvents, aggregate_trace,
                                       report, span_totals)
    from .bench_train_step import make_batch

    out_dir = args.out or default_trace_dir("yunet_trace")
    cfg = yunet_n()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, img_size=args.img_size,
                                      max_gts=args.max_gts,
                                      device_aug=args.device_aug),
        train=dataclasses.replace(
            cfg.train, ema_momentum=0.0002 if args.ema else 0.0))
    ts, opt = init_train_state(cfg, steps_per_epoch=1000,
                               total_batch=args.batch, device=device)
    step = make_train_step(cfg, ts.model, opt, img_size=args.img_size)
    batch = make_batch(np.random.RandomState(0), args.batch, args.img_size,
                       args.max_gts, np.uint8, device=device)
    if args.device_aug:
        batch = device_aug_batch(batch, np.random.RandomState(1),
                                 args.batch, device)
    ts, m = step(ts, batch)
    float(m["loss"])

    with trace(out_dir):
        for _ in range(args.steps):
            ts, m = step(ts, batch)
        float(m["loss"])

    try:
        tot, cnt = aggregate_trace(out_dir)
    except (FileNotFoundError, NoDeviceEvents) as e:
        print(e)
        return None
    report(tot, cnt, args.steps, args.top, spans=span_totals(out_dir))
    return tot, cnt


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
