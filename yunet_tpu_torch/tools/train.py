"""Train YuNet on WIDER Face with the port — counterpart of
``tools/train.py``: the same options and the same log, on one device.

  python -m yunet_tpu_torch.tools.train yunet_n
  python -m yunet_tpu_torch.tools.train yunet_s --work-dir work_dirs/s \\
      --auto-resume
  python -m yunet_tpu_torch.tools.train yunet_n --cfg-options \\
      data.decoded_cache=data/widerface/train_cache data.workers=8
  python -m yunet_tpu_torch.tools.train yunet_n --smoke   # synthetic data

  python -m yunet_tpu_torch.tools.train yunet_n --cfg-options \
      data.device_aug=true data.decoded_cache=data/widerface/train_cache

A host without OpenCV reads training images from the decoded ``.npy``
cache (``data.decoded_cache``, built by ``data/cache.py``) and eval images
from ``--eval-cache-dir``. ``data.device_aug=true`` stages the decoded
train set in card memory once and crops it on the card each step
(data/device_aug.py). Data-parallel training (``--distributed``) is not
ported yet and raises; ``--single-device`` is accepted.
"""

import argparse
import dataclasses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a YuNet face detector")
    p.add_argument("config", help="preset name (yunet_n | yunet_s)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--load-pth", default=None,
                   help="initialize weights from a reference .pth")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--diff-seed", action="store_true",
                   help="mix the process index into the data seed "
                   "(reference --diff-seed; one process here: index 0)")
    p.add_argument("--sample-stats", action="store_true",
                   help="dump a GT-size histogram at the end "
                   "(YuNetSampleSizeStatisticsHook)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--single-device", action="store_true",
                   help="one device (the only mode of the port)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet: raises)")
    p.add_argument("--smoke", action="store_true",
                   help="20 steps on synthetic data (no dataset needed)")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted config overrides, e.g. train.lr=0.02")
    p.add_argument("--force-experimental", action="store_true",
                   help="allow measured-and-parked flag combinations "
                   "(e.g. train.fused_kernels, model.remat_stages) that "
                   "config validation otherwise rejects")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run WIDER val AP every N epochs (0 = off; the "
                   "reference EvalHook interval, configs/yunet_n.py:146)")
    p.add_argument("--eval-mode", type=int, default=2,
                   help="eval protocol mode as in tools/test_widerface.py "
                   "(0: 640x640, 1: 1650x1100, 2: origin size, >30: NxN)")
    p.add_argument("--eval-limit", type=int, default=0,
                   help="eval only the first N val images (0 = all)")
    p.add_argument("--eval-ann", default=None)
    p.add_argument("--eval-img-prefix", default=None)
    p.add_argument("--eval-gt-dir", default=None)
    p.add_argument("--eval-both-params", action="store_true",
                   help="when EMA is enabled, also evaluate the RAW "
                   "parameters each interval (raw_* metrics)")
    p.add_argument("--eval-device-nms", action="store_true",
                   help="run the whole-batch NMS kernel in the eval sweep "
                   "and read back only packed top-k rows (caps detections "
                   "at 750/image)")
    p.add_argument("--eval-cache-dir", default=None,
                   help="read eval images from this decoded .npy cache "
                   "(data/cache.py layout) instead of decoding the JPEGs")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """Train; returns the final TrainState. ``device``: where the model
    trains and the eval hook sweeps (the tests pass the CPU)."""
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError("multi-process training (--distributed) "
                                  "is not ported yet: ROADMAP M9")
    from ..config import apply_overrides, get_config, validate_config
    from ..train.loop import fit

    cfg = get_config(args.config)
    cfg = apply_overrides(cfg, args.cfg_options)
    cfg = validate_config(cfg, force_experimental=args.force_experimental)
    if args.seed is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, seed=args.seed))
    # --diff-seed adds the process index, which is 0 in one process

    loader = None
    max_steps = args.max_steps
    if args.smoke:
        from .smoke_data import SyntheticLoader
        loader = SyntheticLoader(cfg,
                                 batch_size=cfg.data.samples_per_device)
        max_steps = max_steps or 20

    eval_hook = None
    if args.eval_interval > 0:
        from ..eval.eval_hook import make_wider_eval_hook, widerface_eval_mode
        eval_hook = make_wider_eval_hook(
            cfg, device=device, mode=widerface_eval_mode(args.eval_mode),
            ann=args.eval_ann, img_prefix=args.eval_img_prefix,
            gt_dir=args.eval_gt_dir, limit=args.eval_limit,
            also_raw=args.eval_both_params,
            use_device_nms=args.eval_device_nms,
            cache_dir=args.eval_cache_dir)

    return fit(cfg, device=device, work_dir=args.work_dir,
               resume_from=args.resume_from, auto_resume=args.auto_resume,
               load_pth=args.load_pth, max_steps=max_steps, loader=loader,
               eval_hook=eval_hook,
               eval_interval_epochs=args.eval_interval,
               sample_stats=args.sample_stats)


if __name__ == "__main__":
    main()
