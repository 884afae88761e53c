"""Train YuNet on WIDER Face with the port — counterpart of
``tools/train.py``: the same options and the same log, on one card or
data-parallel with one process a card (``--distributed``).

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
(data/device_aug.py).

Data parallel: ``yunet_tpu_torch/tools/dist_train.sh yunet_n [options]``
starts one rank a card through torchrun, each with ``--distributed``,
which joins the process group (an initialised one, or torchrun's
environment: NCCL on the cards, gloo for ``--device cpu``) and trains
each rank on cuda:LOCAL_RANK. The global batch is
data.samples_per_device times the world size.

  NPROC=8 yunet_tpu_torch/tools/dist_train.sh yunet_n \\
      --cfg-options data.decoded_cache=data/widerface/train_cache
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
                   help="add the rank to the seed (reference --diff-seed)")
    p.add_argument("--sample-stats", action="store_true",
                   help="dump a GT-size histogram at the end "
                   "(YuNetSampleSizeStatisticsHook)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--single-device", action="store_true",
                   help="no data parallelism, even in a process group")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training, one process a card: "
                   "join the process group (torchrun's environment, see "
                   "tools/dist_train.sh)")
    p.add_argument("--device", default=None,
                   help="where to train (default: cuda, or "
                   "cuda:LOCAL_RANK with --distributed); cpu trains on the "
                   "CPU (gloo between ranks)")
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


def main(argv=None, *, device=None):
    """Train; returns the final TrainState. ``device``: where the model
    trains and the eval hook sweeps (the tests pass the CPU); it overrides
    ``--device``. With ``--distributed`` each rank trains on its card
    unless a device is named, and the process group is destroyed at the
    end if this call created it."""
    args = parse_args(argv)
    import torch.distributed as dist

    from ..config import apply_overrides, get_config, validate_config
    from ..parallel.mesh import initialize_distributed, local_device, make_mesh
    from ..train.loop import fit

    device = device if device is not None else args.device
    created = False
    if args.distributed:
        device = local_device(device)
        created = initialize_distributed(device=device)
    elif device is None:
        device = "cuda"
    try:
        cfg = get_config(args.config)
        cfg = apply_overrides(cfg, args.cfg_options)
        cfg = validate_config(cfg, force_experimental=args.force_experimental)
        # every rank of the group trains data-parallel (also a world of
        # one, so that its collectives run) unless --single-device
        mesh = (make_mesh(device, always=True)
                if args.distributed and not args.single_device else None)
        if args.seed is not None:
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, seed=args.seed))
        if args.diff_seed and args.distributed:
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(
                    cfg.train, seed=cfg.train.seed + dist.get_rank()))

        loader = None
        max_steps = args.max_steps
        if args.smoke:
            from .smoke_data import SyntheticLoader
            # each rank's loader gives its own rows: the per-rank batch
            loader = SyntheticLoader(cfg,
                                     batch_size=cfg.data.samples_per_device)
            max_steps = max_steps or 20

        eval_hook = None
        if args.eval_interval > 0:
            from ..eval.eval_hook import (make_wider_eval_hook,
                                          widerface_eval_mode)
            eval_hook = make_wider_eval_hook(
                cfg, device=device, mode=widerface_eval_mode(args.eval_mode),
                ann=args.eval_ann, img_prefix=args.eval_img_prefix,
                gt_dir=args.eval_gt_dir, limit=args.eval_limit, mesh=mesh,
                also_raw=args.eval_both_params,
                use_device_nms=args.eval_device_nms,
                cache_dir=args.eval_cache_dir)

        return fit(cfg, device=device, work_dir=args.work_dir,
                   resume_from=args.resume_from,
                   auto_resume=args.auto_resume, load_pth=args.load_pth,
                   max_steps=max_steps, mesh=mesh, loader=loader,
                   eval_hook=eval_hook,
                   eval_interval_epochs=args.eval_interval,
                   sample_stats=args.sample_stats)
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
