"""Training runtime — counterpart of ``yunet_tpu/train/loop.py``: an
explicit loop in place of the mmcv EpochBasedRunner + hook registry
(reference apis/train.py:117-244), on one device or data-parallel over
ranks, one card each (a ``mesh``, parallel/mesh.py).

Reference hooks and where their roles went:
  - LrUpdater / OptimizerHook  -> the train step (train/step.py)
  - CheckpointHook (interval epochs) + latest pointer / auto-resume
  - TextLogger/TensorboardLogger every N iters (+ images/sec/chip meter)
  - CheckInvalidLossHook       -> finite-loss guard
  - DistSamplerSeedHook        -> epoch-seeded shuffling in TrainLoader,
                                  each rank drawing its own rows
  - SyncNormHook               -> BN running stats averaged in the step
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import SampleSpec
from ..data.loader import TrainLoader, device_prefetch
from ..parallel.mesh import Mesh, barrier
from ..utils.logging import MetricsLogger, get_logger
from .checkpoint import (find_latest_checkpoint, load_checkpoint,
                         save_checkpoint)
from .step import TrainState, init_train_state, make_train_step


def build_loader(cfg: Config, *, mesh: Optional[Mesh] = None,
                 start_step: int = 0):
    """fit's default loader over cfg.data, resumed at ``start_step``: a
    TrainLoader, or with ``data.device_aug`` a DeviceAugLoader whose bank
    holds only this rank's record shard. With a mesh each rank draws its
    own rows of every global batch (``process_index``/``process_count``
    as JAX's are the rank and the world size, one card a process)."""
    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    spec = SampleSpec(img_size=cfg.data.img_size, max_gts=cfg.data.max_gts,
                      crop_choice=cfg.data.crop_choice,
                      flip_ratio=cfg.data.flip_ratio)
    if cfg.data.device_aug:
        from ..data.device_aug import DeviceAugLoader
        if world > 1 and not cfg.data.bank_sharded:
            raise ValueError(
                "multi-process device_aug requires "
                "data.bank_sharded=true: each host stages only its "
                "own record shard, so a replicated bank would hold "
                "different images per host (undefined SPMD inputs)")
        return DeviceAugLoader(
            cfg.data.train_ann, cfg.data.train_img_prefix,
            batch_size=cfg.data.samples_per_device, spec=spec,
            seed=cfg.train.seed, min_size=cfg.data.min_size,
            process_index=rank, process_count=world,
            start_step=start_step, bank_size=cfg.data.bank_size,
            bank_canvas=cfg.data.bank_canvas, device_shards=1,
            decoded_cache=cfg.data.decoded_cache)
    return TrainLoader(
        cfg.data.train_ann, cfg.data.train_img_prefix,
        batch_size=cfg.data.samples_per_device, spec=spec,
        num_workers=cfg.data.workers, seed=cfg.train.seed,
        min_size=cfg.data.min_size, process_index=rank,
        process_count=world, start_step=start_step,
        decoded_cache=cfg.data.decoded_cache,
        reduced_decode=cfg.data.reduced_decode)


def fit(cfg: Config, *, device, work_dir: Optional[str] = None,
        resume_from: Optional[str] = None, auto_resume: bool = False,
        load_pth: Optional[str] = None, max_steps: Optional[int] = None,
        mesh: Optional[Mesh] = None, loader=None, eval_hook=None,
        eval_interval_epochs: int = 0,
        sample_stats: bool = False) -> TrainState:
    """Train on ``device``. Returns the final TrainState.

    loader: any iterable of host batches with ``steps_per_epoch`` and
    ``close()``; by default ``build_loader``'s, resumed at the
    checkpoint's step. eval_hook: optional callable (train_state, step)
    -> dict of metrics (None on the ranks that do not report), fired
    every eval_interval_epochs and at the last step (the EvalHook
    counterpart, reference core/evaluation/eval_hooks.py:24-130). With
    ``data.device_aug`` the default loader is a DeviceAugLoader: its bank
    is staged into ``device`` once and every batch carries it (a loader
    with a ``bank`` is staged the same way).

    mesh: data-parallel training over the ranks of the process group,
    one card each (parallel/mesh.py); ``device`` is the rank's. Every rank
    runs this with the same arguments; the loaders draw each rank's rows,
    the step keeps the ranks' states equal, and rank 0 alone writes
    train.log, metrics.jsonl, the checkpoints and the sample statistics.
    """
    if mesh is not None:
        mesh.check()
    rank0 = mesh is None or mesh.rank == 0
    n_dev = mesh.size if mesh is not None else 1
    work_dir = work_dir or cfg.work_dir
    logger = get_logger(f"{work_dir}/train.log" if rank0 else None)
    metrics_log = MetricsLogger(work_dir) if rank0 else None
    from ..utils.env import env_string, setup_multi_processes
    setup_multi_processes()
    logger.info("environment:\n" + env_string())

    if resume_from is None and auto_resume:
        resume_from = find_latest_checkpoint(work_dir)
    resume_step = 0
    if resume_from:
        meta_path = os.path.join(resume_from, "meta.json")
        if os.path.exists(meta_path):
            resume_step = json.load(open(meta_path)).get("step", 0)

    # the loader first: its workers fork before this process builds the
    # model (in a process that already holds a CUDA context they touch
    # numpy and CPU torch only)
    if loader is None:
        loader = build_loader(cfg, mesh=mesh, start_step=resume_step)
    it = None
    try:
        steps_per_epoch = loader.steps_per_epoch
        total_batch = cfg.data.samples_per_device * n_dev

        state_dict = None
        if load_pth:
            from ..utils.jax_params import load_pth_state_dict
            state_dict = load_pth_state_dict(load_pth)
            logger.info(f"initialized weights from {load_pth}")
        ts, opt = init_train_state(cfg, steps_per_epoch=steps_per_epoch,
                                   total_batch=total_batch, device=device,
                                   state_dict=state_dict)
        if resume_from:
            ts, _ = load_checkpoint(resume_from, ts, opt)
            logger.info(f"resumed from {resume_from} at step {ts.step}")

        step_fn = make_train_step(cfg, ts.model, opt,
                                  img_size=cfg.data.img_size, mesh=mesh)
        total_steps = (max_steps if max_steps is not None
                       else cfg.train.max_epochs * steps_per_epoch)
        logger.info(
            f"training {cfg.model.name}: {steps_per_epoch} steps/epoch, "
            f"{total_steps} total steps, global batch {total_batch}, "
            f"{n_dev} devices")

        stats = None
        if sample_stats:
            from .hooks import SampleSizeStatistics
            stats = SampleSizeStatistics()

        bank = None
        if hasattr(loader, "bank"):
            # the card-staged dataset: one copy now, then handed to every
            # step, which resamples its crops on the card
            t_stage = time.time()
            bank = loader.bank.to_device(device)   # returns once copied
            logger.info(
                f"staged {len(loader.bank)} images "
                f"({bank.numel() / 1e9:.2f} GB) into device HBM "
                f"in {time.time() - t_stage:.1f}s")

        # align the ranks before the first step: one that is still
        # building or staging would otherwise hold the first collective
        barrier(mesh)
        it = device_prefetch(iter(loader), device=device)
        t_last = time.time()
        imgs_since = 0
        for i in range(ts.step, total_steps):
            batch = next(it)
            batch.pop("num_overflow", None)
            if bank is not None:
                batch["bank"] = bank
            if stats is not None:
                stats.update({k: batch[k].cpu().numpy()
                              for k in ("gt_bboxes", "gt_valid")})
            ts, m = step_fn(ts, batch)
            imgs_since += total_batch
            step = i + 1
            if step % cfg.train.log_interval == 0 or step == total_steps:
                # the metric scalars as ONE tensor: one device->host fetch
                # a log interval, none on the other steps
                keys = sorted(m)
                packed = torch.stack([m[k].float() for k in keys]).cpu()
                m = dict(zip(keys, packed.numpy()))
                loss = float(m["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {step}")
                dt = time.time() - t_last
                ips = imgs_since / max(dt, 1e-9)
                epoch = step // steps_per_epoch
                logger.info(
                    f"epoch {epoch} step {step}/{total_steps} "
                    f"loss {loss:.4f} (cls {float(m['loss_cls']):.4f} "
                    f"bbox {float(m['loss_bbox']):.4f} "
                    f"obj {float(m['loss_obj']):.4f} "
                    f"kps {float(m['loss_kps']):.4f}) "
                    f"num_pos {float(m['num_pos']):.0f} "
                    f"imgs/s {ips:.1f} ({ips / n_dev:.1f}/chip)")
                if metrics_log is not None:
                    metrics_log.log(step, {**{k: float(v)
                                              for k, v in m.items()},
                                           "imgs_per_sec": ips},
                                    prefix="train")
                t_last = time.time()
                imgs_since = 0
            if (step % (cfg.train.checkpoint_interval * steps_per_epoch) == 0
                    or step == total_steps):
                path = save_checkpoint(work_dir, ts, opt,
                                       epoch=step // steps_per_epoch,
                                       meta={"config": cfg.model.name},
                                       mesh=mesh)
                if rank0:
                    logger.info(f"saved checkpoint {path}")
            if (eval_hook is not None and eval_interval_epochs > 0
                    and (step % (eval_interval_epochs * steps_per_epoch) == 0
                         or step == total_steps)):
                # also fire on the final step — the reference EvalHook
                # always evaluates at the end of training
                ev = eval_hook(ts, step)
                if ev is not None:   # the ranks past 0 report nothing
                    logger.info(f"eval @ step {step}: {ev}")
                    if metrics_log is not None:
                        metrics_log.log(step, ev, prefix="val")
        if stats is not None and rank0:
            stats.dump(f"{work_dir}/sample_size_stats.json")
    finally:
        if it is not None:
            it.close()
        loader.close()
        if metrics_log is not None:
            metrics_log.close()
    # a fast rank must not leave (and tear the group down) while another
    # is still checkpointing or logging
    barrier(mesh)
    return ts
