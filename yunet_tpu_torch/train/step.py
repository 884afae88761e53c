"""One training step: forward + SimOTA targets + losses + backward + SGD
update + EMA — counterpart of ``yunet_tpu/train/step.py`` (single device).

Loss composition (reference yunet_head.py:418-534), losses in f32 whatever
the trunk's dtype:
  loss_cls  = sum BCE(cls_logits[fg], onehot*IoU) / N
  loss_obj  = sum BCE(obj_logits, fg)             / N
  loss_bbox = 5.0 * sum EIoU(decoded[fg], gt)     / N
  loss_kps  = 0.1 * sum(SmoothL1(kps_pred[fg], encode(gt)) * w) / sum(w)
  N = ng * max(num_pos / ng, 1), ng the GhostBN group count

The model's parameters and BN running statistics are updated in place:
``TrainState`` holds the model, the step count and the EMA shadow, the
optimizer holds its momentum trace. A batch that holds a ``bank`` (the
card-staged dataset, data/device_aug.py) carries crop geometry in place of
images, and the step resamples them on the bank's device.

With a ``mesh`` (parallel/mesh.py: one rank a card) the step is JAX's
``shard_map`` body, its collectives as all_reduces: each rank computes
the loss on its own rows with local BN statistics, ``num_pos`` is summed
over the ranks before the normalizer (the reference's reduce_mean), and
the gradients, the BN running statistics and the loss metrics are
averaged in one all_reduce before the update, so clipping sees the mean
gradient as optax does after ``pmean``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import Config
from ..models.detector import YuNet
from ..ops.boxes import bbox_decode, kps_encode
from ..ops.losses import bce_with_logits, eiou, smooth_l1
from ..ops.priors import grid_priors
from ..parallel.mesh import Mesh, broadcast_, unflatten_into_
from .ema import ema_update, exp_momentum
from .lr import lr_schedule, scale_lr
from .targets import build_targets_batched

BATCH_KEYS = ("image", "gt_bboxes", "gt_labels", "gt_kps", "gt_valid")


@dataclasses.dataclass
class TrainState:
    model: YuNet                  # parameters and BN running statistics
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None  # shadow of model.parameters()


class SGDMomentum:
    """The JAX optax chain (train/step.py:50-67) by hand: optional
    clip_by_global_norm, then g + wd*p over EVERY parameter, then the
    momentum trace m = g + mu*m, then p -= lr(count)*m, count from 0.

    torch.optim.SGD would skip a parameter whose .grad is None, and so
    stop decaying the detached BN-covered biases; here those take a zero
    gradient and keep their decay."""

    def __init__(self, schedule: Callable[[int], float], *, momentum: float,
                 weight_decay: float, grad_clip: float = 0.0):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.trace: Optional[List[torch.Tensor]] = None
        self.count = 0

    @torch.no_grad()
    def update(self, params: List[torch.Tensor],
               grads: List[Optional[torch.Tensor]]) -> None:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if self.grad_clip > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm * self.grad_clip)
                     for g in grads]
        grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        if self.trace is None:
            self.trace = [torch.zeros_like(p) for p in params]
        self.trace = [g + self.momentum * t
                      for g, t in zip(grads, self.trace)]
        step_size = -self.schedule(self.count)
        for p, m in zip(params, self.trace):
            p.add_(m * step_size)
        self.count += 1


def make_optimizer(cfg: Config, steps_per_epoch: int,
                   total_batch: int) -> SGDMomentum:
    lr = (scale_lr(cfg.train.lr, total_batch, cfg.train.base_total_batch)
          if cfg.train.auto_scale_lr else cfg.train.lr)
    sched = lr_schedule(
        lr, steps_per_epoch=steps_per_epoch,
        warmup_iters=cfg.train.warmup_iters,
        warmup_ratio=cfg.train.warmup_ratio,
        decay_epochs=cfg.train.lr_decay_epochs,
        decay_factor=cfg.train.lr_decay_factor)
    return SGDMomentum(sched, momentum=cfg.train.momentum,
                       weight_decay=cfg.train.weight_decay,
                       grad_clip=cfg.train.grad_clip)


def init_train_state(cfg: Config, *, steps_per_epoch: int, total_batch: int,
                     device, generator: Optional[torch.Generator] = None,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[TrainState, SGDMomentum]:
    """A YuNet on ``device`` in training mode, from ``state_dict`` or else
    drawn from ``generator`` (default: a CPU generator seeded with
    cfg.train.seed), with its optimizer and, when cfg.train.ema_momentum
    > 0, an EMA shadow equal to the initial parameters."""
    if state_dict is None and generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    model = YuNet(cfg.model, device=device,
                  generator=None if state_dict is not None else generator)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.train()
    ema = ([p.detach().clone() for p in model.parameters()]
           if cfg.train.ema_momentum > 0 else None)
    return (TrainState(model, 0, ema),
            make_optimizer(cfg, steps_per_epoch, total_batch))


def loss_fn(model: YuNet, cfg: Config, batch: Dict[str, torch.Tensor],
            priors: torch.Tensor, mesh: Optional[Mesh] = None):
    """Returns (total_loss, metrics, aux). batch holds JAX-layout tensors
    on the model's device: image (B, H, W, 3), gt_bboxes (B, G, 4),
    gt_labels (B, G), gt_kps (B, G, K, 3), gt_valid (B, G) bool. aux
    holds the targets and the detached inputs they were built from
    (cls, obj, decoded). The model runs in its current mode; in training
    mode its BN running statistics update in place. With a mesh the
    positives are summed over the ranks (one all_reduce) and
    metrics["num_pos"] is that sum; the losses stay this rank's."""
    images = batch["image"]
    images = images.to(torch.bfloat16 if cfg.train.bf16 else torch.float32)
    # NCHW for the library trunk; the fused trunk (train.fused_kernels)
    # takes the NHWC images as a channels-last view and stays channels-last
    x = images.permute(0, 3, 1, 2)
    fused = cfg.train.fused_kernels
    flat = model.forward_flat(x if fused else x.contiguous(),
                              cfg.train.bn_group, fused)
    cls_l = flat["cls"].float()                       # (B, P, C)
    obj_l = flat["obj"][..., 0].float()               # (B, P)
    bbox_p = flat["bbox"].float()                     # (B, P, 4)
    kps_p = flat["kps"].float()                       # (B, P, 2K)
    decoded = bbox_decode(priors, bbox_p)             # (B, P, 4)

    with torch.no_grad():
        tgt = build_targets_batched(
            cls_l.detach(), obj_l.detach(), priors, decoded.detach(),
            batch["gt_bboxes"], batch["gt_labels"], batch["gt_kps"],
            batch["gt_valid"], num_classes=cfg.model.num_classes,
            kps_num=cfg.model.kps_num,
            center_radius=cfg.assigner.center_radius,
            candidate_topk=cfg.assigner.candidate_topk,
            iou_weight=cfg.assigner.iou_weight,
            cls_weight=cfg.assigner.cls_weight,
            use_streamed=cfg.train.pallas_simota)

    # GhostBN groups are virtual replicas (step.py:124-150): the
    # normalizer floors the mean positives per group at 1 and the kps
    # avg_factor is taken per group
    b_local = images.shape[0]
    g = cfg.train.bn_group
    ng = b_local // g if 0 < g < b_local else 1
    local_pos = tgt["num_pos"].sum()
    if mesh is None:
        global_pos = local_pos
        num_pos = local_pos / ng
    else:
        # the reference normalizer: the mean over replicas of their
        # positives (reduce_mean at yunet_head.py:493-497), pmean as psum
        # over the world size
        global_pos = local_pos.clone()
        torch.distributed.all_reduce(global_pos)
        num_pos = global_pos / mesh.size / ng
    n = ng * torch.clamp(num_pos, min=1.0)

    fg = tgt["fg"].float()                            # (B, P)
    loss_cls = (bce_with_logits(cls_l, tgt["cls"]).sum(-1) * fg).sum() / n
    loss_obj = bce_with_logits(obj_l, tgt["obj"]).sum() / n
    loss_bbox = (eiou(decoded, tgt["bbox"],
                      smooth_point=cfg.loss.eiou_smooth_point,
                      eps=cfg.loss.eiou_eps) * fg).sum() / n

    enc_kps = kps_encode(priors, tgt["kps"])          # (B, P, 2K)
    kw = tgt["kps_weight"]                            # (B, P)
    kps_num_tot = smooth_l1(kps_p, enc_kps, cfg.loss.kps_beta) * kw[..., None]
    if ng == 1:
        loss_kps = kps_num_tot.sum() / torch.clamp(kw.sum(), min=1e-6)
    else:
        kn = kps_num_tot.reshape(ng, -1).sum(1)
        kd = kw.reshape(ng, -1).sum(1)
        loss_kps = (kn / torch.clamp(kd, min=1e-6)).mean()

    total = (cfg.loss.cls_weight * loss_cls
             + cfg.loss.obj_weight * loss_obj
             + cfg.loss.bbox_weight * loss_bbox
             + cfg.loss.kps_weight * loss_kps)
    metrics = {k: v.detach() for k, v in (
        ("loss", total), ("loss_cls", loss_cls), ("loss_obj", loss_obj),
        ("loss_bbox", cfg.loss.bbox_weight * loss_bbox),
        ("loss_kps", cfg.loss.kps_weight * loss_kps),
        ("num_pos", global_pos))}
    aux = {"targets": tgt, "cls": cls_l.detach(), "obj": obj_l.detach(),
           "decoded": decoded.detach()}
    return total, metrics, aux


def _resampled(cfg: Config, batch, img_size: int, device) -> dict:
    """A bank batch with its images resampled from the bank (crop, resize
    and flip: data/device_aug.py:device_resample) and its GT slots, which
    the loader sends only as many as its records can fill, re-padded to
    cfg.data.max_gts (yunet_tpu/train/step.py:199-224). The bank must lie
    on the model's device: it is never moved, nor resampled elsewhere."""
    from ..data.device_aug import AUG_KEYS, device_resample
    batch = dict(batch)
    bank = batch.pop("bank")
    if bank.device != torch.device(device):
        raise ValueError(f"the bank lies on {bank.device}, the model on "
                         f"{device}: stage it with ImageBank.to_device")
    geo = [torch.as_tensor(batch.pop(k)).to(device) for k in AUG_KEYS]
    batch["image"] = device_resample(
        bank, *geo, out_size=img_size,
        dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
        # side <= max(crop_choice) * bank short side, so this bounds
        # side / out_size even when bank_size != img_size
        max_scale=max(cfg.data.crop_choice) * cfg.data.bank_size / img_size)
    need = cfg.data.max_gts - batch["gt_bboxes"].shape[1]
    if need > 0:
        for k in ("gt_bboxes", "gt_labels", "gt_kps", "gt_valid"):
            v = torch.as_tensor(batch[k]).to(device)
            pad = (0, 0) * (v.dim() - 2) + (0, need)
            batch[k] = torch.nn.functional.pad(v, pad)
    return batch


def make_train_step(cfg: Config, model: YuNet, opt: SGDMomentum, *,
                    img_size: int, mesh: Optional[Mesh] = None):
    """The train step for ``model`` (the TrainState's) on its device:
    ``step(ts, batch) -> (ts, metrics)``, or ``(ts, metrics, aux)`` with
    ``return_aux=True`` (loss_fn's aux). The batch's arrays (numpy or
    tensors, JAX layout) are moved to the model's device. The model,
    optimizer and EMA shadow are updated in place and ts.step advances.

    With a ``mesh`` the batch is this rank's rows; the first call
    broadcasts rank 0's parameters, BN statistics, EMA shadow and momentum
    trace, so every rank starts from one state, and every step ends with
    the same update on every rank (metrics: the losses averaged over the
    ranks, num_pos summed)."""
    device = next(model.parameters()).device
    if mesh is not None:
        mesh.check()
    sizes = [(img_size // s, img_size // s) for s in cfg.model.strides]
    priors = torch.from_numpy(grid_priors(
        sizes, cfg.model.strides, cfg.model.prior_offset)).to(device)
    params = list(model.parameters())
    # the BN running statistics (the integer batch counters stay as they
    # are: train mode never reads them)
    stats = [b for b in model.buffers() if b.is_floating_point()]
    synced = [mesh is None]

    def step(ts: TrainState, batch, *, return_aux: bool = False):
        if not synced[0]:
            broadcast_(params + stats + (ts.ema or []) + (opt.trace or []),
                       mesh)
            synced[0] = True
        if "bank" in batch:
            batch = _resampled(cfg, batch, img_size, device)
        batch = {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS}
        model.train()
        total, metrics, aux = loss_fn(model, cfg, batch, priors, mesh)
        grads = list(torch.autograd.grad(total, params, allow_unused=True))
        if mesh is not None:
            grads, metrics = _pmean(grads, params, stats, metrics, mesh)
        opt.update(params, grads)
        if ts.ema is not None:
            # ExpMomentumEMA warmup (reference core/hook/ema.py:103-113)
            ema_update(ts.ema, params,
                       exp_momentum(cfg.train.ema_momentum)(float(ts.step)))
        ts.step += 1
        return (ts, metrics, aux) if return_aux else (ts, metrics)

    return step


def _pmean(grads, params, stats, metrics, mesh: Mesh):
    """JAX's ``pmean`` of the gradients, the new BN state and the metrics
    (yunet_tpu/train/step.py:226-230) as ONE all_reduce over a flat
    buffer: returns (mean gradients, metrics with the losses averaged);
    the BN running statistics are averaged in place. A BN-covered bias's
    missing gradient goes in as zeros, so it keeps its decay.
    metrics["num_pos"] is already the sum over the ranks."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    keys = [k for k in metrics if k != "num_pos"]
    flat = torch.cat([t.reshape(-1) for t in grads + stats]
                     + [torch.stack([metrics[k] for k in keys])])
    torch.distributed.all_reduce(flat)
    flat.div_(mesh.size)
    mean = [torch.empty_like(g) for g in grads]
    unflatten_into_(flat, mean + stats)
    avg = flat[-len(keys):]
    metrics = {**metrics, **{k: avg[i] for i, k in enumerate(keys)}}
    return mean, metrics
