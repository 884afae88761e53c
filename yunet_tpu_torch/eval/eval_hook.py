"""Eval-during-training: the WIDER Face val AP hook — counterpart of
``yunet_tpu/eval/eval_hook.py`` (reference EvalHook/DistEvalHook,
mmdet/core/evaluation/eval_hooks.py:24-130, enabled by
configs/yunet_n.py:146): every N epochs the training loop calls the hook,
which runs the full WIDER val protocol on the current parameters (the EMA
shadow when EMA is on) and returns {easy, medium, hard} APs. The loop logs
them to train.log and metrics.jsonl under the ``val`` prefix.

Under data parallelism (a ``mesh``, one card a rank) each rank sweeps a
round-robin shard of the val set on its card, the packed detections are
gathered on rank 0 and the protocol runs there once; the other ranks
return None (the reference's DistEvalHook + multi_gpu_test,
mmdet/apis/test.py:81,179-209).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data.cache import load_cached
from ..data.labelv2 import parse_labelv2
from ..models.detector import YuNet
from ..parallel.mesh import Mesh
from .detect import Detector
from .widerface import wider_evaluation


def widerface_eval_mode(mode: int) -> Union[str, Tuple[int, int]]:
    """Numeric WIDER protocol mode -> Detector mode, exactly as
    tools/test_widerface.py (reference tools/test_widerface.py:76-97):
    0 = 640x640, 1 = 1650x1100, 2 = origin size, >30 = NxN square."""
    if mode == 0:
        return (640, 640)
    if mode == 1:
        return (1650, 1100)
    if mode == 2:
        return "ORIGIN"
    if mode > 30:
        return (mode, mode)
    raise ValueError(f"bad WIDER eval mode {mode}")


def _gather_sharded_detections(bbs, n_total, pcount, pidx):
    """Gather every rank's packed per-image detections and rebuild the
    global record order on rank 0 (the collect half of the reference's
    multi_gpu_test, mmdet/apis/test.py:81,179-209; JAX's
    process_allgather of fixed-shape arrays). Rank r swept records
    r, r + pcount, ...; returns the full per-record list on rank 0, None
    elsewhere. The arrays are host numpy, gathered as pickled objects
    (gloo has no all_gather of CUDA tensors), so the f32 detections
    arrive bit for bit."""
    import torch.distributed as dist

    def gather(obj):
        out = [None] * pcount
        dist.all_gather_object(out, obj)
        return out

    k = max(1, max(gather(max((len(b) for b in bbs), default=0))))
    length = -(-n_total // pcount)  # ceil: the longest shard, all ranks
    packed = np.zeros((length, k, 5), np.float32)
    counts = np.zeros((length,), np.int32)
    for i, bb in enumerate(bbs):
        counts[i] = len(bb)
        packed[i, :len(bb)] = bb
    shards = gather((packed, counts))
    if pidx != 0:
        return None
    out = [None] * n_total
    for p, (g_packed, g_counts) in enumerate(shards):
        for j in range(len(range(p, n_total, pcount))):
            out[p + j * pcount] = g_packed[j, :g_counts[j]]
    return out


def ema_state_dict(ts) -> Dict[str, torch.Tensor]:
    """The model's state dict with each parameter replaced by its EMA
    shadow; the BN running statistics stay the model's, as in JAX (whose
    EMA shadows the params tree only)."""
    sd = ts.model.state_dict()
    for (name, _), shadow in zip(ts.model.named_parameters(), ts.ema):
        sd[name] = shadow
    return sd


def make_wider_eval_hook(cfg: Config, *, device,
                         mode: Union[str, Tuple[int, int]] = "ORIGIN",
                         ann: Optional[str] = None,
                         img_prefix: Optional[str] = None,
                         gt_dir: Optional[str] = None,
                         pad_divisor: int = 32,
                         limit: int = 0,
                         use_ema: bool = True,
                         also_raw: bool = False,
                         mesh: Optional[Mesh] = None,
                         use_device_nms: bool = False,
                         device_nms_top_k: int = 750,
                         cache_dir: Optional[str] = None,
                         dtype: torch.dtype = torch.bfloat16):
    """Build a ``(train_state, step) -> {'easy','medium','hard'}`` hook that
    sweeps on ``device`` in ``dtype``, bf16 by default (as JAX's
    ``Detector(cfg)``).

    limit: evaluate only the first N val images (0 = all).
    also_raw: when EMA is on and use_ema, also sweep the RAW parameters
    each interval and report their APs as ``raw_easy/raw_medium/raw_hard``.
    use_device_nms: the whole-batch NMS kernel in the sweep, reading back
    only packed top-``device_nms_top_k`` rows per image.
    cache_dir: read images from this decoded ``.npy`` cache
    (``data/cache.py``), else decode the JPEGs under img_prefix with
    OpenCV; a missing image raises either way, and neither switches to the
    other.
    mesh: the ranks of data-parallel training (every rank calls the hook
    at the same steps): rank r sweeps records[r::world] on ``device``,
    rank 0 gathers the detections and returns the APs, the others None.
    """
    if mesh is not None:
        mesh.check()
    pcount, pidx = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    ann = ann or cfg.data.val_ann
    img_prefix = img_prefix or cfg.data.val_img_prefix
    gt_dir = gt_dir or cfg.data.gt_dir
    records = parse_labelv2(ann, test_mode=True)
    if limit:
        records = records[:limit]
    # parameters are loaded into this model per call
    det = Detector(cfg, YuNet(cfg.model, device=torch.device(device)),
                   device=device, dtype=dtype)
    my_records = records[pidx::pcount]

    if cache_dir is not None:
        def load(rec):
            img = load_cached(cache_dir, rec.filename)
            if img is None:
                raise FileNotFoundError(
                    f"{rec.filename} is not in the cache {cache_dir}")
            return img
    else:
        import cv2

        def load(rec):
            img = cv2.imread(os.path.join(img_prefix, rec.filename))
            if img is None:
                raise FileNotFoundError(rec.filename)
            return img

    def _sweep(state_dict):
        det.model.load_state_dict(state_dict)
        # batched sweep — same engine as tools/test_widerface.py
        outs = det.detect_sweep(
            [((lambda r=rec: load(r)), (rec.height, rec.width))
             for rec in my_records],
            mode, pad_divisor=pad_divisor,
            use_device_nms=use_device_nms,
            device_nms_top_k=device_nms_top_k)
        bbs = [out["bboxes"] for out in outs]
        if pcount > 1:
            bbs = _gather_sharded_detections(bbs, len(records), pcount,
                                             pidx)
            if bbs is None:
                # a rank past 0: its detections delivered; the matcher
                # runs once, on rank 0
                return None
        results = {}
        for rec, bb in zip(records, bbs):
            xywh = np.concatenate(
                [bb[:, :2], bb[:, 2:4] - bb[:, :2], bb[:, 4:5]], axis=1)
            event, name = rec.filename.split("/")
            results.setdefault(event, {})[
                os.path.splitext(name)[0]] = xywh.astype(np.float64)
        easy, medium, hard = wider_evaluation(results, gt_dir)
        return {"easy": float(easy), "medium": float(medium),
                "hard": float(hard)}

    def hook(ts, step):
        ema_active = use_ema and ts.ema is not None
        aps = _sweep(ema_state_dict(ts) if ema_active
                     else ts.model.state_dict())
        if ema_active and also_raw:
            raw = _sweep(ts.model.state_dict())
            if aps is not None:
                aps.update({f"raw_{k}": v for k, v in raw.items()})
        return aps

    return hook
