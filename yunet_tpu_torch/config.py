"""Dataclass configuration and the two shipped presets.

A copy of ``yunet_tpu/config.py``'s dataclasses and presets: that file is
framework-neutral, but importing it runs ``yunet_tpu/__init__.py``, which
imports jax. A test holds this copy equal to the original, field by field.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture plan (reference configs/yunet_n.py:104-131)."""

    name: str = "yunet_n"
    # stage 0 is the stem (in, mid, out); later stages are
    # Conv4layerBlocks (in, out)
    stage_channels: Tuple[Tuple[int, ...], ...] = (
        (3, 16, 16), (16, 64), (64, 64), (64, 64), (64, 64), (64, 64))
    downsample_idx: Tuple[int, ...] = (0, 2, 3, 4)
    out_idx: Tuple[int, ...] = (3, 4, 5)
    neck_in_channels: Tuple[int, ...] = (64, 64, 64)
    num_classes: int = 1
    head_in_channels: int = 64
    feat_channels: int = 64
    shared_stacked_convs: int = 1
    stacked_convs: int = 0
    use_kps: bool = True
    kps_num: int = 5
    strides: Tuple[int, ...] = (8, 16, 32)
    prior_offset: float = 0.0
    # training-only knobs of the JAX package, kept so the presets compare
    # equal; the serving path here does not read them
    remat_stages: Tuple[int, ...] = ()
    composed_dp: bool = True


@dataclass(frozen=True)
class LossConfig:
    cls_weight: float = 1.0
    bbox_weight: float = 5.0
    obj_weight: float = 1.0
    kps_weight: float = 0.1
    kps_beta: float = 1.0 / 9.0
    eiou_smooth_point: float = 0.1
    eiou_eps: float = 1e-6


@dataclass(frozen=True)
class AssignerConfig:
    center_radius: float = 2.5
    candidate_topk: int = 10
    iou_weight: float = 3.0
    cls_weight: float = 1.0


@dataclass(frozen=True)
class TestConfig:
    """Decode/NMS at test time (reference configs/yunet_n.py:139-145)."""

    score_thr: float = 0.02
    nms_iou_thr: float = 0.45
    max_per_img: int = -1  # -1: keep everything above score_thr
    # static cap for the on-device NMS path (host C++ NMS has no cap)
    device_nms_pre: int = 5000


@dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/widerface/"
    train_ann: str = "data/widerface/labelv2/train/labelv2.txt"
    train_img_prefix: str = "data/widerface/WIDER_train/images/"
    val_ann: str = "data/widerface/labelv2/val/labelv2.txt"
    val_img_prefix: str = "data/widerface/WIDER_val/images/"
    gt_dir: str = "data/widerface/labelv2/val/gt/"
    img_size: int = 640
    crop_choice: Tuple[float, ...] = (0.5, 0.7, 0.9, 1.1, 1.3, 1.5)
    flip_ratio: float = 0.5
    max_gts: int = 128
    samples_per_device: int = 16
    workers: int = 4
    min_size: float | None = None
    decoded_cache: str | None = None
    reduced_decode: bool = False
    device_aug: bool = False
    bank_size: int = 640
    bank_canvas: int = 1152
    bank_sharded: bool = False


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.01
    base_total_batch: int = 32
    auto_scale_lr: bool = False
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_iters: int = 1500
    warmup_ratio: float = 0.001
    lr_decay_epochs: Tuple[int, ...] = (400, 544)
    lr_decay_factor: float = 0.1
    max_epochs: int = 640
    checkpoint_interval: int = 80
    log_interval: int = 50
    seed: int = 0
    bf16: bool = True
    fused_kernels: bool = False
    pallas_simota: bool = True
    ema_momentum: float = 0.0
    grad_clip: float = 0.0
    bn_group: int = 0


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    assigner: AssignerConfig = field(default_factory=AssignerConfig)
    test: TestConfig = field(default_factory=TestConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    work_dir: str = "./work_dirs/yunet_n"


def yunet_n() -> Config:
    """The shipped YuNet-n preset (reference configs/yunet_n.py)."""
    return Config()


def yunet_s() -> Config:
    """The shipped YuNet-s preset (reference configs/yunet_s.py):
    narrower stages, no shared head conv, tighter crop choices."""
    return Config(
        model=ModelConfig(
            name="yunet_s",
            stage_channels=((3, 16, 16), (16, 32), (32, 64), (64, 64),
                            (64, 64), (64, 64)),
            shared_stacked_convs=0,
        ),
        data=DataConfig(crop_choice=(0.3, 0.45, 0.6, 0.8, 1.0)),
        work_dir="./work_dirs/yunet_s",
    )


_PRESETS = {"yunet_n": yunet_n, "yunet_s": yunet_s}


def get_config(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown config '{name}'; have {sorted(_PRESETS)}")
    cfg = _PRESETS[name]()
    root = os.environ.get("YUNET_DATA_ROOT")
    if root:
        cfg = _retarget_data_root(cfg, root)
    return cfg


def _retarget_data_root(cfg: Config, root: str) -> Config:
    """Repoint dataset paths at another root."""
    d = cfg.data
    old = d.data_root

    def sub(p: str) -> str:
        return p.replace(old, root.rstrip("/") + "/", 1) \
            if p.startswith(old) else p

    new_d = dataclasses.replace(
        d, data_root=root, train_ann=sub(d.train_ann),
        train_img_prefix=sub(d.train_img_prefix), val_ann=sub(d.val_ann),
        val_img_prefix=sub(d.val_img_prefix), gt_dir=sub(d.gt_dir))
    return dataclasses.replace(cfg, data=new_d)


def validate_config(cfg: Config, *, force_experimental: bool = False
                    ) -> Config:
    """Reject measured-loser / inconsistent flag combinations — a copy of
    ``yunet_tpu/config.py:validate_config``, with its messages.

    Raises ValueError on a parked combination (unless
    ``force_experimental``) and on outright inconsistencies (always). The
    parked reasons are the JAX package's TPU measurements; this is also
    where the port's fused-kernel training path (``train.fused_kernels``)
    is reached from: ``make_train_step`` does not call it, a CLI does.
    """
    # --- hard inconsistencies: never allowed -----------------------------
    if cfg.data.bank_sharded and not cfg.data.device_aug:
        raise ValueError(
            "data.bank_sharded=true requires data.device_aug=true "
            "(the bank only exists on the device_aug path)")
    if cfg.train.bn_group < 0:
        raise ValueError("train.bn_group must be >= 0")
    if (cfg.train.bn_group > 0
            and cfg.data.samples_per_device % cfg.train.bn_group):
        raise ValueError(
            f"train.bn_group={cfg.train.bn_group} must divide the local "
            f"batch data.samples_per_device={cfg.data.samples_per_device} "
            "(GhostBN reshapes the batch into fixed groups)")
    if cfg.data.device_aug and cfg.data.bank_canvas < cfg.data.bank_size:
        raise ValueError(
            f"data.bank_canvas={cfg.data.bank_canvas} must be >= "
            f"data.bank_size={cfg.data.bank_size}")

    # --- measured-and-parked combinations: need --force-experimental -----
    parked = []
    if cfg.train.fused_kernels:
        parked.append(
            "train.fused_kernels=true: the Pallas fused pw->dw training "
            "kernels are MEASURED SLOWER than the composed-conv XLA path "
            "at b128/640^2 (ops/convdp_train_pallas.py root-cause notes); "
            "the shipped winner is model.composed_dp=true")
    if cfg.model.remat_stages:
        parked.append(
            f"model.remat_stages={cfg.model.remat_stages}: measured "
            "~4-11% slower at b128/640^2 (the step is HBM-bound; XLA "
            "materializes the recomputed tensors anyway, config.py "
            "remat_stages note). It is a memory lever for batches that "
            "do not otherwise fit — force it only for that")
    if parked and not force_experimental:
        raise ValueError(
            "config uses measured-and-parked experimental flags:\n  - "
            + "\n  - ".join(parked)
            + "\npass --force-experimental (CLI) or "
            "validate_config(..., force_experimental=True) to run anyway")
    return cfg


def _coerce(value: str) -> Any:
    # lowercase true/false/none are what users actually type on a CLI;
    # ast.literal_eval only accepts the Python spellings, and the
    # fall-through returned the truthy STRING "false" (silently leaving
    # e.g. train.bf16 enabled)
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_overrides(cfg: Config, options: Sequence[str]) -> Config:
    """Apply ``section.key=value`` overrides (reference --cfg-options) —
    a copy of ``yunet_tpu/config.py:apply_overrides``."""
    for opt in options:
        key, _, raw = opt.partition("=")
        parts = key.strip().split(".")
        value = _coerce(raw.strip())
        cfg = _replace_path(cfg, parts, value)
    return cfg


def _replace_path(node: Any, parts: Sequence[str], value: Any) -> Any:
    head = parts[0]
    if not dataclasses.is_dataclass(node) or head not in {
            f.name for f in dataclasses.fields(node)}:
        raise KeyError(f"no config field '{head}' on {type(node).__name__}")
    if len(parts) == 1:
        current = getattr(node, head)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        if isinstance(current, bool) and not isinstance(value, bool):
            raise ValueError(
                f"config field '{head}' is a bool; got {value!r} "
                "(use true/false)")
        return dataclasses.replace(node, **{head: value})
    child = _replace_path(getattr(node, head), parts[1:], value)
    return dataclasses.replace(node, **{head: child})
