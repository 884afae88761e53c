"""High-level entry points — counterpart of ``yunet_tpu/apis.py``
(reference mmdet/apis: init_detector, inference_detector, train_detector,
init_random_seed).
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .config import Config, get_config
from .eval.detect import Detector
from .models import YuNet, architecture
from .train.loop import fit as train_detector  # noqa: F401  (re-export)

# JAX's init_random_seed(None): int(jax.random.randint(PRNGKey(0), (), 0,
# 2**31 - 1)), a constant (a test holds it equal)
DEFAULT_SEED = 31327077


def init_random_seed(seed: Optional[int] = None) -> int:
    """``seed``, or else the value JAX's init_random_seed derives from
    PRNGKey(0) (the reference broadcasts rank 0's draw,
    apis/train.py:19-49; a fixed value is the same on every process)."""
    return DEFAULT_SEED if seed is None else seed


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs (Python, numpy) and torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def read_weights(cfg: Config, checkpoint: str, *,
                 trust_checkpoint: bool = False) -> Dict[str, torch.Tensor]:
    """The ``YuNet`` state_dict (on the CPU) in ``checkpoint``:

      * a reference ``.pth`` checkpoint (loaded by module name, tensors
        only; ``trust_checkpoint=True`` allows a full unpickle, which runs
        code from the file);
      * a flat ``.npz`` of JAX parameter leaves (``p{i}``/``s{i}``, the
        format of tests/fixtures/r04_ema.npz);
      * a checkpoint directory written by training (``ckpt_*``,
        train/checkpoint.py): its raw parameters and BN statistics, not
        the EMA shadow, as JAX's init_detector reads an orbax directory.
    """
    from .utils.jax_params import (load_flat_npz, load_pth_state_dict,
                                   state_dict_from_jax)
    if os.path.isdir(checkpoint):
        from .train.checkpoint import read_state
        return read_state(checkpoint)["model"]
    if checkpoint.endswith(".pth"):
        return load_pth_state_dict(checkpoint, trusted=trust_checkpoint)
    if checkpoint.endswith(".npz"):
        return state_dict_from_jax(*load_flat_npz(checkpoint, cfg.model))
    raise ValueError(f"unsupported checkpoint {checkpoint!r}: expected a "
                     ".pth, a flat .npz or a checkpoint directory")


def init_detector(config: Union[str, Config],
                  checkpoint: Optional[str] = None, *, device,
                  dtype: torch.dtype = torch.bfloat16,
                  fused: bool = False,
                  trust_checkpoint: bool = False) -> Detector:
    """Build a Detector on ``device`` from a preset name or Config and

      * no checkpoint: random init from a ``torch.Generator`` seeded with
        0 (drawn on the CPU, so every device gets the same weights);
      * an ``.onnx`` file (the reference's or export_onnx's): its
        BN-folded weights drive a fused Detector that holds no model;
      * any checkpoint ``read_weights`` reads;
      * for SCRFD, a ``.pth`` state dict alone.
    """
    cfg = get_config(config) if isinstance(config, str) else config
    arch = architecture(cfg.model)
    if arch is not YuNet and not (checkpoint or "").endswith(".pth"):
        raise ValueError(f"{arch.__name__} loads a .pth state dict alone "
                         f"(by module name), not {checkpoint!r}")
    if checkpoint is None:
        model = arch(cfg.model, device=torch.device("cpu"),
                     generator=torch.Generator().manual_seed(0))
        return Detector(cfg, model, device=device, dtype=dtype, fused=fused)
    if checkpoint.endswith(".onnx"):
        from .export.onnx_import import load_onnx_params
        return Detector(cfg, folded=load_onnx_params(
            checkpoint, cfg.model, device=device), device=device,
            dtype=dtype)
    return Detector(cfg, read_weights(
        cfg, checkpoint, trust_checkpoint=trust_checkpoint), device=device,
        dtype=dtype, fused=fused)


def inference_detector(detector: Detector,
                       imgs: Union[np.ndarray, Sequence[np.ndarray]],
                       mode: str = "AUTO") -> Union[Dict, list]:
    """Run detection on one image or a list of images (BGR ndarray)."""
    single = isinstance(imgs, np.ndarray)
    if single:
        imgs = [imgs]
    results = [detector.detect(img, mode=mode) for img in imgs]
    return results[0] if single else results
