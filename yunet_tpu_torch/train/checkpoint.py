"""Checkpoint save/resume as torch files with reference-style metadata —
counterpart of ``yunet_tpu/train/checkpoint.py``.

The layout is JAX's: ``work_dir/ckpt_{step:08d}/`` holds the state and a
``meta.json`` (step, epoch, version, classes, git, time, plus the caller's
meta), and ``work_dir/latest`` names the newest checkpoint for
--auto-resume (reference tools/train.py:218-223, utils/misc.py:11-42).

The state is one ``torch.save`` file of tensors and plain containers,
read back with ``weights_only=True``: the model's state dict (parameters
and BN running statistics), the SGD momentum trace and its count (the LR
schedule reads the count), the EMA shadow and ``TrainState.step`` (the EMA
warmup reads it). JAX keeps its optimizer state inside the TrainState; the
port's optimizer is a separate object, so save and load take it too.
Weight-only init from a reference ``.pth`` is
``utils/jax_params.py:load_pth_state_dict``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import time
from typing import Any, Dict, Optional, Tuple

import torch

from .step import SGDMomentum, TrainState

STATE_FILE = "state.pt"


def _ckpt_dir(work_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(work_dir), f"ckpt_{step:08d}")


def _git_hash() -> str:
    """Embed the repo git hash in checkpoint meta (the reference embeds
    mmdet version + git hash, tools/train.py:218-223)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or "unknown"
    except (subprocess.SubprocessError, OSError):
        return "unknown"


def _host(tensors):
    return None if tensors is None else [t.detach().cpu() for t in tensors]


def save_checkpoint(work_dir: str, ts: TrainState, opt: SGDMomentum, *,
                    epoch: int, meta: Optional[Dict[str, Any]] = None
                    ) -> str:
    step = int(ts.step)
    path = _ckpt_dir(work_dir, step)
    os.makedirs(path, exist_ok=True)
    state = {"model": {k: v.detach().cpu()
                       for k, v in ts.model.state_dict().items()},
             "opt_trace": _host(opt.trace), "opt_count": int(opt.count),
             "ema": _host(ts.ema), "step": step}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    info = {"step": step, "epoch": epoch,
            "version": "yunet_tpu_torch-0.1", "classes": ["FG"],
            "git": _git_hash(), "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    info.update(meta or {})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(info, f)
    with open(os.path.join(work_dir, "latest"), "w") as f:
        f.write(path)
    return path


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    latest = os.path.join(work_dir, "latest")
    if os.path.exists(latest):
        path = open(latest).read().strip()
        if os.path.isdir(path):
            return path
    if not os.path.isdir(work_dir):
        return None
    cands = [d for d in os.listdir(work_dir)
             if re.fullmatch(r"ckpt_\d+", d)]
    if not cands:
        return None
    return os.path.join(work_dir, max(cands))


def read_state(path: str) -> Dict[str, Any]:
    """The saved state of checkpoint directory ``path``, on the CPU."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def load_checkpoint(path: str, ts: TrainState, opt: SGDMomentum
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore checkpoint ``path`` into ``ts`` (model, step, EMA) and
    ``opt`` (trace, count) in place, on the model's device. Returns (ts,
    meta)."""
    state = read_state(path)
    device = next(ts.model.parameters()).device
    ts.model.load_state_dict(state["model"])
    ts.step = int(state["step"])
    if (state["ema"] is None) != (ts.ema is None):
        raise ValueError(f"{path}: an EMA shadow is in one of the "
                         "checkpoint and the TrainState only "
                         "(train.ema_momentum differs)")
    if ts.ema is not None:
        ts.ema = [e.to(device) for e in state["ema"]]
    opt.trace = (None if state["opt_trace"] is None
                 else [t.to(device) for t in state["opt_trace"]])
    opt.count = int(state["opt_count"])
    meta_path = os.path.join(path, "meta.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    return ts, meta
