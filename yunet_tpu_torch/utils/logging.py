"""Logging & metrics — a copy of ``yunet_tpu/utils/logging.py`` (replaces
mmcv get_root_logger + Text/TensorboardLoggerHook).

JSONL metric stream is the primary machine-readable log (one object per log
step); TensorBoard is used when available. Mirrors reference behaviours at
utils/logger.py:8-22 and configs/yunet_n.py:14-17.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

_LOGGER_NAME = "yunet_tpu_torch"


_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """The package logger, to stdout and, given ``log_file``, to that file.
    A later call with another ``log_file`` moves the file output there
    (JAX's keeps the first file of the process, so a second training run
    in one process would log into the first one's work dir)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
        logger.propagate = False
    if log_file:
        path = os.path.abspath(log_file)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """JSONL metrics writer + optional TensorBoard."""

    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter  # noqa
                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "train"):
        rec = {"step": step, "time": time.time(), "mode": prefix}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
                except (TypeError, ValueError):
                    pass

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
