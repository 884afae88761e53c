"""One waiting caller of RetinaFace-R50: the closed loop of
``drivers/detect.py`` (``Detector.detect`` on one frame of the pool at a
time, device NMS), with RetinaFace's weights (the conv weights drawn from
the weight file's seed, the rest read from it:
``weights/make_retinaface_r50.py:load``), the port's RetinaFace plan, the
plain RetinaFace reference (``reference/retinaface.py``) and RetinaFace's
model FLOPs (``yardstick/retinaface.py:count_macs``)."""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from .. import harness
from ..reference.retinaface import detect_frames
from ..weights.make_retinaface_r50 import load
from ..yardstick import gen
from ..yardstick.retinaface import count_macs
from . import detect
from .base import dtype


def port_config(cfg: dict):
    """The port's Config holding the file's RetinaFace plan and test
    group."""
    from yunet_tpu_torch import config as pc
    return pc.Config(model=pc.RetinaFaceConfig(**{
        k: harness._tuples(v) for k, v in cfg["model"].items()}),
        test=pc.TestConfig(**cfg["test"]))


class Driver(detect.Driver):
    def setup_pool(self) -> None:
        # the plan first: a program without it fails here, at once
        self.port_cfg = port_config(self.cfg)
        t = self.traffic
        h, w = t["canvas"]
        self.pool = gen.frame_pool(self.seed, t["pool"], h, w, t["faces"],
                                   self.device)
        self.mark("pool")
        self._order = gen.rng_for(self.seed, 1)
        self._queue = []
        self.calls = []
        self.phase = "warmup"
        self.limits = {}
        self.sd = load(self.cfg["model"],
                       os.path.join(harness.ROOT, self.cfg["weights"]),
                       self.device)
        self.mark("weights")
        self.dtype = dtype(self.cfg["precision"])
        self.iou_thr = self.cfg["test"]["nms_iou_thr"]

    def window(self, seconds: float) -> Dict[str, float]:
        self.phase = "window"
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self.call())
        self.wall = time.perf_counter() - t0
        self.phase = "slice"
        self.attempted = len(lat)
        h, w = self.traffic["canvas"]
        self.window_flops = 2.0 * count_macs(self.cfg["model"], (h, w)) \
            * len(lat)
        ms = np.asarray(lat) * 1e3
        return {"detect_p50_ms": float(np.percentile(ms, 50)),
                "detect_p95_ms": float(np.percentile(ms, 95))}

    def reference(self, precision: str):
        return detect_frames(self.cfg["model"], self.cfg["test"], self.sd,
                             self.pool, top_k=self.top_k,
                             device=self.device, precision=precision)
