"""One waiting caller: a closed loop of ``Detector.detect`` on one frame of
the pool at a time, with device NMS, the next call made when the last
returned.

detect_p50_ms, detect_p95_ms: the median and the 95th percentile of
every call of the window, each from the call to its returned result.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .. import harness
from ..yardstick.flops import count_macs
from .detection import Detection


class Driver(Detection):
    reports = ("detect_p50_ms", "detect_p95_ms")
    scope = "detect"

    def setup(self) -> None:
        from yunet_tpu_torch.eval.detect import Detector
        self.setup_pool()
        t = self.traffic
        self.top_k = self.cfg["test"]["device_nms_pre"]
        self.det = Detector(self.port_cfg, harness.port_state_dict(self.sd),
                            device=self.device, dtype=self.dtype,
                            fused=t["fused"])
        self.mark("program")
        self.dispatch_s = []
        for _ in range(t["warmup_calls"]):
            self.call()
        self.mark("warmup")

    def call(self) -> float:
        """One detect; returns its seconds."""
        i = self.take(1)
        frame, canvas = self.pool[i[0]], tuple(self.traffic["canvas"])
        timings = {}
        t0 = time.perf_counter()
        answer = self.det.detect(frame, canvas, use_device_nms=True,
                                 timings=timings)
        dt = time.perf_counter() - t0
        self.calls.append((i, self.planted(i, [answer]), self.phase))
        if self.phase == "window":
            self.dispatch_s.append(timings["dispatch"])
        return dt

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

    def slice(self) -> int:
        for _ in range(self.traffic["trace_calls"]):
            self.call()
        self.slice_calls = self.traffic["trace_calls"]
        return self.slice_calls
