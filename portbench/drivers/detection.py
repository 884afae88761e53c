"""What a driver of detection traffic needs: a pool of frames drawn from
the seed, the order in which calls take them, the program's answers kept
for the check, and the check itself against the reference detector."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import harness
from ..reference import compare
from ..reference.detect import detect_frames
from ..yardstick import gen
from .base import Driver, dtype


class Detection(Driver):
    # a test may plant: the top detection of each call's first frame at
    # half its score ("altered"); every detection under CUT dropped
    # ("raised_thr"); every detection under 0.3 moved by MOVE px
    # ("made_up")
    faults = ("altered", "raised_thr", "made_up")
    CUT, MOVE = 0.1, 16.0

    def setup_pool(self) -> None:
        t = self.traffic
        h, w = t["canvas"]
        self.pool = gen.frame_pool(self.seed, t["pool"], h, w, t["faces"],
                                   self.device)
        self.mark("pool")
        self._order = gen.rng_for(self.seed, 1)
        self._queue: List[int] = []
        # (frame indices, answers, phase): warmup, window or slice
        self.calls: List[tuple] = []
        self.phase = "warmup"
        self.limits: Dict[str, float] = {}
        self.sd = harness.weights(self.cfg, self.device)
        self.port_cfg = harness.port_config(self.cfg)
        self.mark("weights")
        self.dtype = dtype(self.cfg["precision"])
        self.iou_thr = self.cfg["test"]["nms_iou_thr"]

    def take(self, n: int) -> List[int]:
        """The next n frames: the pool in a fresh random order each time
        it is used up, so every frame is served equally often."""
        while len(self._queue) < n:
            self._queue += list(self._order.permutation(len(self.pool)))
        out, self._queue = self._queue[:n], self._queue[n:]
        return out

    def planted(self, idx, answers):
        if self.fault == "altered" and len(answers[0]["bboxes"]):
            answers[0] = dict(answers[0], bboxes=answers[0]["bboxes"].copy())
            answers[0]["bboxes"][0, 4] *= 0.5
        elif self.fault == "raised_thr":
            keep = [a["bboxes"][:, 4] >= self.CUT for a in answers]
            answers = [dict(a, bboxes=a["bboxes"][k], kps=a["kps"][k])
                       for a, k in zip(answers, keep)]
        elif self.fault == "made_up":
            answers = [dict(a, bboxes=a["bboxes"].copy(), kps=a["kps"].copy())
                       for a in answers]
            for a in answers:
                low = a["bboxes"][:, 4] < 0.3
                a["bboxes"][low, 0:4:2] += self.MOVE
                a["kps"][low, 0::2] += self.MOVE
        return answers

    def reference(self, precision: str) -> List[dict]:
        return detect_frames(self.cfg["model"], self.cfg["test"], self.sd,
                             self.pool, top_k=self.top_k,
                             device=self.device, precision=precision)

    def check(self) -> Dict[str, float]:
        """Every answer the program gave (warm-up, window and slice),
        against the reference's detections of its frame. Equal answers
        of one frame are compared once."""
        self.ref = self.reference("f32")
        limits = self.limits
        worst = dict.fromkeys(compare.NUMBERS, 0.0)
        seen: Dict[tuple, bool] = {}
        self.failed = 0
        for idx, answers, phase in self.calls:
            for i, a in zip(idx, answers):
                key = (i, a["bboxes"].tobytes(), a["kps"].tobytes())
                if key not in seen:
                    gaps = compare.frame_gaps(a, self.ref[i], self.iou_thr)
                    for k, v in gaps.items():
                        worst[k] = max(worst[k], v)
                    seen[key] = all(gaps[k] <= limits.get(k, np.inf)
                                    for k in gaps)
                self.failed += phase == "window" and not seen[key]
        self.distinct = len(seen)
        return worst

    def control(self) -> Dict[str, float]:
        """The reference in float8 in the program's place, over the pool."""
        ref = getattr(self, "ref", None) or self.reference("f32")
        low = self.reference("fp8")
        worst = dict.fromkeys(compare.NUMBERS, 0.0)
        for a, b in zip(low, ref):
            for k, v in compare.frame_gaps(a, b, self.iou_thr).items():
                worst[k] = max(worst[k], v)
        return worst

    def release(self) -> None:
        import torch
        self.det = None
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()
