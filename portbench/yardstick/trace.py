"""Reading a torch.profiler chrome trace, frozen: the device lanes and the
kernel categories are copies of ``yunet_tpu_torch/utils/trace_profile.py``
(``DEVICE_CATS``, ``is_port_kernel``, ``port_kernel_name``,
``categorize``); the busy time is the union of the device intervals
inside the traced slice, not a sum of durations.
"""

from __future__ import annotations

import collections
import gzip
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def is_port_kernel(name: str) -> bool:
    return "(anonymous namespace)::" in name and "at::native" not in name


def port_kernel_name(name: str) -> str:
    name = name.split("(anonymous namespace)::")[1].split("<")[0]
    return name.split("(")[0]


def categorize(name: str) -> str:
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copy/transfer"
    if "nccl" in low:
        return "collective"
    if is_port_kernel(name):
        return "port kernel"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "implicit")):
        return "conv"
    if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "gemm"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void at::native::(anonymous namespace)::foo<3>(...)``
    -> ``at::native::foo``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


class Trace:
    """The events of one chrome trace that the metrics read, times in
    microseconds, clipped to the slice: the span named ``slice_name``
    that the harness wraps around the traced calls."""

    def __init__(self, path: str, slice_name: str):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f).get("traceEvents", [])
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == slice_name]
        if len(spans) != 1:
            raise ValueError(f"{path}: {len(spans)} spans named "
                             f"{slice_name}, want one")
        self.lo = float(spans[0]["ts"])
        self.hi = self.lo + float(spans[0]["dur"])
        self.device: List[Tuple[float, float, str, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            if t1 <= self.lo or t0 >= self.hi:
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append((max(t0, self.lo), min(t1, self.hi),
                                    e.get("name", "?"), cat))
            elif cat in HOST_CATS and e.get("name") != slice_name:
                self.host.append((t0, t1, e.get("name", "?")))
        self.device.sort()

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, merged and in order."""
        merged: List[List[float]] = []
        for t0, t1, _, _ in self.device:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self) -> List[Tuple[float, float, str]]:
        return [(t0, t1, n) for t0, t1, n, c in self.device if c == "kernel"]

    def kernel_us(self, names) -> Optional[float]:
        """Summed time of the kernels whose port name (or full name) is
        in ``names``; None when none ran in the slice."""
        names = set(names)
        hits = [t1 - t0 for t0, t1, n in self.kernels()
                if n in names or (is_port_kernel(n)
                                  and port_kernel_name(n) in names)]
        return sum(hits) if hits else None

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The n device operations that took most time in the slice, by
        short name (template instantiations summed), in seconds."""
        tot: Dict[str, float] = collections.Counter()
        for t0, t1, name, _ in self.device:
            tot[short_name(name)] += t1 - t0
        return [(k, v / 1e6) for k, v in tot.most_common(n)]

    def by_category(self) -> Dict[str, Tuple[float, int]]:
        """{category: (seconds, operations)} of the slice's device time."""
        out: Dict[str, List] = {}
        for t0, t1, name, _ in self.device:
            c = out.setdefault(categorize(name), [0.0, 0])
            c[0] += (t1 - t0) / 1e6
            c[1] += 1
        return {k: tuple(v) for k, v in sorted(out.items(),
                                                key=lambda kv: -kv[1][0])}

    def idle_gaps(self, n: int = 10, longest: int = 300
                  ) -> List[Tuple[str, float]]:
        """The device's idle time in the slice's ``longest`` gaps, summed
        by the innermost host event running at each gap's midpoint
        ("python, no torch op" where none)."""
        import numpy as np
        gaps, last = [], self.lo
        for a, b in self.busy_intervals():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.hi > last:
            gaps.append((last, self.hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        t0 = np.array([h[0] for h in self.host])
        t1 = np.array([h[1] for h in self.host])
        tot: Dict[str, float] = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            cover = np.flatnonzero((t0 <= mid) & (t1 >= mid)) \
                if len(t0) else []
            name = (self.host[min(cover, key=lambda i: t1[i] - t0[i])][2]
                    if len(cover) else "python, no torch op")
            tot[name] += b - a
        return [(k, v / 1e6) for k, v in tot.most_common(n)]
