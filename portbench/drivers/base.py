"""The interface every driver keeps, which the harness and the metric
readers use. A driver runs one kind of traffic against the port:

  setup()            weights, the traffic pool, the program, the warm-up
  window(seconds)    the measured window; returns its end-to-end values
  slice()            the traced calls; returns how many
  release()          frees the program's state before the reference runs
  check()            {number: value} against the reference, after release
  control()          the same numbers for the reference computed in the
                     control precision in the program's place

and these attributes, read after the run: ``reports`` (the end-to-end
metrics ``window`` returns), ``scope`` (the per-layer metrics' suffix), ``attempted`` and ``failed`` (requests of the window, and of
them the ones whose answer failed a limit), ``window_flops`` and
``wall`` (model FLOPs done in the window, and its seconds),
``slice_calls``, and ``trace`` (the slice's Trace, set by the harness).
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class Driver:
    reports: tuple = ()
    scope = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *,
                 fault: Optional[str] = None):
        if fault is not None and fault not in self.faults:
            raise ValueError(f"{type(self).__module__}: no fault {fault}; "
                             f"have {self.faults}")
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.fault = fault
        self.attempted = self.failed = 0
        self.window_flops = 0.0
        self.wall = 0.0
        self.slice_calls = 0
        self.trace = None
        self.phases = {}
        self._t = time.perf_counter()

    # the faults a test may plant under the timed path
    faults: tuple = ()

    def mark(self, phase: str) -> None:
        """Seconds since the last mark (or construction) under phase."""
        self.sync()
        now = time.perf_counter()
        self.phases[phase] = now - self._t
        self._t = now

    def sync(self) -> None:
        import torch
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float) -> Dict[str, float]:
        raise NotImplementedError

    def slice(self) -> int:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        raise NotImplementedError

    def control(self) -> Dict[str, float]:
        raise NotImplementedError


def dtype(name: str):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
