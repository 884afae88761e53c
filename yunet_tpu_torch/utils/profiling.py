"""Profiling utilities — counterpart of ``yunet_tpu/utils/profiling.py``
(reference utils/profiling.py:11-41 role).

``profile_time`` wraps a region with wall timing that is honest about
asynchronous CUDA launches (it synchronizes the devices of the CUDA
tensors it is given); ``trace`` wraps a region with ``torch.profiler`` and
writes a chrome trace that ``utils/trace_profile.py`` reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree`` (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_cuda_devices, tree)) if tree else set()
    return set()


@contextlib.contextmanager
def profile_time(name: str, *, sync_on=None, logger=None,
                 enabled: bool = True):
    """Wall-clock a region; pass tensors via sync_on to include their
    completion: each CUDA device they lie on is synchronized (the JAX
    version's block_until_ready; CPU tensors are complete already)."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    yield
    for dev in _cuda_devices(sync_on):
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) * 1000
    msg = f"{name}: {dt:.2f} ms"
    (logger.info if logger else print)(msg)


def default_trace_dir(name: str = "yunet-trace") -> str:
    """``name`` under the temporary directory ($TMPDIR, else /tmp)."""
    import tempfile
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace of the region (CPU and, where CUDA
    is available, CUDA activities) and write it as a gzipped chrome trace
    ``<log_dir>/<time>.pt.trace.json.gz`` (view in Perfetto or
    chrome://tracing). Synchronize inside the region to capture every
    kernel it launched."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or default_trace_dir()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{time.time_ns()}.pt.trace.json.gz"))


class StepTimer:
    """Rolling images/sec meter (IterTimerHook counterpart)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        if self._times:
            return sum(self._times) / len(self._times)
        return None
