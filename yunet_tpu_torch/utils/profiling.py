"""Profiling utilities — counterpart of ``yunet_tpu/utils/profiling.py``
(reference utils/profiling.py:11-41 role).

``profile_time`` wraps a region with wall timing that is honest about
asynchronous CUDA launches (it synchronizes the devices of the CUDA
tensors it is given); ``trace`` wraps a region with ``torch.profiler`` and
writes a chrome trace that ``utils/trace_profile.py`` reads.

``span`` names a region of the program (``yunet.<stage>``) on the
profiler's clock: while ``torch.profiler`` records, it is a range that
the profiler keeps as a host event of that name (``cpu_op`` in the chrome
trace, beside the card's kernels and copies); otherwise it is one shared
no-op and costs a read of the profiler's enabled flag. Spans nest on the
calling thread: a stage lies inside the call that runs it. A kernel
wrapper, called tens of times a detect, reads the flag itself and opens
no span at all while no profiler records: in place, on an H100's host, a
no-op ``with span()`` cost 0.6-0.9 us a call where a warm loop reads
0.1-0.2. ``laps`` reads the clock at the same stage boundaries for a
caller's timings dict, so its latency budget and the trace share one set
of boundaries.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


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


class _Off:
    """The span of a region while no profiler records. Its enter and exit
    are one bound C method that takes any arguments and returns "" (false,
    so an exception passes through): no Python frame runs."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


def span(name: str):
    """A range named ``name`` while torch.profiler records, else the shared
    no-op; use as ``with span("yunet.trunk"):``. The range is torch's C
    one: about 2 us an enter and exit on an H100's host under the
    profiler, where ``record_function`` takes about 15."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


# a C callable that takes a key and does nothing: the lap of an untimed call
_NO_LAP = "".format


def laps(timings: Optional[dict]):
    """The stage clock of one call: ``lap(key)`` sets ``timings[key]`` to
    the host seconds since the previous lap (the first: since ``laps``).
    Call it at the stage boundaries, where the stages' spans end, so one
    clock read closes a stage and opens the next. Without a dict the lap
    is a no-op and no clock is read."""
    if timings is None:
        return _NO_LAP
    last = time.perf_counter()

    def lap(key: str) -> None:
        nonlocal last
        now = time.perf_counter()
        timings[key] = now - last
        last = now
    return lap
