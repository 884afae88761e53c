"""Shared machinery for profiling the port's programs from a torch.profiler
trace — counterpart of ``yunet_tpu/utils/trace_profile.py``.

Used by ``tools/profile_train_step.py`` and ``tools/profile_serve.py``:
read the device lanes of a chrome trace (``utils/profiling.trace``), sum
them by kernel name, bin each name into a category by what the card calls
it, and print a per-category / per-op table and the port's own kernels.
JAX's ``HloMaps`` has no counterpart: eager torch compiles no HLO, and a
kernel's name is all the trace says of it. Nor has JAX's output-bytes
column: a kernel event carries no result shape.

``device_rows`` and ``port_kernels`` read the same kernels from a live
profiler's ``key_averages()`` (``chip_profile.py``).
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Counter, Dict, List, Tuple

# chrome-trace categories of the device lane: kernels, copies, fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class NoDeviceEvents(RuntimeError):
    """The trace holds no device event (e.g. a run on the CPU)."""


def is_port_kernel(name: str) -> bool:
    """A kernel of csrc/: each lives in an anonymous namespace (PyTorch's
    own anonymous-namespace kernels sit under at::native)."""
    return "(anonymous namespace)::" in name and "at::native" not in name


def port_kernel_name(name: str) -> str:
    """``void (anonymous namespace)::topk_kernel<16>(...)`` -> topk_kernel:
    one name for all template instantiations."""
    name = name.split("(anonymous namespace)::")[1].split("<")[0]
    return name.split("(")[0]


def categorize(name: str) -> str:
    """The category of a device event by the name the card gives it."""
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
    # nvjet_*: cuBLASLt's GEMM kernels
    if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "gemm"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def _newest_trace(out_dir: str) -> str:
    paths = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(out_dir, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace found under {out_dir}")
    return max(paths, key=os.path.getmtime)


def aggregate_trace(out_dir: str
                    ) -> Tuple[Counter[str], Counter[str]]:
    """Sum device-lane complete-event durations (us) and counts by name
    from the newest chrome trace under ``out_dir``. Raises
    FileNotFoundError without a trace and NoDeviceEvents when the trace
    has no kernel, copy or fill on a device."""
    path = _newest_trace(out_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    tot: Counter[str] = collections.Counter()
    cnt: Counter[str] = collections.Counter()
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        name = ev.get("name", "?")
        tot[name] += ev.get("dur", 0)
        cnt[name] += 1
    if not cnt:
        raise NoDeviceEvents(
            f"{path} holds no device event (kernel, memcpy or memset): the "
            "program ran on no CUDA device, or the profiler saw none")
    return tot, cnt


def categories(tot: Counter[str], cnt: Counter[str]
               ) -> Dict[str, Tuple[float, int]]:
    """{category: (us, launches)}, largest first."""
    us: Counter[str] = collections.Counter()
    n: Counter[str] = collections.Counter()
    for name, t in tot.items():
        us[categorize(name)] += t
        n[categorize(name)] += cnt[name]
    return {c: (t, n[c]) for c, t in us.most_common()}


def report(tot: Counter[str], cnt: Counter[str], steps: int,
           top: int = 30) -> None:
    total_us = sum(tot.values())
    print(f"device total: {total_us / steps / 1e3:.2f} ms/step "
          f"({len(tot)} distinct ops)")
    print("\nby category:")
    for cat, (us, n) in categories(tot, cnt).items():
        print(f"{us / steps / 1e3:9.3f} ms/step  x{n // steps:<5d} {cat}")
    print("\ntop ops:")
    for name, us in tot.most_common(top):
        print(f"{us / steps / 1e3:9.3f} ms/step  x{cnt[name] // steps:<5d}"
              f" [{categorize(name)}] {name[:70]}")
    ours = port_kernels([(k, us, cnt[k]) for k, us in tot.most_common()])
    if ours:
        print("\nport kernels (all instantiations):")
        for name, (us, n) in ours.items():
            print(f"{us / steps / 1e3:9.3f} ms/step  x{int(n) // steps:<5d}"
                  f" {name}")


def device_rows(prof, calls: int) -> List[Tuple[str, float, float]]:
    """(name, device ms per call, launches per call) of every device
    kernel in a torch.profiler profile, largest first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = e.cuda_time_total
        if dt:
            rows.append((e.key, dt / calls / 1e3, e.count / calls))
    return sorted(rows, key=lambda r: -r[1])


def port_kernels(rows) -> Dict[str, Tuple[float, float]]:
    """{kernel: (time, launches)} of the port's own kernels (csrc/, each
    in an anonymous namespace) among ``rows`` of (name, time, launches),
    summed over their template instantiations, in the order of their
    first row."""
    out = {}
    for key, ms, n in rows:
        if not is_port_kernel(key):
            continue
        name = port_kernel_name(key)
        ms0, n0 = out.get(name, (0.0, 0.0))
        out[name] = (ms0 + ms, n0 + n)
    return out
