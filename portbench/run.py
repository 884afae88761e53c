"""Runs one cell of the benchmark once, on the machine it is started on:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (weights, the traffic pool drawn
from the seed, the program, the warm-up at the cell's shapes) counts
into setup_s; then the window of --seconds; with --trace 1 a traced
slice follows it, which the per-layer metrics read. Then the program's
state is freed and what it answered is compared with the plain
reference. The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.

Exits 2 without enough CUDA devices, and 3 if the process holds a JAX
module when the run is over; neither prints a result.
"""

from __future__ import annotations

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from . import harness  # noqa: E402


def process_age() -> float:
    """Seconds since this process started, from /proc (0 without it)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)


AGE_AT_TOP = process_age()


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def traced(drv, path: str):
    """The driver's slice under torch.profiler, its chrome trace written
    to ``path`` and read back."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from .yardstick.trace import Trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(harness.SLICE):
            drv.slice()
            drv.sync()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return Trace(path, harness.SLICE)


def run_cell(bench: harness.Bench, name: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             fault: Optional[str] = None, traffic: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of cell ``name``; returns the result object. ``traffic``
    replaces the cell's mix and ``fault`` plants a driver's fault (the
    tests' hooks; the command line sets neither)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.workload(name)
    cfg = bench.config(cell["config"])
    mix = traffic or bench.traffic(cell["traffic"])
    drv = harness.driver_class(mix["driver"])(cfg, mix, seed, device,
                                              fault=fault)
    drv.limits = limits = bench.limits(name)
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_setup = time.perf_counter()
    drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t_start
    e2e = {**drv.window(seconds), "setup_s": setup_s}
    metrics = {}
    if not trace:
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        drv.trace = traced(drv, os.path.join(harness.OUT_DIR,
                                             f"trace-{name}.json"))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release()
    numbers = drv.check()
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": drv.attempted,
              "failed": int(drv.failed), "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        for m in bench.per_layer(name):
            value = harness.metric_reader(m["name"])(drv)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = drv.trace.busy_us() / 1e6
        dev["window_s"] = drv.trace.window_us / 1e6
        result["breakdown"] = {"device_ops": drv.trace.top_ops(10),
                               "idle_gaps": drv.trace.idle_gaps(10)}
    result["device"] = dev
    result["compared"] = compared
    result["info"] = {"setup_s": setup_s, "before_setup_s": t_setup - t_start,
                      "setup_phases_s": drv.phases, "window_s": drv.wall,
                      **{k: v for k, v in e2e.items() if k != "setup_s"}}
    if trace:
        result["info"]["device_by_category"] = drv.trace.by_category()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: {args.workload} needs {chips} CUDA device(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_TOP - AGE_AT_TOP)
    bad = harness.forbidden_loaded()
    if bad:
        log(f"portbench: the process holds {', '.join(bad)}; no result")
        return 3
    info = result.pop("info")
    log(f"portbench: {args.workload} seed {args.seed} on "
        f"{harness.power_limit()}: " + json.dumps(info))
    compared = result.pop("compared")
    result["compared"] = compared
    print(json.dumps(result), flush=True)
    for k, c in compared.items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
