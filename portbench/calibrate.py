"""The readings that the limits of ``correct`` are set from, for one cell,
in one process:

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 \
        [--seconds 2] [--control] [--faults]

For each seed: the program's numbers after a short window at the cell's
own load (the lower readings); with --control, the reference computed in
float8 in the program's place (the upper readings); with --faults, the
program with each of its driver's faults planted. One JSON line a
reading on standard output and in portbench/out/calibrate-<name>.jsonl.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import harness


def reading(bench, name, seed, seconds, device, fault=None):
    cell = bench.workload(name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    drv = harness.driver_class(mix["driver"])(cfg, mix, seed, device,
                                              fault=fault)
    drv.limits = bench.limits(name)
    drv.setup()
    drv.window(seconds)
    drv.release()
    numbers = drv.check()
    return drv, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.Bench()
    os.makedirs(harness.OUT_DIR, exist_ok=True)
    path = os.path.join(harness.OUT_DIR, f"calibrate-{args.workload}.jsonl")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        with open(path, "a") as f:
            f.write(line + "\n")

    for seed in args.seeds:
        drv, numbers = reading(bench, args.workload, seed, args.seconds,
                               args.device)
        emit({"seed": seed, "kind": "program", **numbers,
              "distinct": drv.distinct})
        if args.control:
            emit({"seed": seed, "kind": "control", **drv.control()})
        del drv
        if args.faults:
            for fault in harness.driver_class(bench.traffic(
                    bench.workload(args.workload)["traffic"])["driver"]
                    ).faults:
                _, numbers = reading(bench, args.workload, seed,
                                     args.seconds, args.device, fault)
                emit({"seed": seed, "kind": f"fault:{fault}", **numbers})
    bad = harness.forbidden_loaded()
    if bad:
        print(f"calibrate: the process holds {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
