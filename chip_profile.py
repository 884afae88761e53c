#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port's serving programs, on
one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_profile.py

For each program (serve b16 and b128 at 320x320, detect b1 at 320x320 and
640x640; yunet_n, r04 EMA weights, bf16, fused, device NMS; and one
training step of yunet_n at 640x640 b16 with the shipped config: bf16
trunk, streamed SimOTA kernel, from the same weights, on a seeded
synthetic face batch; and the same step with train.fused_kernels, every
ConvDPUnit through the fused forward and backward kernels) it runs 5
warm-up calls, then 20 calls under torch.profiler, then 20 calls without
it. It prints the wall time per call (profiled and unprofiled), the sum
of device kernel time per call, the busy share (device kernel time over
the profiled wall), the top device kernels and the port's own kernels
summed over their instantiations, and for the serving and detect
programs each image's NMS candidate count (the NMS kernel's work); it
writes the same to chiprun_out/chip_profile.json. The profiler slows the
host, so the busy share it gives is a lower bound for the unprofiled
program.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs

CALLS, WARMUP, TOP = 20, 5, 15
OUT = os.path.join(cs.ROOT, "chiprun_out", "chip_profile.json")


def device_rows(prof, calls):
    """(name, device ms per call, launches per call) of every device
    kernel in the profile, largest first."""
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


def port_kernels(rows):
    """{kernel: (device ms per call, launches per call)} of the port's own
    kernels (csrc/, each in an anonymous namespace), summed over their
    template instantiations."""
    out = {}
    for key, ms, n in rows:
        if "at::native" in key or "(anonymous namespace)::" not in key:
            continue
        name = key.split("(anonymous namespace)::")[1].split("<")[0]
        name = name.split("(")[0]
        ms0, n0 = out.get(name, (0.0, 0.0))
        out[name] = (ms0 + ms, n0 + n)
    return out


def profile_program(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / CALLS * 1e3
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / CALLS * 1e3
    rows = device_rows(prof, CALLS)
    if not rows:
        raise RuntimeError("the profile holds no device kernel time")
    busy = sum(r[1] for r in rows)
    return {"wall_ms_profiled": wall, "wall_ms_unprofiled": bare,
            "device_kernel_ms": busy, "busy_share": busy / wall,
            "top": rows[:TOP], "port_kernels": port_kernels(rows)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from yunet_tpu_torch.apis import init_detector
    import dataclasses
    from yunet_tpu_torch.config import validate_config, yunet_n
    from yunet_tpu_torch.train import init_train_state, make_train_step
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    smi = cs.nvidia_smi_line()
    det = init_detector("yunet_n", cs.FIXTURE, device=cs.DEV, fused=True)
    rng = np.random.RandomState(3)

    def batch(n, hw):
        return det._input([cs.face_image(rng, hw, hw, 4) for _ in range(n)])

    progs = {"serve_b16_320": (det.serve_packed, batch(16, 320), 750),
             "serve_b128_320": (det.serve_packed, batch(128, 320), 750),
             "detect_b1_320": (det.detect_packed, batch(1, 320), 5000),
             "detect_b1_640": (det.detect_packed, batch(1, 640), 5000)}
    # the NMS kernel's work: each image's candidate count (scores at or
    # above the threshold, at most K), which sets its serial steps
    nms_counts = {
        name: (det.raw(x, conv_kernel=fn == det.detect_packed)[0]
               >= det.cfg.test.score_thr).sum(1).clamp(max=k).tolist()
        for name, (fn, x, k) in progs.items()}
    progs = {name: (lambda f=fn, x=x, k=k: f(x, k))
             for name, (fn, x, k) in progs.items()}
    cfg = yunet_n()
    sd = state_dict_from_jax(*load_flat_npz(cs.FIXTURE, cfg.model))
    tb = cs._to_device(cs.train_batch(np.random.RandomState(6),
                                      cfg.data.samples_per_device,
                                      cfg.data.img_size))
    fused = validate_config(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fused_kernels=True)), force_experimental=True)
    for name, c in (("train_b16_640", cfg), ("train_fused_b16_640", fused)):
        ts, opt = init_train_state(
            c, steps_per_epoch=1000, total_batch=c.data.samples_per_device,
            device=cs.DEV, state_dict=sd)
        step = make_train_step(c, ts.model, opt, img_size=c.data.img_size)
        progs[name] = lambda st=step, t=ts: st(t, tb)
    out = {"device": smi, "calls": CALLS}
    for name, fn in progs.items():
        r = profile_program(fn)
        if name in nms_counts:
            r["nms_counts"] = nms_counts[name]
            cs.log(f"== {name}: NMS candidates an image {nms_counts[name]}")
        out[name] = r
        cs.log(f"== {name}: wall {r['wall_ms_profiled']:.4f} ms/call "
               f"profiled, {r['wall_ms_unprofiled']:.4f} unprofiled; device "
               f"kernels {r['device_kernel_ms']:.4f} ms/call; busy share "
               f"{r['busy_share']:.1%}")
        for key, ms, n in r["top"]:
            cs.log(f"   {ms:8.4f} ms x{n:6.1f}  {key[:90]}")
        cs.log("   the port's kernels, all instantiations: " + ", ".join(
            f"{k} {ms:.4f} ms x{n:.1f}"
            for k, (ms, n) in r["port_kernels"].items()))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
