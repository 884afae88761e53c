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
it. The WIDER sweeps (Detector.detect_sweep as the test_widerface CLI
drives it: yunet_n, r04 EMA weights, bf16, unfused, over chip_smoke.py's
64-image split from the decoded cache, mode 0 and mode 2, device and host
NMS) get 1 warm-up sweep, 2 profiled and 2 unprofiled. It prints the wall time per call (profiled and unprofiled), the sum
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
from yunet_tpu_torch.utils.trace_profile import device_rows, port_kernels

CALLS, WARMUP, TOP = 20, 5, 15
OUT = os.path.join(cs.ROOT, "chiprun_out", "chip_profile.json")


def profile_program(fn, calls=CALLS, warmup=WARMUP):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / calls * 1e3
    rows = device_rows(prof, calls)
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
    # the WIDER sweeps
    from yunet_tpu_torch.data.cache import load_cached
    from yunet_tpu_torch.data.labelv2 import parse_labelv2
    ann, cache, _ = cs.wider_split()
    entries = [((lambda r=r: load_cached(cache, r.filename)),
                (r.height, r.width))
               for r in parse_labelv2(ann, test_mode=True)]
    udet = init_detector("yunet_n", cs.FIXTURE, device=cs.DEV)
    sweeps = {}
    for mode, wmode in ((0, (640, 640)), (2, "ORIGIN")):
        for nms in ("device", "host"):
            sweeps[f"wider_mode{mode}_{nms}_nms"] = (
                lambda m=wmode, d=nms == "device": udet.detect_sweep(
                    entries, m, pad_divisor=32, use_device_nms=d))
    out = {"device": smi, "calls": CALLS}
    for name, fn in {**progs, **sweeps}.items():
        r = (profile_program(fn, calls=2, warmup=1) if name in sweeps
             else profile_program(fn))
        if name in sweeps:
            r["img_per_s_unprofiled"] = len(entries) / (
                r["wall_ms_unprofiled"] / 1e3)
            cs.log(f"== {name}: {r['img_per_s_unprofiled']:.2f} img/s "
                   "unprofiled")
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
