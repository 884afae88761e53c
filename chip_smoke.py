#!/usr/bin/env python3
"""Smoke test of the PyTorch port (yunet_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from yunet_tpu_torch/csrc/ (nvcc, sm_90a, all
at once), compares each kernel with its plain PyTorch version on the card
at the shapes its path gives it, drives the serving path (yunet_n at full
width, trained r04 EMA weights from tests/fixtures/r04_ema.npz) and the
training path (10 steps of yunet_n at 640^2 b16, bf16, from the same
weights, on seeded synthetic face batches) through the user entry points,
the same training path with train.fused_kernels (every ConvDPUnit through
the fused forward kernel and its hand-written backward) and the
channels-major ConvDP bench (yunet_tpu_torch.tools.bench_convdp_cm),
shows through the launch counters that each path ran its kernels, and
times kernels, their plain versions, library yardsticks and the paths
with CUDA events. Any failed check raises, and the script exits
non-zero. There is no CPU path: without a CUDA device it exits non-zero
before printing any result.

The last three lines of standard output are a JSON object of the kernels
({"kernels": [...]}), the card's name and power limit as nvidia-smi reports
them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
IOU, SCORE = 0.45, 0.02
DEV = "cuda"
MAX_GTS = 128          # DataConfig.max_gts
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 tensor-core FLOP/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, warmup=3, iters=10, windows=5) -> float:
    """Median over windows of the CUDA-event time per call (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def device_ms(fn, *, warmup=3, iters=20, windows=5):
    """(device ms, host ms) per call, medians over windows. A
    torch.cuda._sleep queued before the start event holds the card until
    the host has queued every timed call, so the events bracket
    back-to-back device work with no host gap in it; the host clock
    meanwhile times the issue of the calls. A window in which the sleep
    ended before the last call was queued is run again with a longer
    sleep."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    end.synchronize()
    cycles_per_ms = 10 ** 6 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    cycles = int(2e3 * (time.perf_counter() - t0) * cycles_per_ms) + 10 ** 6
    torch.cuda.synchronize()
    dev, host = [], []
    while len(dev) < windows:
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        late = start.query()
        end.record()
        end.synchronize()
        if late:
            if cycles > 10 ** 11:
                raise RuntimeError("device_ms: the host never got ahead "
                                   "of the card")
            cycles *= 2
            continue
        dev.append(start.elapsed_time(end) / iters)
        host.append((t1 - t0) * 1e3 / iters)
    return statistics.median(dev), statistics.median(host)


# -- inputs ----------------------------------------------------------------

def clustered_boxes(rng, n, size):
    """(n, 4) xyxy boxes in clusters, so that many pairs overlap."""
    centers = rng.uniform(20, size - 20, (max(n // 8, 1), 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 8, (n, 2))
    wh = rng.uniform(8, 80, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def face_sample(rng, h, w, n_faces):
    """A noisy background with simple face renders (skin-tone ellipse,
    dark eyes, mouth), drawn with numpy in the style of
    tools/make_synth_wider.py, on which the r04 weights were trained.
    Returns (image (h, w, 3) uint8, boxes (n, 4) xyxy, keypoints (n, 5, 3):
    eyes, nose, mouth corners, visibility 1). Each face is drawn inside
    its own window, with the same pixels as a whole-image draw."""
    img = rng.randint(40, 200, (h, w, 3)).astype(np.float32)
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    boxes, kps = [], []
    for _ in range(n_faces):
        s = rng.uniform(24, min(h, w) / 3)
        cx, cy = rng.uniform(s, w - s), rng.uniform(s, h - s)
        y0, y1 = max(int(cy - 0.6 * s) - 2, 0), min(int(cy + 0.6 * s) + 3, h)
        x0, x1 = max(int(cx - 0.5 * s) - 2, 0), min(int(cx + 0.5 * s) + 3, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        win = img[y0:y1, x0:x1]
        face = ((xx - cx) / (0.40 * s)) ** 2 + ((yy - cy) / (0.50 * s)) ** 2
        win[face <= 1] = (rng.randint(90, 160), rng.randint(120, 190),
                          rng.randint(170, 240))
        for ex in (-0.18, 0.18):
            eye = (xx - cx - ex * s) ** 2 + (yy - cy + 0.13 * s) ** 2
            win[eye <= (0.07 * s) ** 2] = 30
        mouth = (np.abs(yy - cy - 0.27 * s) <= max(0.03 * s, 1)) & \
            (np.abs(xx - cx) <= 0.14 * s)
        win[mouth] = (40, 40, 120)
        boxes.append((cx - 0.4 * s, cy - 0.5 * s, cx + 0.4 * s, cy + 0.5 * s))
        kps.append([(cx - 0.18 * s, cy - 0.13 * s, 1.0),
                    (cx + 0.18 * s, cy - 0.13 * s, 1.0),
                    (cx, cy + 0.07 * s, 1.0),
                    (cx - 0.14 * s, cy + 0.27 * s, 1.0),
                    (cx + 0.14 * s, cy + 0.27 * s, 1.0)])
    return (np.clip(img, 0, 255).astype(np.uint8),
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(kps, np.float32).reshape(-1, 5, 3))


def face_image(rng, h, w, n_faces):
    return face_sample(rng, h, w, n_faces)[0]


def train_batch(rng, bsz, hw, *, empty=(), clustered=()):
    """A training batch in the JAX layout: bsz face images at hw x hw
    with 3-40 faces each, padded to MAX_GTS slots. Images in ``empty``
    have no valid GT; the GTs of images in ``clustered`` are 24 heavily
    overlapping boxes around two points (their priors fall in several GTs'
    candidate sets at once: multi-matches)."""
    imgs = np.zeros((bsz, hw, hw, 3), np.uint8)
    gtb = np.zeros((bsz, MAX_GTS, 4), np.float32)
    gtk = np.zeros((bsz, MAX_GTS, 5, 3), np.float32)
    gtv = np.zeros((bsz, MAX_GTS), bool)
    for i in range(bsz):
        imgs[i], boxes, kps = face_sample(rng, hw, hw, rng.randint(3, 41))
        if i in clustered:
            c = rng.uniform(100, hw - 100, (2, 2))[rng.randint(0, 2, 24)]
            c = c + rng.normal(0, 3, (24, 2))
            wh = rng.uniform(40, 60, (24, 2))
            boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
            kps = np.concatenate([np.repeat(c[:, None], 5, 1),
                                  np.ones((24, 5, 1))], -1)
        n = len(boxes)
        gtb[i, :n], gtk[i, :n] = boxes, kps
        gtv[i, :n] = i not in empty
    return {"image": imgs, "gt_bboxes": gtb,
            "gt_labels": np.zeros((bsz, MAX_GTS), np.int32),
            "gt_kps": gtk, "gt_valid": gtv}


def convdp_unit_shapes(folded, cfg, h, w):
    """(name, H, W, unit) of every ConvDPUnit in fused_forward's order."""
    bb = folded["backbone"]
    h, w = h // 2, w // 2
    units = [("stem_dp", h, w, bb["stem_dp"])]
    levels = []
    for i in range(len(cfg.stage_channels)):
        if i > 0:
            units += [(f"m{i}a", h, w, bb[f"m{i}a"]),
                      (f"m{i}b", h, w, bb[f"m{i}b"])]
        if i in cfg.out_idx:
            levels.append((h, w))
        if i in cfg.downsample_idx:
            h, w = h // 2, w // 2
    for lvl, (lh, lw) in enumerate(levels):
        units.append((f"neck{lvl}", lh, lw, folded["neck"][str(lvl)]))
        d = folded["head"][str(lvl)]
        units += [(f"share{lvl}", lh, lw, u) for u in d.get("share", [])]
        units += [(f"{k}{lvl}", lh, lw, u) for k, u in d.items()
                  if k != "share"]
    return units


def plain_nms_batched(boxes, scores, top_k, score_thr=SCORE):
    """device_nms_batched with the plain suppression loop in place of the
    kernel, on the same device."""
    import torch
    from yunet_tpu_torch.ops.nms import greedy_nms_keep_plain, topk_candidates
    top_boxes, top_scores, idx, counts = topk_candidates(
        boxes, scores, top_k, score_thr)
    keep = greedy_nms_keep_plain(top_boxes.contiguous(), counts, IOU)
    return torch.cat([top_boxes, top_scores[..., None]], dim=-1), keep, idx


def plain_packed(det, x, top_k):
    """The device work of Detector.serve_packed (library convs, decode,
    top-k, suppression, row gather) with the plain suppression loop."""
    import torch
    scores, boxes, kps = det.raw(x, conv_kernel=False)
    dets, keep, idx = plain_nms_batched(boxes, scores, top_k)
    kps_sel = torch.gather(kps, 1, idx[..., None].expand(
        *idx.shape, kps.shape[-1]))
    return torch.cat([dets, keep[..., None].to(dets.dtype), kps_sel], dim=-1)


# -- phases ----------------------------------------------------------------

def phase_build(libs=None):
    """Build every native source (or those of ``libs``, name -> NativeLib)
    at once, one compiler process each."""
    from concurrent.futures import ThreadPoolExecutor
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import (convdp, convdp_cm, convdp_train, nms,
                                     simota)
    libs = libs or {"convdp.cu": convdp.LIB, "nms.cu": nms.LIB,
                    "simota.cu": simota.LIB,
                    "convdp_bwd.cu": convdp_train.LIB,
                    "convdp_cm.cu": convdp_cm.LIB,
                    "host_nms.cpp": native.LIB}

    def build(lib):
        t0 = time.perf_counter()
        lib.get()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(build, lib) for name, lib in libs.items()}
        secs = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        log(f"[build] {name}: {secs[name]:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"        {line.strip()}")


def _counted():
    from yunet_tpu_torch.ops.convdp import fused_conv_dp
    from yunet_tpu_torch.ops.convdp_cm import fused_conv_dp_cm
    from yunet_tpu_torch.ops.convdp_train import fused_pw_dw_bwd
    from yunet_tpu_torch.ops.nms import greedy_nms_keep
    from yunet_tpu_torch.ops.simota import streamed_simota
    return {"fused_conv_dp": fused_conv_dp, "greedy_nms": greedy_nms_keep,
            "simota_streamed": streamed_simota,
            "convdp_bwd": fused_pw_dw_bwd, "convdp_cm": fused_conv_dp_cm}


# the kernels with a bf16 (tensor-core) route, counted apart as well
MMA_ROUTES = ("fused_conv_dp", "convdp_bwd", "convdp_cm")


def reset_launch_counts():
    for fn in _counted().values():
        fn.launches = 0
    for name in MMA_ROUTES:
        _counted()[name].launches_mma = 0


def launch_counts():
    counts = {name: fn.launches for name, fn in _counted().items()}
    for name in MMA_ROUTES:
        counts[f"{name}_mma"] = _counted()[name].launches_mma
    return counts


def bound_ms(nbytes, ops, peak):
    """The least time for the work on an H100: the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_nms():
    """The NMS kernel against its plain version: keep sets exactly equal."""
    import torch
    from yunet_tpu_torch.ops.nms import (device_nms, device_nms_batched,
                                         greedy_nms_keep,
                                         greedy_nms_keep_plain)
    rng = np.random.RandomState(0)
    cases = [(b, k) for b in (1, 16, 128)
             for k in (0, 1, 12, 60, 512, 750)] + [(1, 5000)]
    max_err = 0.0
    for bsz, k in cases:
        p, top_k = (8400, 5000) if k > 750 else (2100, 750)
        boxes = np.stack([clustered_boxes(rng, p, 320 if p == 2100 else 640)
                          for _ in range(bsz)])
        scores = rng.uniform(0, 0.01, (bsz, p)).astype(np.float32)
        for b in range(bsz):
            cnt = k if b == 0 else rng.randint(0, k + 1)
            scores[b, rng.choice(p, cnt, replace=False)] = \
                rng.uniform(0.05, 1.0, cnt)
        bt = torch.from_numpy(boxes).to(DEV)
        st = torch.from_numpy(scores).to(DEV)
        got = device_nms_batched(bt, st, top_k=top_k, iou_thr=IOU,
                                 score_thr=SCORE)
        want = plain_nms_batched(bt, st, top_k)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("dets", "keep", "idx")):
            if g.numel():
                max_err = max(max_err, float(
                    (g.double() - w.double()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"NMS kernel != plain ({what}) at "
                                     f"B={bsz} k={k}")
        if bsz == 1:                             # the per-image entry
            one = device_nms(bt[0], st[0], top_k=top_k)
            if not torch.equal(one[1], want[1][0]):
                raise AssertionError(f"per-image NMS != plain at k={k}")
        log(f"[nms] B={bsz:3d} k={k:4d} K={top_k}: keep sets equal "
            f"({int(want[1].sum())} kept)")
    # time the suppression step at serving shapes: 16 images x 750,
    # 300 candidates an image; and one 640^2 image x 5000, all valid
    times = {}
    for bsz, kk, cnt in ((16, 750, 300), (128, 750, 300), (1, 5000, 5000)):
        boxes = torch.from_numpy(np.stack([
            clustered_boxes(rng, kk, 320) for _ in range(bsz)])).to(DEV)
        counts = torch.full((bsz,), cnt, dtype=torch.int32, device=DEV)
        ms = cuda_ms(lambda: greedy_nms_keep(boxes, counts, IOU))
        plain = cuda_ms(lambda: greedy_nms_keep_plain(boxes, counts, IOU),
                        warmup=1, iters=2, windows=3)
        # the bound: boxes and counts read, keep written; the IoU work
        # this data needs, ~14 f32 operations for each pair (i, j > i)
        # with i kept, j a candidate
        keep = greedy_nms_keep_plain(boxes, counts, IOU)[:, :cnt]
        pairs = int((keep * (cnt - 1 - torch.arange(cnt, device=DEV))).sum())
        bnd, by = bound_ms(boxes.numel() * 4 + bsz * 4 + bsz * kk,
                           14 * pairs, F32_FLOPS)
        times[f"b{bsz}_k{kk}_n{cnt}"] = {"ms": ms, "plain_ms": plain,
                                         "bound_ms": bnd, "bound_by": by}
        log(f"[nms] time B={bsz} K={kk} n={cnt}: kernel {ms:.4f} ms, "
            f"plain {plain:.2f} ms, bound {bnd:.6f} ms ({by}; {pairs} "
            "IoU pairs)")
    return max_err, times["b16_k750_n300"]


def _convdp_unit_times(x, w1, b1, wd, bd, relu, **timing):
    """(kernel ms, plain ms, library pair ms, bytes, operations) of one bf16
    ConvDPUnit call. The library pair is F.conv2d 1x1 then the depthwise
    F.conv2d, bf16, on the same memory as an NCHW channels-last view. The
    bytes: bf16 activations in and out, f32 weights; the operations: the
    pointwise and depthwise multiply-adds (taken at the bf16 tensor-core
    peak)."""
    import torch
    import torch.nn.functional as F
    from yunet_tpu_torch.ops.convdp import fused_conv_dp, fused_conv_dp_plain
    n, h, w, cin = x.shape
    cout = w1.shape[-1]
    ms = cuda_ms(lambda: fused_conv_dp(x, w1, b1, wd, bd, relu=relu),
                 **timing)
    pms = cuda_ms(lambda: fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu),
                  **timing)
    lw = (w1.reshape(cin, cout).t().reshape(cout, cin, 1, 1)
          .to(torch.bfloat16), b1.to(torch.bfloat16),
          wd.reshape(9, cout).t().reshape(cout, 1, 3, 3).to(torch.bfloat16),
          bd.to(torch.bfloat16))
    xl = x.permute(0, 3, 1, 2)

    def library():
        y = F.conv2d(F.conv2d(xl, lw[0], lw[1]), lw[2], lw[3], padding=1,
                     groups=cout)
        return F.relu(y) if relu else y
    lms = cuda_ms(library, **timing)
    return (ms, pms, lms, n * h * w * (cin + cout) * 2
            + (cin * cout + 11 * cout) * 4, 2 * n * h * w * cout * (cin + 10))


def _check_convdp_bf16(label, x, w1, b1, wd, bd, relu):
    """One bf16 ConvDP kernel call against its plain version: bf16_excess
    within BF16_EXCESS_LIMIT; on the tensor-core route (its counter rises
    by one) where the channels allow; a second call bit-equal. Returns
    (excess, elements more than one bf16 ulp off)."""
    import torch
    from yunet_tpu_torch.ops.convdp import (BF16_EXCESS_LIMIT, bf16_excess,
                                            fused_conv_dp,
                                            fused_conv_dp_plain, ulp_bf16)
    before = fused_conv_dp.launches_mma
    got = fused_conv_dp(x, w1, b1, wd, bd, relu=relu)
    if fused_conv_dp.launches_mma != before + int(max(w1.shape) <= 64):
        raise AssertionError(f"ConvDP {label} bf16: not on the tensor-core "
                             "route")
    again = fused_conv_dp(x, w1, b1, wd, bd, relu=relu)
    want = fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"ConvDP {label} bf16: two calls differ")
    excess = bf16_excess(got, want, x, w1, b1, wd)
    g, t = got.float(), want.float()
    over = int(((g - t).abs() > ulp_bf16(torch.maximum(g.abs(), t.abs())))
               .sum())
    if not excess <= BF16_EXCESS_LIMIT:
        raise AssertionError(f"ConvDP kernel != plain (bf16) at {label}: "
                             f"excess {excess} units of 2^-24 S (limit "
                             f"{BF16_EXCESS_LIMIT}), {over} elements over "
                             "one ulp")
    return excess, over


def phase_convdp(folded, cfg, bsz=16):
    """The ConvDP kernel against its plain version at every unit shape of
    yunet_n's b1 fused forward at 320^2 and 640^2, plus ragged 37x45 and
    Cin=3, and at the 29 units of the fused train step's forward (640^2
    b16). f32 (the scalar route) within rtol/atol 1e-5. bf16 (the
    tensor-core route) within one bf16 ulp of the output plus 2^-23 * S
    (bf16_excess <= 2): its sums are f32 sums in another order than the
    plain version's, which moves an output that cancels to near zero by
    many of its own ulps, so one ulp alone held only the scalar kernel,
    whose order happened to round as cuDNN's. Every bf16 call on the
    tensor-core route, and a second call bit-equal. Times the 640^2 units
    in bf16, at b1 and at b16: the kernel, its plain version and the
    library pair, with the bound of each unit, summed."""
    import torch
    from yunet_tpu_torch.ops.convdp import fused_conv_dp, fused_conv_dp_plain
    rng = np.random.RandomState(1)
    cases = []
    for hw in (320, 640):
        for name, h, w, u in convdp_unit_shapes(folded, cfg, hw, hw):
            cases.append((f"{hw}:{name}", 1, h, w, u.w1, u.b1, u.wd, u.bd,
                          u.relu))
    for n, h, w, ci, co in ((2, 37, 45, 16, 64), (1, 33, 64, 3, 16)):
        r = [torch.from_numpy(a).to(DEV) for a in (
            rng.randn(ci, co).astype(np.float32) * 0.2,
            rng.randn(co).astype(np.float32) * 0.2,
            rng.randn(9, co).astype(np.float32) * 0.2,
            rng.randn(co).astype(np.float32) * 0.2)]
        cases += [(f"{h}x{w}:{ci}->{co}:relu{int(relu)}", n, h, w, *r, relu)
                  for relu in (True, False)]
    worst = {"f32": 0.0, "bf16_excess": 0.0}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")

    def add(tot, ms, pms, lms, nbytes, ops):
        for k, v in zip(keys, (ms, pms, lms,
                               bound_ms(nbytes, ops, BF16_FLOPS)[0])):
            tot[k] += v
        tot["bytes_ms"] += nbytes / HBM_BPS * 1e3
        tot["ops_ms"] += ops / BF16_FLOPS * 1e3

    def summed(tot, what):
        by = "bytes" if tot.pop("bytes_ms") >= tot.pop("ops_ms") else \
            "operations"
        log(f"[convdp] {what} bf16, all units: kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, library pair "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.6f} ms "
            f"({by})")
        return {**tot, "bound_by": by}

    b1_tot = dict.fromkeys(keys + ("bytes_ms", "ops_ms"), 0.0)
    seen = set()
    for name, n, h, w, w1, b1, wd, bd, relu in cases:
        x = torch.from_numpy(rng.uniform(0, 3, (n, h, w, w1.shape[0]))
                             .astype(np.float32)).to(DEV)
        got = fused_conv_dp(x, w1, b1, wd, bd, relu=relu)
        want = fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"ConvDP kernel != plain (f32) at {name}: "
                                 f"max abs err {err} (rtol/atol 1e-5)")
        xb = x.to(torch.bfloat16)
        excess, over = _check_convdp_bf16(name, xb, w1, b1, wd, bd, relu)
        worst["f32"] = max(worst["f32"], err)
        worst["bf16_excess"] = max(worst["bf16_excess"], excess)
        if name.startswith("640:"):
            # the serving path's shapes: one 640^2 b1 forward's units
            t = _convdp_unit_times(xb, w1, b1, wd, bd, relu)
            add(b1_tot, *t)
            cin, cout = w1.shape[-2], w1.shape[-1]
            if (h, w, cin, cout) not in seen:
                seen.add((h, w, cin, cout))
                log(f"[convdp] time {name} {h}x{w} {cin}->{cout} bf16: "
                    f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, library "
                    f"{t[2]:.4f} ms, bound "
                    f"{bound_ms(t[3], t[4], BF16_FLOPS)[0]:.6f} ms")
        log(f"[convdp] {name} N={n} {h}x{w} {w1.shape[0]}->{w1.shape[1]}: "
            f"f32 err {err:.2e}, bf16 excess {excess:.3f} of 2^-24 S, "
            f"{over} elements over one ulp")
    b1_tot = summed(b1_tot, "640^2 b1")

    # the fused train step's forward: its 29 units at 640^2 b16, x drawn
    # on the card
    gen = torch.Generator(device=DEV).manual_seed(8)
    b16_tot = dict.fromkeys(keys + ("bytes_ms", "ops_ms"), 0.0)
    for name, h, w, u in convdp_unit_shapes(folded, cfg, 640, 640):
        cin, cout = u.w1.shape
        x = (torch.rand((bsz, h, w, cin), generator=gen, device=DEV) * 3).to(
            torch.bfloat16)
        excess, over = _check_convdp_bf16(f"b{bsz} {name}", x, u.w1, u.b1,
                                          u.wd, u.bd, u.relu)
        worst["bf16_excess"] = max(worst["bf16_excess"], excess)
        t = _convdp_unit_times(x, u.w1, u.b1, u.wd, u.bd, u.relu, warmup=2,
                               iters=5, windows=3)
        add(b16_tot, *t)
        log(f"[convdp] b{bsz} {name} {h}x{w} {cin}->{cout}: kernel "
            f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, library {t[2]:.4f} ms, "
            f"bound {bound_ms(t[3], t[4], BF16_FLOPS)[0]:.6f} ms; bf16 "
            f"excess {excess:.3f}, {over} elements over one ulp")
        del x
    b16_tot = summed(b16_tot, f"640^2 b{bsz}")
    log(f"[convdp] worst: f32 abs err {worst['f32']:.3e} (rtol/atol 1e-5); "
        f"bf16 excess {worst['bf16_excess']:.3f} units of 2^-24 S (limit 2)"
        "; every bf16 call on the tensor-core route, repeats bit-equal")
    return worst, {**b1_tot, f"b{bsz}_640": b16_tot}


def convdp_only():
    """phase_convdp alone, for quick work on the forward kernel:
    python3 -c "import chip_smoke as s; s.convdp_only()" from the
    repository root. Builds only convdp.cu."""
    import torch
    from yunet_tpu_torch.ops import convdp
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)} | {nvidia_smi_line()}")
    cfg, _, _, folded = load_model()
    phase_build({"convdp.cu": convdp.LIB})
    phase_convdp(folded, cfg)


def _pair(ba, bb, *, atol, rtol, score_atol):
    """Each box of ``ba`` pairs one to one with the box of ``bb`` it
    overlaps most, corners within atol + rtol*|corner|, scores within
    score_atol. Pairing, not position: two detections whose scores are
    close can swap places in the score order."""
    lt = np.maximum(ba[:, None, :2], bb[None, :, :2])
    rb = np.minimum(ba[:, None, 2:4], bb[None, :, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda x: np.prod(x[:, 2:4] - x[:, :2], axis=-1)  # noqa: E731
    iou = inter / (area(ba)[:, None] + area(bb)[None] - inter)
    pair = iou.argmax(1) if len(ba) else np.zeros(0, int)
    if len(set(pair.tolist())) != len(pair):
        raise AssertionError("detections do not pair one to one")
    np.testing.assert_allclose(ba[:, :4], bb[pair, :4], rtol=rtol, atol=atol)
    np.testing.assert_allclose(ba[:, 4], bb[pair, 4], atol=score_atol)


def _match(a, b, *, atol, rtol, score_atol, min_score=None):
    """min_score=None: the same detection count, and all pair. Else every
    detection scoring at least min_score in either result pairs with one
    of the other (for two bf16 trunks that round at different places, where
    a detection near the score threshold may fall on either side)."""
    ba, bb = a["bboxes"], b["bboxes"]
    if min_score is None:
        if ba.shape != bb.shape:
            raise AssertionError(f"detection counts differ: {ba.shape} vs "
                                 f"{bb.shape}")
        _pair(ba, bb, atol=atol, rtol=rtol, score_atol=score_atol)
        return
    _pair(ba[ba[:, 4] >= min_score], bb, atol=atol, rtol=rtol,
          score_atol=score_atol)
    _pair(bb[bb[:, 4] >= min_score], ba, atol=atol, rtol=rtol,
          score_atol=score_atol)


def phase_slice():
    """The serving path end to end, through the user entry points."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.apis import init_detector
    from yunet_tpu_torch.eval.detect import Detector
    from yunet_tpu_torch.ops.nms import device_nms_batched

    rng = np.random.RandomState(2)
    imgs = [face_image(rng, 320, 320, rng.randint(2, 7)) for _ in range(16)]
    img640 = face_image(rng, 640, 640, 8)
    det = init_detector("yunet_n", FIXTURE, device=DEV)

    # the serving path, with the launch counters from zero
    reset_launch_counts()
    batch = det.detect_batch(imgs, "AUTO", use_device_nms=True)
    fdet = Detector(det.cfg, det.model, device=DEV, fused=True)
    single = fdet.detect(img640, use_device_nms=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[slice] launches on the serving path: {launches}")
    for name in ("fused_conv_dp", "greedy_nms"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main path")
    # the fused bf16 detect: its 29 units, all on the tensor-core route
    if launches["fused_conv_dp"] != 29 or launches["fused_conv_dp_mma"] != 29:
        raise AssertionError(f"fused detect launches {launches}, want 29 "
                             "ConvDP launches, all on the bf16 route")
    counts = [r["bboxes"].shape[0] for r in batch]
    log(f"[slice] detect_batch b16 320^2: detections per image {counts}, "
        f"saturated {det.last_devnms_saturated}")
    if sum(counts) == 0 or det.last_devnms_saturated:
        raise AssertionError("detect_batch found no faces or saturated")
    for r in batch + [single]:
        for v in r.values():
            if not np.all(np.isfinite(v)):
                raise AssertionError("non-finite detection output")

    # keep sets against the host NMS on the same raw outputs, at the
    # configured threshold and at one that lets ~300 candidates through
    x = det._input(imgs)
    scores, boxes, _ = det.raw(x, conv_kernel=False)
    s_np, b_np = scores.cpu().numpy(), boxes.cpu().numpy()
    thr300 = float(np.mean(np.sort(s_np, axis=1)[:, -300]))
    for thr in (SCORE, thr300):
        _, keep, idx = device_nms_batched(boxes, scores, top_k=750,
                                          iou_thr=IOU, score_thr=thr)
        keep, idx = keep.cpu().numpy(), idx.cpu().numpy()
        n_cand = (s_np >= thr).sum(1)
        if n_cand.max() > 750:
            raise AssertionError("candidate count above the 750 cap")
        for i in range(len(imgs)):
            valid = s_np[i] >= thr
            host = np.flatnonzero(valid)[native.nms(
                b_np[i][valid], s_np[i][valid], IOU)]
            if not np.array_equal(host, idx[i][keep[i]]):
                raise AssertionError(f"device keep != host NMS, image {i}, "
                                     f"thr {thr}")
        log(f"[slice] device NMS == host NMS at score_thr {thr:.4g} "
            f"(candidates/image {int(n_cand.min())}-{int(n_cand.max())}, "
            f"kept {int(keep.sum())})")
        if thr == SCORE and keep.sum(1).tolist() != counts:
            raise AssertionError(f"detect_batch kept {counts}, the same "
                                 f"raw outputs keep {keep.sum(1).tolist()}")

    # fused (ConvDP kernel) detect at 640^2 b1 against the unfused
    # detector: in f32 the same detections (sums in another order); in
    # bf16 the unfused trunk rounds each unit's pointwise result to bf16
    # where the kernel keeps it f32, so detections near the score
    # threshold may differ and scores move by a few hundredths. A bf16
    # check for the same count failed on an H100 for that reason (33 vs 34
    # detections, the odd one scoring under 0.1), so bf16 pairs only the
    # detections scoring 0.1 or more; f32 keeps the same-count check, and
    # phase_convdp holds each unit to its plain version (bf16_excess)
    ref = det.detect(img640, use_device_nms=True)
    log(f"[slice] detect 640^2 b1 bf16: fused {single['bboxes'].shape[0]} "
        f"/ unfused {ref['bboxes'].shape[0]} detections")
    if ref["bboxes"].shape[0] == 0:
        raise AssertionError("no faces found at 640^2")
    _match(single, ref, atol=2.0, rtol=2e-2, score_atol=0.05,
           min_score=0.1)
    f32 = [Detector(det.cfg, det.model, device=DEV, dtype=torch.float32,
                    fused=fused).detect(img640, use_device_nms=True)
           for fused in (True, False)]
    log(f"[slice] detect 640^2 b1 f32: fused {f32[0]['bboxes'].shape[0]} "
        f"/ unfused {f32[1]['bboxes'].shape[0]} detections")
    _match(*f32, atol=1e-2, rtol=1e-4, score_atol=1e-4)
    return det, fdet, launches


def phase_times(fdet):
    """End-to-end device times with CUDA events: the serving program at
    b16/b128 (kernel NMS vs plain NMS) and b1 detect (ConvDP kernel and
    NMS kernel vs the library convs and the plain NMS). Kernel and plain
    alternate: kernel, plain, plain, kernel."""
    import torch
    rng = np.random.RandomState(3)
    out = {}
    for bsz in (16, 128):
        x = fdet._input([face_image(rng, 320, 320, 4) for _ in range(bsz)])
        progs = {"kernel_nms": lambda: fdet.serve_packed(x, 750),
                 "plain_nms": lambda: plain_packed(fdet, x, 750)}
        for which in ("kernel_nms", "plain_nms", "plain_nms", "kernel_nms"):
            out.setdefault(f"serve_b{bsz}_{which}", []).append(
                cuda_ms(progs[which]))
    for hw in (320, 640):
        x = fdet._input([face_image(rng, hw, hw, 4)])
        progs = {
            "forward_b1_{}_kernel_convdp": lambda: fdet.raw(
                x, conv_kernel=True),
            "forward_b1_{}_plain_convdp": lambda: fdet.raw(
                x, conv_kernel=False),
            "detect_b1_{}_kernel": lambda: fdet.detect_packed(x, 5000),
            "detect_b1_{}_plain": lambda: plain_packed(fdet, x, 5000)}
        for which in ("kernel", "plain", "plain", "kernel"):
            for key, fn in progs.items():
                if f"_{which}" in key:
                    out.setdefault(key.format(hw), []).append(cuda_ms(fn))
    for key, v in out.items():
        extra = ""
        if key.startswith("serve_b"):
            bsz = int(key.split("_")[1][1:])
            extra = f" ({bsz / (min(v) / 1000):.0f} img/s at the best)"
        log(f"[time] {key}: {v[0]:.4f} / {v[1]:.4f} ms{extra}")
    torch.cuda.synchronize()


def _to_device(batch):
    import torch
    return {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}


def train_priors(cfg, hw):
    """The (P, 4) prior table at hw x hw and its +0.5*stride offset copy,
    which the assignment takes."""
    import torch
    from yunet_tpu_torch.ops.priors import grid_priors
    priors = torch.from_numpy(grid_priors(
        [(hw // s, hw // s) for s in cfg.strides], cfg.strides,
        cfg.prior_offset)).to(DEV)
    return priors, torch.cat([priors[:, :2] + priors[:, 2:] * 0.5,
                              priors[:, 2:]], dim=-1)


def simota_inputs(model, batch, priors, offset):
    """The streamed SimOTA's inputs from the model's own eval forward (f32)
    on a training batch: fused scores (B, P), offset priors, decoded boxes,
    GT rows, the label-0 one-hot column and the validity mask."""
    import torch
    from yunet_tpu_torch.ops.boxes import bbox_decode, fuse_score
    with torch.inference_mode():
        flat = model.forward_flat(
            batch["image"].float().permute(0, 3, 1, 2).contiguous())
    scores = fuse_score(flat["cls"][..., 0].float(),
                        flat["obj"][..., 0].float())
    return (scores.contiguous(), offset,
            bbox_decode(priors, flat["bbox"].float()).contiguous(),
            batch["gt_bboxes"], (batch["gt_labels"] == 0).float(),
            batch["gt_valid"])


def tie_heavy_inputs(ins, seed=7):
    """Three images of SimOTA inputs, made from the first three of ins,
    where ties and short candidate lists are the rule: image 0 with all
    MAX_GTS slots live (clustered boxes, many overlapping), image 1 with
    one score and one decoded box for every prior (a box near its first
    GT, so every valid prior ties with every other on IoU and class
    cost), image 2 with 2-6 px GTs, too small to hold k priors in box
    and centre alike (their costs tie in the INF tier)."""
    import torch
    rng = np.random.RandomState(seed)
    scores, offset, decoded, gtb, onehot, gv = (
        t if t is ins[1] else t[:3].clone() for t in ins)
    gtb[0] = torch.from_numpy(clustered_boxes(rng, MAX_GTS, 640))
    gv[0] = True
    onehot[0] = 1.0
    if not gv[1].any():
        raise AssertionError("tie_heavy_inputs: image 1 has no GT")
    scores[1] = 0.3
    decoded[1] = gtb[1, 0] + torch.tensor([2.0, -1.0, 3.0, 1.5],
                                          device=DEV)
    n = int(gv[2].sum())
    c = rng.uniform(20, 620, (n, 2))
    wh = rng.uniform(2, 6, (n, 2))
    gtb[2, :n] = torch.from_numpy(np.concatenate(
        [c - wh / 2, c + wh / 2], -1).astype(np.float32))
    return scores, offset, decoded, gtb, onehot, gv


def _check_simota(label, ins):
    """streamed_simota's four outputs EQUAL to the plain version's, and
    the assignment assembled from them against the dense sim_ota_assign
    on the card (fg_mask and matched_gt equal, matched_iou within 1e-6).
    Returns the outputs and topk_iou's largest difference."""
    import torch
    from yunet_tpu_torch.ops.assign import (assemble_streamed,
                                            sim_ota_assign_batched)
    from yunet_tpu_torch.ops.simota import (streamed_simota,
                                            streamed_simota_plain)
    got = streamed_simota(*ins)
    want = streamed_simota_plain(*ins)
    torch.cuda.synchronize()
    for name, g, w in zip(got._fields, got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"SimOTA kernel != plain ({label}, {name}):"
                                 f" {bad} elements differ")
    iou_err = float((got.topk_iou - want.topk_iou).abs().max())
    scores, offset, decoded, gtb, _, gv = ins
    res = assemble_streamed(got.valid_prior, got.best_gt, got.cand_idx,
                            got.topk_iou, gtb, gv, decoded)
    dense = sim_ota_assign_batched(
        scores[..., None], offset, decoded, gtb,
        torch.zeros(gv.shape, dtype=torch.int32, device=DEV), gv,
        use_streamed=False)
    if not (torch.equal(res.fg_mask, dense.fg_mask)
            and torch.equal(res.matched_gt, dense.matched_gt)):
        raise AssertionError(f"streamed assignment != dense sim_ota_assign "
                             f"({label})")
    miou = float((res.matched_iou - dense.matched_iou).abs().max())
    if miou > 1e-6:
        raise AssertionError(f"matched_iou differs by {miou} ({label})")
    log(f"[simota] {label}: kernel == plain (valid GTs per image "
        f"{gv.sum(1).tolist()}, valid priors {int(got.valid_prior.sum())});"
        f" assembled == dense sim_ota_assign ({int(res.fg_mask.sum())} "
        f"positives, matched_iou max abs diff {miou})")
    return got, iou_err


def simota_entry_points(lib, ins, k=10):
    """The two entry points of a SimOTA library (any build of a simota.cu
    with this C interface) as closures over ins, with the assigner's
    default constants and outputs allocated once: for timing each launch
    alone. valid_best runs once here, so topk has its input. Returns
    (valid_best, topk, outputs)."""
    import torch
    from yunet_tpu_torch.ops._build import check_cuda_status
    scores, _, _, gtb, _, gv = ins
    (b, p), g = scores.shape, gtb.shape[1]
    outs = (torch.empty((b, p), dtype=torch.bool, device=DEV),
            torch.empty((b, p), dtype=torch.int32, device=DEV),
            torch.empty((b, g, k), dtype=torch.int32, device=DEV),
            torch.empty((b, g, k), dtype=torch.float32, device=DEV))
    valid, best, cand, topk = (t.data_ptr() for t in outs)
    ptrs = [t.data_ptr() for t in ins[:5]] + [
        gv.view(torch.uint8).data_ptr()]
    consts = (2.5, 3.0, 1.0, 1e-7)
    stream = torch.cuda.current_stream().cuda_stream

    def valid_best():
        check_cuda_status(lib, lib.yunet_simota_valid_best(
            *ptrs, b, p, g, *consts, valid, best, stream), "valid_best")

    def topk_():
        check_cuda_status(lib, lib.yunet_simota_topk(
            *ptrs, valid, b, p, g, k, *consts, cand, topk, stream), "topk")

    valid_best()
    return valid_best, topk_, outs


def phase_simota(model, cfg, bsz=16, hw=640, others=None):
    """The streamed SimOTA kernel against its plain version at the main
    path's shapes (B=16, P=8400 at 640^2, G=128 slots, 3-40 faces an
    image, image 0 with no valid GT, image 1 with clustered GTs) and on
    tie_heavy_inputs: all four outputs EQUAL; then the assignment
    assembled from the kernel's outputs against the dense sim_ota_assign
    on the card. Times: the event time per back-to-back call (cuda_ms),
    the device time per call and the host's time to issue one
    (device_ms), each of the two launches alone on the device, the plain
    version, and the bound. others maps names to the NativeLibs of
    other simota.cu builds with the same C interface: each is held equal
    to the kernel and its launches are timed beside the kernel's, in the
    order others, kernel, kernel, others reversed."""
    import torch
    from yunet_tpu_torch.ops import simota
    from yunet_tpu_torch.ops.assign import dynamic_k
    from yunet_tpu_torch.ops.simota import (streamed_simota,
                                            streamed_simota_plain)
    batch = _to_device(train_batch(np.random.RandomState(4), bsz, hw,
                                   empty=(0,), clustered=(1,)))
    priors, offset = train_priors(cfg, hw)
    ins = simota_inputs(model, batch, priors, offset)
    got, iou_err = _check_simota(f"B={bsz} P={priors.shape[0]} "
                                 f"G={MAX_GTS}", ins)
    gv = batch["gt_valid"]
    k = got.cand_idx.shape[-1]
    # multi-matches in the clustered image: priors taken by several GTs
    take = (torch.arange(k, device=DEV)
            < dynamic_k(got.topk_iou, gv)[..., None])
    count = torch.zeros(got.valid_prior.shape, dtype=torch.int32,
                        device=DEV).scatter_add_(
        1, got.cand_idx.reshape(bsz, -1).long(),
        take.reshape(bsz, -1).int())
    multi = (count > 1).sum(1).tolist()
    log(f"[simota] multi-matched priors per image {multi}; topk_iou max "
        f"abs err {iou_err}")
    if multi[1] == 0 or got.valid_prior[0].any():
        raise AssertionError("the clustered image has no multi-match, or "
                             "the image without GTs has valid priors")
    for kk in (1, 16):      # the switch's other instantiations
        if not all(torch.equal(a, b) for a, b in zip(
                streamed_simota(*ins, k=kk),
                streamed_simota_plain(*ins, k=kk))):
            raise AssertionError(f"SimOTA kernel != plain at k={kk}")
    log("[simota] k=1 and k=16: kernel == plain")
    ties = tie_heavy_inputs(ins)
    tgot, terr = _check_simota("tie-heavy B=3", ties)
    iou_err = max(iou_err, terr)
    in_gts, in_cts = simota._pair_masks(ties[1], ties[3], ties[5], 2.5)
    n_both = (in_gts & in_cts)[2].sum(0)[ties[5][2]]
    short = int((n_both < k).sum())
    log(f"[simota] tie-heavy: {short} of image 2's {n_both.numel()} GTs "
        f"have fewer than k={k} priors in box and centre")
    if short == 0:
        raise AssertionError("no GT of the tie-heavy image 2 is short of "
                             "k in-box-and-centre priors")

    ms = cuda_ms(lambda: streamed_simota(*ins))
    dev_ms, host_ms = device_ms(lambda: streamed_simota(*ins))
    vb, tk, _ = simota_entry_points(simota.LIB.get(), ins)
    vb_ms, tk_ms = device_ms(vb)[0], device_ms(tk)[0]
    plain = cuda_ms(lambda: streamed_simota_plain(*ins), warmup=1, iters=3)
    # the bound: every input read and output written once; ~45 f32
    # operations (one of them a log, one a log1p, one a sqrt) for each
    # (prior, valid GT) pair this batch holds
    nbytes = sum(t.numel() * t.element_size() for t in ins + tuple(got))
    pairs = priors.shape[0] * int(gv.sum())
    bnd, by = bound_ms(nbytes, 45 * pairs, F32_FLOPS)
    log(f"[simota] time: {ms:.4f} ms an event-timed back-to-back call; "
        f"device {dev_ms:.4f} ms a call (valid_best {vb_ms:.4f} + topk "
        f"{tk_ms:.4f} alone), host {host_ms:.4f} ms to issue a call; plain "
        f"{plain:.4f} ms; bound {bnd:.6f} ms ({by}; {nbytes} bytes, "
        f"{pairs} live pairs)")
    if others:
        order = list(others.items()) + [("kernel", simota.LIB)] * 2
        for name, lib in order + order[-3::-1]:
            vb, tk, outs = simota_entry_points(lib.get(), ins)
            tk()
            torch.cuda.synchronize()
            if not all(torch.equal(o, g) for o, g in zip(outs, got)):
                raise AssertionError(f"{name} build's outputs != kernel's")
            log(f"[simota] device alone, {name}: valid_best "
                f"{device_ms(vb)[0]:.4f} ms, topk {device_ms(tk)[0]:.4f} ms")
    return iou_err, {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by, "device_ms": dev_ms,
                     "host_ms": host_ms, "valid_best_ms": vb_ms,
                     "topk_ms": tk_ms}


def plain_targets(aux, batch, cfg):
    """The targets of one step rebuilt from the step's own assignment
    inputs with the streamed SimOTA's plain version."""
    from yunet_tpu_torch.ops.assign import assemble_streamed
    from yunet_tpu_torch.ops.boxes import fuse_score
    from yunet_tpu_torch.ops.simota import streamed_simota_plain
    from yunet_tpu_torch.train.targets import targets_from_assign
    _, offset = train_priors(cfg.model, batch["image"].shape[1])
    a = cfg.assigner
    sa = streamed_simota_plain(
        fuse_score(aux["cls"][..., 0], aux["obj"]), offset, aux["decoded"],
        batch["gt_bboxes"], (batch["gt_labels"] == 0).float(),
        batch["gt_valid"], center_radius=a.center_radius,
        k=a.candidate_topk, iou_weight=a.iou_weight,
        cls_weight=a.cls_weight)
    res = assemble_streamed(*sa, batch["gt_bboxes"], batch["gt_valid"],
                            aux["decoded"])
    return targets_from_assign(res, batch["gt_bboxes"], batch["gt_labels"],
                               batch["gt_kps"],
                               num_classes=cfg.model.num_classes,
                               kps_num=cfg.model.kps_num)


def phase_train(sd):
    """The training slice through its entry points: yunet_n at full
    width, the shipped config (bf16 trunk, streamed SimOTA), r04 weights,
    10 steps at b16 640^2 on seeded synthetic batches, with the launch
    counters from zero. Then: 5 steps repeated on one batch at the base lr
    lower the loss; one f32 step's targets equal those rebuilt with the
    plain SimOTA from the step's own inputs."""
    import dataclasses
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.train import init_train_state, make_train_step
    cfg = yunet_n()
    bsz, hw = cfg.data.samples_per_device, cfg.data.img_size
    rng = np.random.RandomState(5)
    batches = [_to_device(train_batch(rng, bsz, hw)) for _ in range(3)]
    ts, opt = init_train_state(cfg, steps_per_epoch=1000, total_batch=bsz,
                               device=DEV, state_dict=sd)
    step = make_train_step(cfg, ts.model, opt, img_size=hw)

    reset_launch_counts()
    metrics = [step(ts, batches[i % 3])[1] for i in range(10)]
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[train] launches on the training path: {launches}")
    if launches["simota_streamed"] != 2 * 10:
        raise AssertionError("the streamed SimOTA kernel did not run "
                             "twice (two launches) in every step")
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, r in enumerate(rows):
        log(f"[train] step {i}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()))
        if not all(np.isfinite(list(r.values()))) or r["num_pos"] <= 0:
            raise AssertionError(f"step {i}: non-finite loss or no positives")

    # the base lr from the first step (the warmup would start at 1e-5,
    # where five steps move the loss less than bf16 rounding does)
    cfg_lr = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_iters=0))
    fresh, fopt = init_train_state(cfg_lr, steps_per_epoch=1000,
                                   total_batch=bsz, device=DEV, state_dict=sd)
    fstep = make_train_step(cfg_lr, fresh.model, fopt, img_size=hw)
    rep = [float(fstep(fresh, batches[0])[1]["loss"]) for _ in range(5)]
    log(f"[train] 5 steps on one batch at lr {cfg.train.lr}: {rep}")
    if not rep[-1] < rep[0]:
        raise AssertionError("repeated steps on one batch did not lower "
                             "the loss")

    # one f32 step: the targets the kernel built == the plain rebuild
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, bf16=False))
    torch.backends.cudnn.deterministic = True
    ts32, opt32 = init_train_state(cfg32, steps_per_epoch=1000,
                                   total_batch=bsz, device=DEV,
                                   state_dict=sd)
    step32 = make_train_step(cfg32, ts32.model, opt32, img_size=hw)
    _, m32, aux = step32(ts32, batches[1], return_aux=True)
    want = plain_targets(aux, batches[1], cfg32)
    torch.backends.cudnn.deterministic = False
    for k, v in aux["targets"].items():
        if not torch.equal(v, want[k]):
            raise AssertionError(f"f32 step: target {k} != plain rebuild")
    log(f"[train] f32 step: loss {float(m32['loss']):.4f}, targets equal to "
        f"the plain rebuild ({int(want['num_pos'].sum())} positives)")
    return launches, batches


def phase_train_times(sd, batch):
    """ms per train step at b16 640^2 bf16 (CUDA events, medians of 5
    windows of 3 steps): the shipped config (streamed SimOTA kernel), then
    pallas_simota=False (the dense assignment), in the order kernel, dense,
    dense, kernel."""
    import dataclasses
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.train import init_train_state, make_train_step
    steps = {}
    bsz = yunet_n().data.samples_per_device
    for dense in (False, True):
        cfg = yunet_n()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, pallas_simota=not dense))
        ts, opt = init_train_state(cfg, steps_per_epoch=1000,
                                   total_batch=bsz, device=DEV,
                                   state_dict=sd)
        step = make_train_step(cfg, ts.model, opt,
                               img_size=cfg.data.img_size)
        steps["dense" if dense else "kernel"] = (
            lambda st=step, s=ts: st(s, batch))
    out = {}
    for which in ("kernel", "dense", "dense", "kernel"):
        out.setdefault(which, []).append(
            cuda_ms(steps[which], warmup=2, iters=3))
    for which, v in out.items():
        log(f"[time] train step b16 640^2 bf16, {which} SimOTA: "
            f"{v[0]:.4f} / {v[1]:.4f} ms ({bsz / (min(v) / 1e3):.1f} img/s "
            "at the best)")
    return out


GRADS = ("dx", "dw1", "db1", "dwd", "dbd")
# fused ConvDP backward, kernel against its plain version, as shares of
# each gradient's largest magnitude: f32 sums over up to 409,600
# positions in another order (the kernel's per-block sums and fixed-order
# reduction against torch's reductions and f32 matmuls; in bf16 the
# recomputed y1, rounded to bf16 after sums in another order, may round
# the other way). Measured on an H100 at most 4.4e-6. dx in bf16, rounded
# once by both, may differ by one bf16 ulp more: where its sum cancels,
# the f32 noise of the sum order is many ulps of the small result
BWD_TOL = 1e-4


# the five heaviest units of a 640^2 b16 step; shapes that are not whole
# 8 x 16 tiles, (N, H, W, Cin, Cout): two at yunet_n's widths, one at
# yunet_s's 32 channels and one whose channels take the scalar loads
HEAVY_UNITS = ("stem_dp", "m1a", "m1b", "m2a", "m2b")
RAGGED_BWD = ((2, 21, 19, 16, 64), (2, 21, 19, 64, 10), (1, 17, 33, 32, 32),
              (2, 9, 7, 3, 1))


def _check_convdp_bwd(label, x, w1, b1, wd, dz, worst):
    """One backward kernel call against its plain version, within BWD_TOL.
    In bf16 also: the call took the tensor-core route (its counter), and a
    second call gives the same gradients bit for bit. Returns the shares."""
    import torch
    from yunet_tpu_torch.ops.convdp import ulp_bf16
    from yunet_tpu_torch.ops.convdp_train import (fused_pw_dw_bwd,
                                                  fused_pw_dw_bwd_plain)
    bf16 = x.dtype == torch.bfloat16
    before = fused_pw_dw_bwd.launches_mma
    got = fused_pw_dw_bwd(x, w1, b1, wd, dz)
    if fused_pw_dw_bwd.launches_mma != before + int(bf16):
        raise AssertionError(f"convdp_bwd {label} {x.dtype}: not on the "
                             f"{'tensor-core' if bf16 else 'f32'} route")
    want = fused_pw_dw_bwd_plain(x, w1, b1, wd, dz)
    torch.cuda.synchronize()
    shares = {}
    for g_name, g, wt in zip(GRADS, got, want):
        if g.shape != wt.shape or g.dtype != wt.dtype:
            raise AssertionError(f"convdp_bwd {label}: {g_name} "
                                 f"{g.shape}/{g.dtype} vs plain "
                                 f"{wt.shape}/{wt.dtype}")
        d = (g.float() - wt.float()).abs()
        shares[g_name] = float(d.max() / wt.float().abs().max()
                               .clamp_min(1e-30))
        if not bf16:
            worst["f32_abs"] = max(worst["f32_abs"], float(d.max()))
    if bf16:
        # dx: what is left over one bf16 ulp, as a share
        a, b = got[0].float(), want[0].float()
        shares["dx"] = float(((a - b).abs() - ulp_bf16(
            torch.maximum(a.abs(), b.abs()))).clamp_min(0).max()
            / b.abs().max().clamp_min(1e-30))
        again = fused_pw_dw_bwd(x, w1, b1, wd, dz)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"convdp_bwd {label}: two bf16 calls gave "
                                 "different gradients")
    key = "bf16" if bf16 else "f32"
    worst[key] = max(worst[key], *shares.values())
    bad = {k: v for k, v in shares.items() if v > BWD_TOL}
    if bad:
        raise AssertionError(f"convdp_bwd kernel != plain at {label} {x.dtype}:"
                             f" {bad} (tolerances {BWD_TOL})")
    return shares


def phase_convdp_bwd(folded, cfg, bsz=16, hw=640):
    """The fused ConvDP backward kernel against its plain version at each
    of the 29 ConvDPUnit shapes of a 640^2 b16 train step (the r04 folded
    weights of each unit, seeded x and dz) and at RAGGED_BWD (seeded
    weights), in f32 and bf16, within BWD_TOL; every bf16 call on the
    tensor-core route and bit-identical when repeated. Times the bf16
    units, each alone, summed over the 29: the kernel, its plain version,
    the library yardstick (autograd backward through library_conv2d 1x1 +
    depthwise, bf16, channels-last) and the bound; and lists the
    HEAVY_UNITS."""
    import torch
    from yunet_tpu_torch.models.layers import library_conv2d
    from yunet_tpu_torch.ops.convdp_train import (fused_pw_dw_bwd,
                                                  fused_pw_dw_bwd_plain)
    gen = torch.Generator(device=DEV).manual_seed(6)
    units = convdp_unit_shapes(folded, cfg, hw, hw)
    if len(units) != 29:
        raise AssertionError(f"{len(units)} ConvDPUnits, not 29")
    worst = {"f32": 0.0, "bf16": 0.0, "f32_abs": 0.0}
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    heavy = {}
    t_bytes = t_ops = 0.0

    def inputs(n, h, w, cin, cout, dt):
        x = (torch.rand((n, h, w, cin), generator=gen, device=DEV) * 3).to(dt)
        return x, torch.randn((n, h, w, cout), generator=gen,
                              device=DEV).to(dt)

    for name, h, w, u in units:
        cin, cout = u.w1.shape
        for dt in (torch.float32, torch.bfloat16):
            x, dz = inputs(bsz, h, w, cin, cout, dt)
            shares = _check_convdp_bwd(name, x, u.w1, u.b1, u.wd, dz, worst)
        log(f"[convdp_bwd] {name} b{bsz} {h}x{w} {cin}->{cout}: bf16 shares "
            + ", ".join(f"{k} {v:.2e}" for k, v in shares.items()))

        # times at bf16 (the shipped dtype): x, dz from the check above
        ms = cuda_ms(lambda: fused_pw_dw_bwd(x, u.w1, u.b1, u.wd, dz),
                     warmup=2, iters=5, windows=3)
        pms = cuda_ms(lambda: fused_pw_dw_bwd_plain(x, u.w1, u.b1, u.wd,
                                                    dz),
                      warmup=2, iters=5, windows=3)
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        lw = [t.detach().clone().requires_grad_() for t in (
            u.w1.t().reshape(cout, cin, 1, 1), u.b1,
            u.wd.t().reshape(cout, 1, 3, 3), u.bd)]
        y = library_conv2d(library_conv2d(xl, lw[0], lw[1]), lw[2], lw[3],
                           padding=1, groups=cout)
        dzl = dz.permute(0, 3, 1, 2)
        lms = cuda_ms(lambda: torch.autograd.grad(y, [xl] + lw, dzl,
                                                  retain_graph=True),
                      warmup=2, iters=5, windows=3)
        # x and dz read, dx written (bf16), the weights read and the
        # gradients written (f32); three Cin x Cout products and two 9-tap
        # passes a position, at the bf16 tensor-core peak
        pos = bsz * h * w
        nbytes = pos * (2 * cin + cout) * 2 + (cin * cout + 11 * cout) * 8
        ops = 2 * pos * (3 * cin * cout + 18 * cout + 2 * cout)
        bnd = bound_ms(nbytes, ops, BF16_FLOPS)[0]
        t_bytes += nbytes / HBM_BPS * 1e3
        t_ops += ops / BF16_FLOPS * 1e3
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            tot[k] += v
        if name in HEAVY_UNITS:
            heavy[name] = (h, w, cin, cout, ms, lms, bnd)
        log(f"[convdp_bwd] time {name} bf16: kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, library {lms:.4f} ms, bound {bnd:.6f} ms")
        del x, dz, xl, y, dzl
    # after the units, which draw their inputs first from the generator
    for n, h, w, cin, cout in RAGGED_BWD:
        w1, b1, wd = (torch.randn(s, generator=gen, device=DEV) * 0.2
                      for s in ((cin, cout), (cout,), (9, cout)))
        for dt in (torch.float32, torch.bfloat16):
            label = f"ragged {n}x{h}x{w} {cin}->{cout}"
            x, dz = inputs(n, h, w, cin, cout, dt)
            shares = _check_convdp_bwd(label, x, w1, b1, wd, dz, worst)
            log(f"[convdp_bwd] {label} {str(dt)[6:]}: shares "
                + ", ".join(f"{k} {v:.2e}" for k, v in shares.items()))
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[convdp_bwd] worst: f32 share {worst['f32']:.2e} (abs "
        f"{worst['f32_abs']:.3e}); bf16 share {worst['bf16']:.2e} (dx: "
        f"beyond one bf16 ulp); tolerance {BWD_TOL}; bf16 calls on the "
        "tensor-core route, repeated calls bit-identical")
    log(f"[convdp_bwd] the heaviest units, b{bsz} bf16 (kernel / library / "
        "bound ms, kernel/library):")
    for name in HEAVY_UNITS:
        h, w, cin, cout, ms, lms, bnd = heavy[name]
        log(f"[convdp_bwd]   {name:8s} {h}x{w} {cin}->{cout}: {ms:.4f} / "
            f"{lms:.4f} / {bnd:.6f} ({ms / lms:.2f}x)")
    log(f"[convdp_bwd] 640^2 b{bsz} bf16, all 29 units: kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.6f} ms "
        f"({tot['bound_by']})")
    return worst, tot


def convdp_bwd_only():
    """phase_convdp_bwd alone, for quick work on the backward kernel:
    python3 -c "import chip_smoke as s; s.convdp_bwd_only()" from the
    repository root. Builds only convdp_bwd.cu."""
    import torch
    from yunet_tpu_torch.ops import convdp_train
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)} | {nvidia_smi_line()}")
    cfg, _, _, folded = load_model()
    phase_build({"convdp_bwd.cu": convdp_train.LIB})
    phase_convdp_bwd(folded, cfg)


def phase_train_fused(sd, batches):
    """The training path with train.fused_kernels (reached through
    validate_config(force_experimental=True)), yunet_n at full width,
    bf16, r04 weights, 10 steps at b16 640^2 with the launch counters from
    zero: 29 forward and 29 backward ConvDP launches (the backward all on
    its bf16 tensor-core route) and 2 SimOTA launches a step; finite
    losses; 5 steps on one batch at the base lr lower the
    loss; one f32 fused step's metrics against the unfused f32 step's
    (rtol 1e-4: the same function, the fused kernels' sums against
    cuDNN's; the same positives). Then ms per step, shipped (unfused) and
    fused, in the order shipped, fused, fused, shipped."""
    import dataclasses
    import torch
    from yunet_tpu_torch.config import validate_config, yunet_n
    from yunet_tpu_torch.models.layers import ConvDPUnit
    from yunet_tpu_torch.train import init_train_state, make_train_step

    def fused_cfg(**train):
        cfg = yunet_n()
        return validate_config(dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, **{"fused_kernels": True, **train})),
            force_experimental=True)

    def build(cfg):
        ts, opt = init_train_state(cfg, steps_per_epoch=1000,
                                   total_batch=bsz, device=DEV,
                                   state_dict=sd)
        return ts, make_train_step(cfg, ts.model, opt, img_size=hw)

    cfg = fused_cfg()
    bsz, hw = cfg.data.samples_per_device, cfg.data.img_size
    ts, step = build(cfg)
    # the trunk stays channels-last: count the units whose NHWC view of
    # their input is not contiguous (a layout copy on the way in)
    copies = []
    hooks = [m.register_forward_pre_hook(lambda m, a: copies.append(
        not a[0].permute(0, 2, 3, 1).is_contiguous()))
        for m in ts.model.modules() if isinstance(m, ConvDPUnit)]
    reset_launch_counts()
    metrics = [step(ts, batches[i % 3])[1] for i in range(10)]
    torch.cuda.synchronize()
    launches = launch_counts()
    for h in hooks:
        h.remove()
    log(f"[train_fused] launches on the fused training path: {launches}; "
        f"unit inputs needing a layout copy: {sum(copies)} of {len(copies)}")
    if sum(copies):
        raise AssertionError("the fused trunk left channels-last")
    want = {"fused_conv_dp": 290, "fused_conv_dp_mma": 290,
            "convdp_bwd": 290, "convdp_bwd_mma": 290, "simota_streamed": 20}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"fused training launches {launches}, want "
                             f"{want} (29 units x 10 steps, every forward "
                             "and backward on the bf16 route; 2 x 10)")
    for i, m in enumerate(metrics):
        r = {k: float(v) for k, v in m.items()}
        log(f"[train_fused] step {i}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()))
        if not all(np.isfinite(list(r.values()))) or r["num_pos"] <= 0:
            raise AssertionError(f"fused step {i}: non-finite loss or no "
                                 "positives")

    fresh, fstep = build(fused_cfg(warmup_iters=0))
    rep = [float(fstep(fresh, batches[0])[1]["loss"]) for _ in range(5)]
    log(f"[train_fused] 5 steps on one batch at lr {cfg.train.lr}: {rep}")
    if not rep[-1] < rep[0]:
        raise AssertionError("repeated fused steps on one batch did not "
                             "lower the loss")
    del fresh, fstep

    torch.backends.cudnn.deterministic = True
    m32 = {}
    for fused in (True, False):
        c32 = fused_cfg(bf16=False, fused_kernels=fused)
        t32, s32 = build(c32)
        m32[fused] = {k: float(v) for k, v in s32(t32, batches[1])[1].items()}
        del t32, s32
    torch.backends.cudnn.deterministic = False
    log(f"[train_fused] f32 step: fused {m32[True]}, unfused {m32[False]}")
    if m32[True]["num_pos"] != m32[False]["num_pos"]:
        raise AssertionError("f32 fused and unfused steps chose different "
                             "positives")
    for k, v in m32[False].items():
        if not np.isclose(m32[True][k], v, rtol=1e-4, atol=0.0):
            raise AssertionError(f"f32 fused {k} {m32[True][k]} != unfused "
                                 f"{v} (rtol 1e-4)")

    steps = {}
    for name, c in (("shipped", yunet_n()), ("fused", cfg)):
        t, s = build(c)
        steps[name] = (lambda st=s, tt=t: st(tt, batches[0]))
    out = {}
    for which in ("shipped", "fused", "fused", "shipped"):
        out.setdefault(which, []).append(
            cuda_ms(steps[which], warmup=2, iters=3))
    for which, v in out.items():
        log(f"[time] train step b16 640^2 bf16, {which}: {v[0]:.4f} / "
            f"{v[1]:.4f} ms ({bsz / (min(v) / 1e3):.1f} img/s at the best)")
    return launches, out


# the channels-major unit's ragged shapes (H, W, Cin, Cout, N), as in
# tests/test_torch_convdp_cm.py, and one 64 -> 64 whose W is no multiple
# of the bf16 route's 8 columns and whose N is no multiple of 8
CM_RAGGED = ((10, 6, 8, 16, 128), (9, 5, 3, 8, 128), (11, 7, 16, 24, 37),
             (13, 21, 64, 64, 45))


def _check_convdp_cm(label, x32, w1, b1, wd, bd):
    """The channels-major kernel on x32 (N, H, W, Cin; f32 on the card)
    laid out as (H, Cin, W*N), in f32 and bf16, with and without ReLU,
    against its plain version and against the NHWC kernel on the same
    data. f32 (the scalar route) within rtol/atol 1e-5: sums in another
    order. bf16: y1 is rounded to bf16 (the plain version too, after
    another sum order, so it may round the other way; the NHWC kernel
    keeps it f32), which moves an output by at most one bf16 ulp of its
    channel's largest |y1| through the nine taps, plus one ulp of the
    output. Every bf16 call at 64 channels or fewer on the tensor-core
    route, and a second call bit-equal. Returns (f32 max abs err against
    the plain version, worst bf16 diff over its tolerance)."""
    import torch
    from yunet_tpu_torch.ops.convdp import fused_conv_dp, ulp_bf16
    from yunet_tpu_torch.ops.convdp_cm import (fused_conv_dp_cm,
                                               fused_conv_dp_cm_plain)
    n, h, w, cin = x32.shape
    cout = w1.shape[1]
    f32_err, share = 0.0, 0.0
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        xn = x32.to(dt)
        xc = xn.permute(1, 3, 2, 0).reshape(h, cin, w * n).contiguous()
        if bf16:
            y1 = (xn.float().reshape(-1, cin) @ w1.to(dt).float()
                  + b1).abs().amax(0)
            y1_tol = (ulp_bf16(y1) * wd.abs().sum(0))[None, :, None]
        for relu in (False, True):
            before = fused_conv_dp_cm.launches_mma
            got = fused_conv_dp_cm(xc, w1, b1, wd, bd, w=w, n=n, relu=relu)
            mma = fused_conv_dp_cm.launches_mma - before
            if mma != int(bf16 and max(cin, cout) <= 64):
                raise AssertionError(f"convdp_cm {label} {dt}: {mma} "
                                     "tensor-core route launches")
            if bf16:
                again = fused_conv_dp_cm(xc, w1, b1, wd, bd, w=w, n=n,
                                         relu=relu)
            plain = fused_conv_dp_cm_plain(xc, w1, b1, wd, bd, w=w, n=n,
                                           relu=relu)
            k4 = fused_conv_dp(xn, w1, b1, wd, bd, relu=relu).permute(
                1, 3, 2, 0).reshape(h, cout, w * n)
            torch.cuda.synchronize()
            if bf16 and not torch.equal(got, again):
                raise AssertionError(f"convdp_cm {label} bf16: two calls "
                                     "differ")
            g = got.float()
            for what, ref in (("plain", plain.float()), ("nhwc", k4.float())):
                d = (g - ref).abs()
                if not bf16:
                    if what == "plain":
                        f32_err = max(f32_err, float(d.max()))
                    ok = bool((d <= 1e-5 + 1e-5 * ref.abs()).all())
                else:
                    tol = y1_tol + ulp_bf16(torch.maximum(g.abs(),
                                                          ref.abs()))
                    share = max(share, float((d / tol).max()))
                    ok = bool((d <= tol).all())
                log(f"[convdp_cm] {label} {str(dt)[6:]} relu={relu} kernel "
                    f"vs {what}: max abs diff {float(d.max()):.3e}")
                if not ok:
                    raise AssertionError(f"convdp_cm kernel != {what} at "
                                         f"{label} ({dt}, relu={relu})")
            del got, plain, k4, g
    return f32_err, share


def phase_convdp_cm():
    """The channels-major ConvDP kernel (_check_convdp_cm) at the bench
    shape (64 -> 64, 160^2, N = 128; seeded on the card) and at the
    ragged shapes of CM_RAGGED. Times the bf16 kernel, its plain version
    and the library pair at the bench shape, then runs the bench twin with
    the launch counters from zero: all 120 launches on the tensor-core
    route."""
    import torch
    import torch.nn.functional as F
    from yunet_tpu_torch.ops.convdp_cm import (fused_conv_dp_cm,
                                               fused_conv_dp_cm_plain)
    from yunet_tpu_torch.tools import bench_convdp_cm as bench
    n, h, w, cin, cout = bench.N, bench.H, bench.W, bench.CIN, bench.COUT
    gen = torch.Generator(device=DEV).manual_seed(7)

    def draw(n, h, w, cin, cout):
        return (torch.randn((n, h, w, cin), generator=gen, device=DEV),
                *(torch.randn(s, generator=gen, device=DEV) * 0.3
                  for s in ((cin, cout), (cout,), (9, cout), (cout,))))

    x32, w1, b1, wd, bd = draw(n, h, w, cin, cout)
    max_err, share = _check_convdp_cm(f"{h}x{w} {cin}->{cout} N={n}", x32,
                                      w1, b1, wd, bd)
    for rh, rw, rci, rco, rn in CM_RAGGED:
        e, s = _check_convdp_cm(f"{rh}x{rw} {rci}->{rco} N={rn}",
                                *draw(rn, rh, rw, rci, rco))
        max_err, share = max(max_err, e), max(share, s)
    log(f"[convdp_cm] worst: f32 abs err {max_err:.3e} (rtol/atol 1e-5); "
        f"bf16 diff at most {share:.3f} of its tolerance; every bf16 call "
        "on the tensor-core route, repeats bit-equal")
    xn = x32.to(torch.bfloat16)
    xc = xn.permute(1, 3, 2, 0).reshape(h, cin, w * n).contiguous()
    del x32
    ms = cuda_ms(lambda: fused_conv_dp_cm(xc, w1, b1, wd, bd, w=w, n=n))
    pms = cuda_ms(lambda: fused_conv_dp_cm_plain(xc, w1, b1, wd, bd, w=w,
                                                 n=n),
                  warmup=1, iters=2, windows=3)
    lw = (w1.t().reshape(cout, cin, 1, 1).to(torch.bfloat16),
          b1.to(torch.bfloat16),
          wd.t().reshape(cout, 1, 3, 3).to(torch.bfloat16),
          bd.to(torch.bfloat16))
    xl = xn.permute(0, 3, 1, 2)
    lms = cuda_ms(lambda: F.conv2d(F.conv2d(xl, lw[0], lw[1]), lw[2], lw[3],
                                   padding=1, groups=cout))
    nbytes = h * w * n * (cin + cout) * 2 + (cin * cout + 11 * cout) * 4
    ops = 2 * h * w * n * cout * (cin + 9 + 1)
    bnd, by = bound_ms(nbytes, ops, BF16_FLOPS)
    log(f"[convdp_cm] time {cin}->{cout} {h}x{w} N={n} bf16: kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, library pair {lms:.4f} ms, bound "
        f"{bnd:.6f} ms ({by})")
    del xn, xc, xl
    torch.cuda.empty_cache()

    reset_launch_counts()
    res = bench.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    launches, launches_mma = counts["convdp_cm"], counts["convdp_cm_mma"]
    for name, r in res.items():
        log(f"[bench_convdp_cm] {name}: {r['ms_per_unit']:.4f} ms/unit, "
            f"{r['gb_s']:.1f} GB/s (windows {[round(v, 4) for v in r['windows']]})")
    want = (1 + bench.WINDOWS) * bench.ITERS
    log(f"[bench_convdp_cm] launches {launches}, on the tensor-core route "
        f"{launches_mma}")
    if launches != want or launches_mma != want:
        raise AssertionError(f"the bench launched the channels-major kernel "
                             f"{launches} times, {launches_mma} on the "
                             f"tensor-core route (want {want} and {want})")
    return max_err, (launches, launches_mma), {
        "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": bnd,
        "bound_by": by, "bf16_tol_share": share}


def convdp_cm_only():
    """phase_convdp_cm alone, for quick work on the channels-major kernel:
    python3 -c "import chip_smoke as s; s.convdp_cm_only()" from the
    repository root. Builds only convdp_cm.cu and convdp.cu (the phase
    compares with the NHWC kernel)."""
    import torch
    from yunet_tpu_torch.ops import convdp, convdp_cm
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)} | {nvidia_smi_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build({"convdp_cm.cu": convdp_cm.LIB, "convdp.cu": convdp.LIB})
    phase_convdp_cm()


def simota_only(*others):
    """phase_simota alone, for quick work on the SimOTA kernel:
    python3 -c "import chip_smoke as s; s.simota_only()" from the
    repository root. Builds only simota.cu. Each of others is the path of
    another simota.cu with the same C interface (a scratch copy of an
    earlier version or a variant, in a directory .gitignore lists): it is
    built with the same flags, held equal to this kernel and timed beside
    it."""
    import torch
    from yunet_tpu_torch.ops import simota
    from yunet_tpu_torch.ops._build import NativeLib
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)} | {nvidia_smi_line()}")
    cfg, _, model, _ = load_model()
    # the others are driven through the two per-launch entry points only
    sigs = {name: sig for name, sig in simota.LIB.signatures.items()
            if name != "yunet_simota"}
    builds = {path: NativeLib(os.path.abspath(path), simota.LIB.compiler,
                              sigs) for path in others}
    phase_build({"simota.cu": simota.LIB, **builds})
    phase_simota(model, cfg, others=builds)


def load_model():
    """yunet_n on the card with the r04 EMA weights: (model config, state
    dict, model, BN-folded units). Also turns TF32 off for the f32
    references."""
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.models.detector import YuNet
    from yunet_tpu_torch.models.fused import fold_inference_params
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = yunet_n().model
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, cfg))
    model = YuNet(cfg, device=DEV)
    model.load_state_dict(sd)
    return cfg, sd, model, fold_inference_params(model, cfg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    # the package first: without it the script fails before printing
    import yunet_tpu_torch  # noqa: F401
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build()
    nms_err, nms_t = phase_nms()
    cfg, sd, model, folded = load_model()
    conv_err, conv_t = phase_convdp(folded, cfg)
    simota_err, simota_t = phase_simota(model, cfg)
    _, fdet, serve_launches = phase_slice()
    train_launches, batches = phase_train(sd)
    bwd_err, bwd_t = phase_convdp_bwd(folded, cfg)
    fused_launches, _ = phase_train_fused(sd, batches)
    cm_err, (cm_launches, cm_mma), cm_t = phase_convdp_cm()
    phase_times(fdet)
    phase_train_times(sd, batches[0])

    kernels = [
        {"name": "greedy_nms", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/nms.cu",
         "replaces": "yunet_tpu/ops/nms_pallas.py:78",
         "also_replaces": "yunet_tpu/ops/nms_pallas.py:40",
         "launches": serve_launches["greedy_nms"], "max_abs_err": nms_err,
         # no single PyTorch call computes greedy NMS (no torchvision)
         "library_ms": None, **nms_t},
        {"name": "fused_conv_dp", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp.cu",
         "replaces": "yunet_tpu/ops/convdp_pallas.py:29",
         "launches": serve_launches["fused_conv_dp"],
         # of those, the launches of the bf16 (tensor-core) route
         "launches_mma": serve_launches["fused_conv_dp_mma"],
         # also the forward of fused_pw_dw on the fused training path
         "also_runs_on": "training path with train.fused_kernels",
         "launches_fused_training": fused_launches["fused_conv_dp"],
         "launches_mma_fused_training": fused_launches["fused_conv_dp_mma"],
         "max_abs_err": conv_err["f32"],
         "bf16_excess": conv_err["bf16_excess"], **conv_t},
        {"name": "simota_streamed", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/simota.cu",
         "replaces": "yunet_tpu/ops/simota_pallas.py:233",
         "also_replaces": "yunet_tpu/ops/simota_pallas.py:118",
         "launches": train_launches["simota_streamed"],
         "max_abs_err": simota_err,
         # no single PyTorch call computes the SimOTA reductions
         "library_ms": None, **simota_t},
        {"name": "convdp_bwd", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp_bwd.cu",
         "replaces": "yunet_tpu/ops/convdp_pallas_impl.py:61",
         "launches": fused_launches["convdp_bwd"],
         # of those, the launches of the bf16 (tensor-core) route
         "launches_mma": fused_launches["convdp_bwd_mma"],
         "max_abs_err": bwd_err["f32_abs"], **bwd_t},
        {"name": "convdp_cm", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp_cm.cu",
         "replaces": "yunet_tpu/ops/convdp_cm_pallas.py:57",
         "launches": cm_launches,
         # of those, the launches of the bf16 (tensor-core) route
         "launches_mma": cm_mma, "max_abs_err": cm_err, **cm_t},
    ]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
