#!/usr/bin/env python3
"""Smoke test of the PyTorch port (yunet_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from yunet_tpu_torch/csrc/ (nvcc, sm_90a, all
at once), compares each kernel with its plain PyTorch version on the card
at the shapes its path gives it, drives the serving path (yunet_n at full
width, trained r04 EMA weights from tests/fixtures/r04_ema.npz), a fused
Detector's batch-1 detect replayed as a CUDA graph (bf16 and f32, at two
canvases, bit for bit against the eager program, with an eviction),
SCRFD-10GF-KPS's fused detect (the benchmark's seeded weights; a replay
bit for bit against the eager call, 58 counted convs a capture, the conv
and NMS kernels of a replay) and the training path (10 steps of yunet_n
at 640^2 b16, bf16, from the same weights, on seeded synthetic face
batches) through the user entry points,
the same training path with train.fused_kernels (every ConvDPUnit through
the fused forward kernel and its hand-written backward), the
channels-major ConvDP bench (yunet_tpu_torch.tools.bench_convdp_cm) and
the WIDER evaluation (python -m yunet_tpu_torch.tools.test_widerface in
modes 0 and 2 with device and host NMS over a seeded 64-image split read
from the decoded .npy cache, then a fused Detector's sweep, TTA and
warmup) and the training entry point (python -m
yunet_tpu_torch.tools.train through its main(): 12 steps of yunet_n at
640^2 b16 on a seeded 64-image split read from the decoded .npy cache by
forked loader workers, checkpoints, the WIDER eval hook, an auto-resume
to step 16 and 4 steps with train.fused_kernels) and device-side
augmentation (the same split staged as a bank in card memory; the card's
device_resample against the CPU's, dense against tiled; the training CLI
with data.device_aug=true: 12 steps, a resume to 16 and 48 steps for the
fed rate) and export and import (ONNX and C++ files written from the card's
model, the files run through the torch ONNX executor on the card, the
ONNX-imported fused Detector on the ConvDP and NMS kernels, the
detect_image and yunet2onnx CLIs) and data-parallel training (spawned
rank processes: two gloo ranks on the card against one process at twice
the batch with GhostBN, the training CLI with --distributed in two ranks
with a sharded bank and the gathered eval hook, NCCL at world size 1 and,
with two cards, two NCCL ranks) and the profiling and check tools
(verify_device_kernels on every kernel, profile_serve and
profile_train_step, bench_train_step, validate_training on its fixture,
tools/test.py on the card against the CPU) and the modules ported last
(compare_inference --eval and FPS with the torch and ONNX engines, the
ONNX engine's APs against the CPU's; run_rehearsal's SIGKILL and
bit-exact auto-resume of the training CLI; ema_ab_table; the band
fixture read back and its APs against test_widerface's; Detector.mesh
over two shards; the augmentation library without OpenCV), shows
through the launch counters that each path ran its kernels, and
times kernels, their plain versions, library yardsticks and the paths
with CUDA events. Any failed check raises, and the script exits
non-zero. There is no CPU path: without a CUDA device it exits non-zero
before printing any result.

The last three lines of standard output are a JSON object of the kernels
({"kernels": [...]}), the card's name and power limit as nvidia-smi reports
them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
IOU, SCORE = 0.45, 0.02
DEV = "cuda"
MAX_GTS = 128          # DataConfig.max_gts
# the whole run must end within 1200 s; past this, stacks and exit
WATCHDOG_S = 1100
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


def face_sample(rng, h, w, n_faces, sizes=None):
    """A noisy background with simple face renders (skin-tone ellipse,
    dark eyes, mouth), drawn with numpy in the style of
    tools/make_synth_wider.py, on which the r04 weights were trained.
    Returns (image (h, w, 3) uint8, boxes (n, 4) xyxy, keypoints (n, 5, 3):
    eyes, nose, mouth corners, visibility 1). Each face is drawn inside
    its own window, with the same pixels as a whole-image draw. A face's
    box is as high as its size: drawn from [24, min(h, w) / 3], or taken
    from ``sizes`` (n_faces of them)."""
    img = rng.randint(40, 200, (h, w, 3)).astype(np.float32)
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    boxes, kps = [], []
    for i in range(n_faces):
        s = rng.uniform(24, min(h, w) / 3) if sizes is None else sizes[i]
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
    from yunet_tpu_torch.ops import (conv_epi, convdp, convdp_cm,
                                     convdp_train, nms, simota)
    libs = libs or {"convdp.cu": convdp.LIB, "nms.cu": nms.LIB,
                    "simota.cu": simota.LIB,
                    "convdp_bwd.cu": convdp_train.LIB,
                    "convdp_cm.cu": convdp_cm.LIB,
                    "scrfd_conv.cu": conv_epi.LIB,
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


def nms_build(path):
    """A NativeLib of another greedy-NMS source with csrc/nms.cu's C
    interface (a scratch copy of an earlier version or a variant), built
    with csrc/nms.cu's flags."""
    from yunet_tpu_torch.ops import nms
    from yunet_tpu_torch.ops._build import NativeLib
    with open(path, "rb") as f:
        src = f.read()
    # csrc/nms.cu's entry points that this source has
    sigs = {name: sig for name, sig in nms.LIB.signatures.items()
            if name.encode() in src}
    return NativeLib(os.path.abspath(path), nms.LIB.compiler, sigs)


def nms_keep_fn(native):
    """greedy_nms_keep driven through another build (a NativeLib from
    nms_build), as greedy_nms_keep runs csrc/nms.cu, without the input
    checks."""
    import torch
    from yunet_tpu_torch.ops import nms
    from yunet_tpu_torch.ops._build import check_cuda_status
    lib = native.get()

    def keep_fn(boxes, counts, iou_thr):
        bsz, k, _ = boxes.shape
        dev = boxes.device
        keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
        if bsz and k:
            mask = torch.empty((bsz, k, nms.mask_words(k)),
                               dtype=torch.int32, device=dev)
            check_cuda_status(lib, lib.yunet_greedy_nms(
                boxes.data_ptr(), counts.data_ptr(), bsz, k,
                float(iou_thr), mask.data_ptr(), keep.data_ptr(),
                dev.index, torch.cuda.current_stream(dev).cuda_stream),
                "greedy NMS build")
        return keep
    return keep_fn


def nms_entry_points(lib, boxes, counts):
    """The mask and the scan launch of a bitmask NMS library (csrc/nms.cu's
    C interface) as closures over boxes and counts, with the scratch mask
    and keep allocated once: for timing each launch alone. The mask runs
    once here, so the scan has its input."""
    import torch
    from yunet_tpu_torch.ops import nms
    from yunet_tpu_torch.ops._build import check_cuda_status
    bsz, k, _ = boxes.shape
    dev = boxes.device
    mask = torch.empty((bsz, k, nms.mask_words(k)), dtype=torch.int32,
                       device=dev)
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def mask_():
        check_cuda_status(lib, lib.yunet_nms_mask(
            boxes.data_ptr(), counts.data_ptr(), bsz, k, IOU,
            mask.data_ptr(), dev.index, stream), "nms mask")

    def scan_():
        check_cuda_status(lib, lib.yunet_nms_scan(
            counts.data_ptr(), bsz, k, mask.data_ptr(), keep.data_ptr(),
            dev.index, stream), "nms scan")

    mask_()
    return mask_, scan_


def nms_scores(rng, counts, p):
    """(B, P) scores under SCORE with counts[b] of image b above it."""
    scores = rng.uniform(0, 0.01, (len(counts), p)).astype(np.float32)
    for b, cnt in enumerate(counts):
        scores[b, rng.choice(p, cnt, replace=False)] = \
            rng.uniform(0.05, 1.0, cnt)
    return scores


def nms_cases():
    """(label, boxes (B, P, 4), scores (B, P), top_k) for phase_nms: every
    batch of the serving path's sizes (B 1, 16, 128 at K=750 and 320^2,
    image 0 with k candidates and the others with up to k), b1 at K=5000
    and 640^2 with k on both sides of a multiple of 32 and all valid, b1
    at the kernel's largest K (nms.MAX_K), all valid, then
    the edge cases: an IoU exactly at the threshold (kept: the test is
    strict) beside one just above it, zero-area, inverted and duplicate
    boxes, and counts on both sides of multiples of 32 in one batch."""
    from yunet_tpu_torch.ops import nms
    rng = np.random.RandomState(0)
    cases = []
    for bsz in (1, 16, 128):
        for k in (0, 1, 12, 60, 512, 750):
            counts = [k] + [rng.randint(0, k + 1) for _ in range(bsz - 1)]
            boxes = np.stack([clustered_boxes(rng, 2100, 320)
                              for _ in range(bsz)])
            cases.append((f"B={bsz} k={k}", boxes,
                          nms_scores(rng, counts, 2100), 750))
    for k in (31, 32, 33, 1000, 5000):
        cases.append((f"B=1 k={k}", clustered_boxes(rng, 8400, 640)[None],
                      nms_scores(rng, [k], 8400), 5000))
    # the largest K the kernel takes, all valid
    cases.append((f"B=1 k={nms.MAX_K}", clustered_boxes(rng, 9800, 640)[None],
                  nms_scores(rng, [nms.MAX_K], 9800), nms.MAX_K))

    # the threshold pair: inter 45 over union 100 is 0.45 in f32, equal
    # to the threshold, so both stay; 4.6 wide gives IoU > 0.45
    boxes = clustered_boxes(rng, 2100, 320)[None]
    scores = nms_scores(rng, [40], 2100) * 0.5
    special = [(1000, 1000, 1010, 1010), (1000, 1000, 1004.5, 1010),
               (2000, 2000, 2010, 2010), (2000, 2000, 2004.6, 2010)]
    for i, box in enumerate(special):
        boxes[0, i], scores[0, i] = box, 0.9 - 0.1 * i
    cases.append(("IoU at the threshold", boxes, scores, 750))

    # 64 pairs with IoUs a few ulps either side of the threshold: box B of
    # pair k is 4.5 + (k - 32) * 2^-21 wide (its ulp), box A 10, both 10
    # high, the pairs far apart
    boxes = clustered_boxes(rng, 2100, 320)[None]
    scores = nms_scores(rng, [0], 2100)
    for k in range(64):
        y0 = 1000.0 + 100.0 * k
        boxes[0, 2 * k] = (0, y0, 10, y0 + 10)
        boxes[0, 2 * k + 1] = (0, y0, 4.5 + (k - 32) * 2.0 ** -21, y0 + 10)
        scores[0, 2 * k:2 * k + 2] = (0.9 - 0.01 * k, 0.895 - 0.01 * k)
    cases.append(("IoUs within ulps of the threshold", boxes, scores, 750))

    # zero-area (x1 == x2, points), inverted (x2 < x1) and duplicate
    # boxes, duplicates with tied and with distinct scores
    boxes = clustered_boxes(rng, 2100, 320)[None].repeat(2, 0)
    scores = nms_scores(rng, [80, 80], 2100)
    for b in range(2):
        top = np.argsort(-scores[b], kind="stable")[:80]
        bx = boxes[b, top]
        bx[0:8, 2] = bx[0:8, 0]                          # zero width
        bx[8:14] = np.tile(bx[8, :2], 2)                  # one point, x6
        bx[14:20, 3] = bx[14:20, 1] - 5                  # inverted
        bx[20:40:2] = bx[21:41:2]                        # duplicate pairs
        boxes[b, top] = bx
        if b:                                            # tie the pairs
            scores[b, top[20:40:2]] = scores[b, top[21:41:2]]
    cases.append(("zero-area, inverted, duplicate", boxes, scores, 750))

    counts = [31, 32, 33, 63, 64, 65, 95, 96, 97]
    boxes = np.stack([clustered_boxes(rng, 2100, 320) for _ in counts])
    cases.append(("counts around multiples of 32", boxes,
                  nms_scores(rng, counts, 2100), 750))
    return cases


def _check_nms(label, boxes, scores, top_k, others):
    """The kernel's dets, keep and idx against the plain version's, the
    per-image entry at B=1, and each other build's keep set. Returns the
    largest absolute difference seen."""
    import torch
    from yunet_tpu_torch.ops.nms import (device_nms, device_nms_batched,
                                         topk_candidates)
    bt = torch.from_numpy(boxes).to(DEV)
    st = torch.from_numpy(scores).to(DEV)
    got = device_nms_batched(bt, st, top_k=top_k, iou_thr=IOU,
                             score_thr=SCORE)
    want = plain_nms_batched(bt, st, top_k)
    torch.cuda.synchronize()
    max_err = 0.0
    for g, w, what in zip(got, want, ("dets", "keep", "idx")):
        if g.numel():
            max_err = max(max_err, float(
                (g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"NMS kernel != plain ({what}), {label}")
    if bt.shape[0] == 1:                         # the per-image entry
        one = device_nms(bt[0], st[0], top_k=top_k)
        if not all(torch.equal(o, w[0]) for o, w in zip(one, want)):
            raise AssertionError(f"per-image NMS != plain, {label}")
    if others:
        top_boxes, _, _, counts = topk_candidates(bt, st, top_k, SCORE)
        for name, keep_fn in others.items():
            if not torch.equal(keep_fn(top_boxes.contiguous(), counts, IOU),
                               want[1]):
                raise AssertionError(f"{name} build's keep != plain, "
                                     f"{label}")
    n = (st >= SCORE).sum(1)
    log(f"[nms] {label} (B={bt.shape[0]}, K={top_k}, candidates "
        f"{int(n.min())}-{int(n.max())}): keep sets equal "
        f"({int(want[1].sum())} kept)")
    return max_err


def phase_nms(others=None, libs=None):
    """The NMS kernel against its plain version on nms_cases(): dets, keep
    and idx EQUAL. Then its times at four shapes: the serving path's b16
    and b128 (K=750, 300 candidates an image), one 640^2 image at K=5000
    (device_nms_pre), all valid, and the same with the 80 candidates a
    real 640^2 detect gives (chip_profile.py). Each shape gets the event
    time per back-to-back call (cuda_ms), the device time per call and the
    host's time to issue one (device_ms), the plain version and the
    bound.
    others maps names to keep functions of other builds (nms_keep_fn):
    each is held equal to the plain version on every case and timed in
    the order others, kernel, kernel, others reversed; each time kept is
    the least of a build's runs. The kernel's two launches are also timed
    alone on the device, and so are those of each build in libs (names to
    NativeLibs) with csrc/nms.cu's C interface. Returns the largest
    difference and {shape: times}."""
    import torch
    from yunet_tpu_torch.ops import nms
    from yunet_tpu_torch.ops.nms import greedy_nms_keep, greedy_nms_keep_plain
    others = others or {}
    cases = nms_cases()
    max_err = max(_check_nms(*case, others) for case in cases)
    _, boxes, scores, top_k = next(c for c in cases
                                   if c[0] == "IoU at the threshold")
    _, keep, idx = plain_nms_batched(torch.from_numpy(boxes).to(DEV),
                                     torch.from_numpy(scores).to(DEV), top_k)
    kept = set(idx[keep].tolist())
    if not {0, 1, 2} <= kept or 3 in kept:
        raise AssertionError("the threshold pair: want boxes 0, 1 and 2 "
                             f"kept and 3 suppressed, kept {sorted(kept)[:8]}")
    rng = np.random.RandomState(1)
    times = {}
    for bsz, kk, cnt in ((16, 750, 300), (128, 750, 300), (1, 5000, 5000),
                         (1, 5000, 80)):
        boxes = torch.from_numpy(np.stack([
            clustered_boxes(rng, kk, 320) for _ in range(bsz)])).to(DEV)
        counts = torch.full((bsz,), cnt, dtype=torch.int32, device=DEV)
        fns = {"kernel": greedy_nms_keep, **others}
        order = list(others) + ["kernel", "kernel"]
        t = {}
        for name in order + order[-3::-1]:
            fn = (lambda f=fns[name]: f(boxes, counts, IOU))
            ms = cuda_ms(fn)
            dev, host = device_ms(fn)
            t.setdefault(name, []).append((ms, dev, host))
            log(f"[nms] time B={bsz} K={kk} n={cnt}, {name}: {ms:.4f} ms "
                f"an event-timed back-to-back call; device {dev:.4f} ms, "
                f"host {host:.4f} ms to issue a call")
        # each launch alone, on the device, for every bitmask build
        alone = {}
        for name, lib in [("kernel", nms.LIB)] + [
                (name, lib) for name, lib in (libs or {}).items()
                if "yunet_nms_mask" in lib.signatures]:
            mk, sc = nms_entry_points(lib.get(), boxes, counts)
            alone[name] = [device_ms(f)[0] for f in (mk, sc)]
            log(f"[nms] time B={bsz} K={kk} n={cnt}, {name}: mask "
                f"{alone[name][0]:.4f} ms, scan {alone[name][1]:.4f} ms "
                "alone on the device")
        plain = cuda_ms(lambda: greedy_nms_keep_plain(boxes, counts, IOU),
                        warmup=1, iters=2, windows=3)
        # the bound: the cnt candidates' boxes and the counts read (boxes
        # past cnt only reach keep entries that are masked), keep written;
        # the IoU work this data needs, ~14 f32 operations for each pair
        # (i, j > i) with i kept, j a candidate
        keep = greedy_nms_keep_plain(boxes, counts, IOU)[:, :cnt]
        pairs = int((keep * (cnt - 1 - torch.arange(cnt, device=DEV))).sum())
        bnd, by = bound_ms(bsz * cnt * 16 + bsz * 4 + bsz * kk,
                           14 * pairs, F32_FLOPS)
        best = {name: [min(x) for x in zip(*v)] for name, v in t.items()}
        times[f"b{bsz}_k{kk}_n{cnt}"] = {
            "ms": best["kernel"][0], "device_ms": best["kernel"][1],
            "host_ms": best["kernel"][2], "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by,
            "mask_ms": alone["kernel"][0], "scan_ms": alone["kernel"][1],
            **{f"{name}_{what}": best[name][i] for name in others
               for i, what in enumerate(("ms", "device_ms", "host_ms"))}}
        log(f"[nms] time B={bsz} K={kk} n={cnt}: plain {plain:.2f} ms, "
            f"bound {bnd:.6f} ms ({by}; {pairs} IoU pairs)")
    return max_err, times


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
    from yunet_tpu_torch.tools.verify_device_kernels import (
        convdp_bf16_call, convdp_f32_call)
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
        err = convdp_f32_call(name, x, w1, b1, wd, bd, relu)
        xb = x.to(torch.bfloat16)
        excess, over = convdp_bf16_call(name, xb, w1, b1, wd, bd, relu)
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
        excess, over = convdp_bf16_call(f"b{bsz} {name}", x, u.w1, u.b1,
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
            f"kept {int(keep.sum())}); the kernel's counts "
            f"{n_cand.tolist()}")
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
    n640 = int((fdet.raw(fdet._input([img640]), conv_kernel=True)[0]
                >= SCORE).sum())
    log(f"[slice] detect 640^2 b1: the kernel's count {n640} of K=5000")
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


GRAPH_CALLS = 8                    # detects a canvas in phase_graph
GRAPH_CANVASES = ((640, 640), (480, 640))
# one canvas more than the graphs a Detector keeps, run to a capture each
# in turn: the last capture evicts the first canvas's graph
GRAPH_EVICT = GRAPH_CANVASES + ((640, 480), (320, 320), (512, 384))
GRAPH_SWEEP = 48                   # solo images in _graph_sweep
# a staged call's two copies, by their names in a profiler trace
STAGE_COPIES = ("Memcpy HtoD (Pinned -> Device)",
                "Memcpy DtoH (Device -> Pinned)")


@contextlib.contextmanager
def _eager():
    """Detectors issue detect's program launch by launch inside the
    block: no graph is captured or replayed, whatever a Detector keeps
    (the rule, ``Graphs.key``, gives no key)."""
    from yunet_tpu_torch.eval.graphs import Graphs
    rule = Graphs.key
    Graphs.key = lambda *_: None
    try:
        yield
    finally:
        Graphs.key = rule


def _graph_run(det, imgs, top_k):
    """det.detect(use_device_nms=True) on each image of one canvas, held
    to the eager program: where a graph ran, the canvas its stage took
    np.array_equal to the call's canvas, and the rows it left in its
    static output and read back into its stage's output to eager
    detect_packed's on the same canvas; every result dict to the one
    those eager rows give. Returns (the number of calls a graph ran,
    captured or replayed; each detect's wall in ms)."""
    from yunet_tpu_torch.eval.detect import _kept_rows, _result, resize_img
    graphed, walls = 0, []
    for i, img in enumerate(imgs):
        t0 = time.perf_counter()
        got = det.detect(img, use_device_nms=True)
        walls.append((time.perf_counter() - t0) * 1e3)
        canvas, scale = resize_img(img, "AUTO")
        graph = det.graphs.kept.get(det.graphs.key(canvas, top_k))
        if graph is not None:
            staged = (graph.stage.x.numpy()[0], graph.stage.packed.numpy(),
                      graph.packed.cpu().numpy())
        want = det.detect_packed(det._input([canvas]), top_k).cpu().numpy()
        if graph is not None:
            graphed += 1
            if not np.array_equal(staged[0], canvas):
                raise AssertionError(f"the stage's canvas != the call's, "
                                     f"call {i} at {canvas.shape[:2]}")
            for rows in staged[1:]:
                if not np.array_equal(rows, want):
                    raise AssertionError(f"graph rows != eager rows, call "
                                         f"{i} at {canvas.shape[:2]}")
        want = _result(*_kept_rows(want, SCORE), scale)
        for k in ("bboxes", "kps", "labels"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"detect's {k} != the eager program's, "
                                     f"call {i} at {canvas.shape[:2]}")
    return graphed, walls


def _unstaged_replay(det, hw, top_k):
    """A graphed detect of a frame of its (h, w) canvas fed as it was
    without a pinned stage, on det's program: a new zeroed canvas that
    the frame is copied into, ``np.stack``, a pageable copy into the
    static input of a graph of ``detect_packed`` alone, the replay, a
    ``.cpu().numpy()`` of its static output. Returns the call, frame ->
    result dict."""
    import torch
    from yunet_tpu_torch.eval.detect import _kept_rows, _result
    x = det._input([np.zeros((*hw, 3), np.uint8)])
    det.detect_packed(x, top_k)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        packed = det.detect_packed(x, top_k)

    def call(img):
        canvas = np.zeros((*hw, 3), dtype=img.dtype)
        canvas[:img.shape[0], :img.shape[1]] = img
        xs = np.stack([canvas])
        if not (det.dtype == torch.bfloat16 and xs.dtype == np.uint8):
            xs = xs.astype(np.float32)
        x.copy_(torch.from_numpy(xs))
        graph.replay()
        return _result(*_kept_rows(packed.cpu().numpy(), SCORE), 1.0)
    return call


def _graph_kernels(det, img, bf16, calls=20):
    """The kernels of ``calls`` replayed detects in a torch.profiler
    trace (chrome trace events of category kernel, as the benchmark
    counts them), a call: every kernel, K4's (convdp_mma_kernel on the
    bf16 route, convdp_kernel in f32) and nms.cu's mask and scan; and the
    copies (category gpu_memcpy), a call: all, and the stage's two, from
    pinned memory and back. Raises unless every call replayed and ran 29
    K4, one of each NMS kernel and one copy each way through the stage."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    replays = det.graphs.replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            det.detect(img, use_device_nms=True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    copies = [e.get("name", "") for e in events
              if e.get("cat") == "gpu_memcpy"]
    k4 = "convdp_mma_kernel" if bf16 else "convdp_kernel"
    got = {"kernels": len(names) / calls,
           k4: sum(k4 in n for n in names) / calls,
           "nms_mask_kernel": sum("nms_mask_kernel" in n
                                  for n in names) / calls,
           "nms_scan_kernel": sum("nms_scan_kernel" in n
                                  for n in names) / calls,
           "copies": len(copies) / calls,
           "copy_names": sorted(set(copies))}
    for name in STAGE_COPIES:
        got[name] = copies.count(name) / calls
    if det.graphs.replays - replays != calls or got[k4] != 29 or \
            got["nms_mask_kernel"] != 1 or got["nms_scan_kernel"] != 1 or \
            any(got[name] != 1 for name in STAGE_COPIES):
        raise AssertionError(f"{det.graphs.replays - replays} replays of "
                             f"{calls}; kernels a call {got}, want 29 {k4}, "
                             f"one NMS mask and scan and one of each of "
                             f"{STAGE_COPIES}")
    return got


def _graph_sweep(cfg, model):
    """detect_sweep's solo path, graphed and eager: GRAPH_SWEEP images of
    the WIDER split's law (1024 wide, 576-1536 high), each with a stale
    size hint, so that each runs solo through detect(use_device_nms=True)
    at its /32 canvas (mode ORIGIN), on a new fused bf16 Detector each
    run, eager, graph, eager, eager, graph (the first warms cuDNN's
    choices and is not kept). Holds the graphed sweep's results equal to
    the eager one's; returns the canvases, those seen more than once, the
    captures and replays, the sweep's wall (ms) each way, and each
    graphed run's captures (``Graphs.record``, ms)."""
    import torch
    from yunet_tpu_torch.eval.detect import Detector, canvas_shape
    from yunet_tpu_torch.eval.graphs import Graphs
    rng = np.random.RandomState(13)
    imgs = [face_image(rng, int(h), 1024, rng.randint(3, 12))
            for h in rng.randint(576, 1537, GRAPH_SWEEP)]
    seen = {}
    for img in imgs:
        key = canvas_shape(*img.shape[:2], "ORIGIN")
        seen[key] = seen.get(key, 0) + 1
    entries = [((lambda im=im: im), (1, 1)) for im in imgs]
    rep = {"images": GRAPH_SWEEP, "canvases": len(seen),
           "canvases_seen_twice_or_more": sum(n > 1 for n in seen.values()),
           "calls_on_those": sum(n for n in seen.values() if n > 1),
           "wall_ms": {"graph": [], "eager": []}, "capture_ms": []}
    want = None
    for i, which in enumerate(("eager", "graph", "eager", "eager", "graph")):
        det = Detector(cfg, model, device=DEV, fused=True)
        captures = []

        def timed_capture(*a, graphs=det.graphs, captures=captures):
            t0 = time.perf_counter()
            graph = Graphs.record(graphs, *a)
            captures.append(round((time.perf_counter() - t0) * 1e3, 3))
            return graph
        det.graphs.record = timed_capture
        ctx = _eager() if which == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = det.detect_sweep(entries, "ORIGIN", use_device_nms=True)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if det.last_sweep_stats["misfit_solo"] != GRAPH_SWEEP:
            raise AssertionError(f"sweep: {det.last_sweep_stats}, want "
                                 f"{GRAPH_SWEEP} solo images")
        want = want or out
        for r, w in zip(out, want):
            for k in ("bboxes", "kps", "labels"):
                if not np.array_equal(r[k], w[k]):
                    raise AssertionError(f"{which} sweep's {k} != the eager "
                                         "sweep's")
        if which == "graph":
            rep["captures_replays"] = [det.graphs.captures,
                                       det.graphs.replays]
            rep["capture_ms"].append(captures)
        if i:
            rep["wall_ms"][which].append(round(wall, 3))
    return rep


def phase_graph(model):
    """A fused Detector's detect with device NMS as a replayed CUDA graph,
    bf16 and f32: GRAPH_CALLS detects at each canvas of GRAPH_CANVASES,
    each held bit for bit to the eager program (``_graph_run``); a graph
    captured at each canvas's second call and replayed from its third;
    the wrappers' launch counters at 29 K4 (bf16: all on the tensor-core
    route) and 2 K3 for each eager call and each capture, and nothing for
    a replay; the canvases of GRAPH_EVICT in turn, each to its capture,
    the last evicting the first, whose next call runs eagerly and the one
    after recaptures; a profiler trace of replayed calls, with 29 K4 and
    nms.cu's two kernels a call; the host's wall a detect, graphed and
    eager in turns. Then ``_graph_sweep``."""
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.eval.detect import Detector, resize_img
    from yunet_tpu_torch.eval.graphs import GRAPHS_KEPT
    cfg = yunet_n()
    rng = np.random.RandomState(9)
    imgs = {hw: [face_image(rng, *hw, rng.randint(2, 9))
                 for _ in range(GRAPH_CALLS)] for hw in GRAPH_EVICT}
    if len(GRAPH_EVICT) != GRAPHS_KEPT + 1:
        raise AssertionError(f"GRAPH_EVICT holds {len(GRAPH_EVICT)} canvases,"
                             f" a Detector keeps {GRAPHS_KEPT} graphs")
    report = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        det = Detector(cfg, model, device=DEV, dtype=dt, fused=True)
        top_k = cfg.test.device_nms_pre
        torch.cuda.synchronize()
        reset_launch_counts()
        graphed, walls = 0, {}
        for hw in GRAPH_CANVASES:
            g, walls[hw] = _graph_run(det, imgs[hw], top_k)
            graphed += g
        torch.cuda.synchronize()
        lc = launch_counts()
        n = len(GRAPH_CANVASES) * GRAPH_CALLS
        # each canvas's eager first call and its capture issue a detect's
        # launches, a replay none; each call's eager reference issues them
        issued = n + 2 * len(GRAPH_CANVASES)
        want = {"fused_conv_dp": 29 * issued, "greedy_nms": 2 * issued,
                "fused_conv_dp_mma": 29 * issued if dt == torch.bfloat16
                else 0}
        got = {k: lc[k] for k in want}
        if got != want:
            raise AssertionError(f"graph {name}: launches {got}, want {want}")
        reps = len(GRAPH_CANVASES) * (GRAPH_CALLS - 2)
        gs = det.graphs
        if (gs.captures, gs.replays) != (len(GRAPH_CANVASES), reps) or \
                graphed != reps + len(GRAPH_CANVASES) or \
                gs.captures + gs.replays != graphed:
            raise AssertionError(
                f"graph {name}: {gs.captures} captures, {gs.replays} replays,"
                f" {graphed} graphed calls; want {len(GRAPH_CANVASES)}, "
                f"{reps}, {reps + len(GRAPH_CANVASES)} graphed, and "
                "captures + replays == graphed")
        calls_ms = {f"{h}x{w}": {"first": round(v[0], 3),
                                 "capture": round(v[1], 3),
                                 "replay_median": round(statistics.median(
                                     v[2:]), 3)}
                    for (h, w), v in walls.items()}
        log(f"[graph] {name}: {n} detects at {list(GRAPH_CANVASES)} == the "
            f"eager program bit for bit; {gs.captures} captures, "
            f"{gs.replays} replays; "
            f"launches {got} (eager calls and captures only); detect wall "
            f"ms {calls_ms}")

        # one canvas past the graphs kept: the first is evicted, then runs
        # eagerly, then captures again (evicting the second)
        ev = Detector(cfg, model, device=DEV, dtype=dt, fused=True)
        for hw in GRAPH_EVICT:
            _graph_run(ev, imgs[hw][:2], top_k)
        first = ev.graphs.key(resize_img(imgs[GRAPH_EVICT[0]][0],
                                         "AUTO")[0], top_k)
        evicted = first not in ev.graphs.kept
        _graph_run(ev, imgs[GRAPH_EVICT[0]][2:5], top_k)
        want = (len(GRAPH_EVICT) + 1, 1, GRAPHS_KEPT)
        got_ev = (ev.graphs.captures, ev.graphs.replays,
                  len(ev.graphs.kept))
        if not evicted or got_ev != want:
            raise AssertionError(
                f"graph {name} eviction: first canvas evicted {evicted}; "
                f"captures, replays, kept {got_ev}, want {want}")
        log(f"[graph] {name}: {len(GRAPH_EVICT)} canvases to a capture "
            f"each, {GRAPHS_KEPT} kept: the first evicted, then eager, "
            "recaptured and replayed; bits equal")
        del ev

        frames = imgs[GRAPH_CANVASES[0]]
        kernels = _graph_kernels(det, frames[0], dt == torch.bfloat16)
        # the benchmark's call: a frame of the canvas's size, the canvas
        # given as a fixed "W,H" mode
        mode = GRAPH_CANVASES[0][::-1]
        unstaged = _unstaged_replay(det, frames[0].shape[:2], top_k)
        for img in frames:
            got = det.detect(img, mode, use_device_nms=True)
            want = unstaged(img)
            for k in ("bboxes", "kps", "labels"):
                if not np.array_equal(got[k], want[k]):
                    raise AssertionError(f"graph {name}: a staged call's {k}"
                                         " != the unstaged replay's")

        def detect(img):
            return det.detect(img, mode, use_device_nms=True)
        # "eager" is detect under _eager()
        calls = {"graph": detect, "unstaged": unstaged, "eager": detect}
        walls = {}
        for which in ("graph", "unstaged", "eager", "eager", "unstaged",
                      "graph"):
            ctx = _eager() if which == "eager" else contextlib.nullcontext()
            with ctx:
                ts = []
                for i in range(200):
                    t0 = time.perf_counter()
                    calls[which](frames[i % GRAPH_CALLS])
                    ts.append(time.perf_counter() - t0)
            walls.setdefault(which, []).append(
                round(statistics.median(ts) * 1e3, 4))
        report[name] = {"kernels_a_call": kernels, "wall_ms": walls,
                        "calls_ms": calls_ms}
        log(f"[graph] {name}: a replayed call in the profiler's trace "
            f"{kernels}; detect wall ms at {mode}, median of 200 (graph "
            f"through the stage, the unstaged replay, eager, eager, the "
            f"unstaged replay, graph in turns): {walls}")
    report["sweep"] = _graph_sweep(cfg, model)
    log(f"[graph] detect_sweep, every image solo: {report['sweep']}")
    return report


def graph_only():
    """phase_graph alone: python3 -c "import chip_smoke as s;
    s.graph_only()" from the repository root. Builds convdp.cu and
    nms.cu."""
    import torch
    from yunet_tpu_torch.ops import convdp, nms
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"convdp.cu": convdp.LIB, "nms.cu": nms.LIB})
    *_, model, _ = load_model()
    log(f"[graph] {smi}: " + json.dumps(phase_graph(model)))


SCRFD_WEIGHTS = os.path.join(ROOT, "portbench", "weights",
                             "scrfd_10g_bnkps.npz")
SCRFD_CONVS = 58                   # the folded forward's convs a detect
# of which add a shortcut in their epilogue (12 BasicBlocks, 2 bottom-up
# and 2 top-down FPN adds) and end in a ReLU
SCRFD_RESIDUALS, SCRFD_RELUS = 16, 36
# the kernels that run a conv, by their names in an H100 trace: the
# port's (csrc/scrfd_conv.cu), cuDNN's implicit-GEMM forward convolutions,
# and the cuBLAS GEMMs of 1x1 convs
CONV_KERNELS = ("fprop", "nvjet")
SCRFD_KERNEL = "scrfd_fprop_kernel"


def _scrfd_detector():
    """A fused bf16 SCRFD-10GF-KPS Detector on the card with the
    benchmark's seeded weights (float16 on disk)."""
    import torch
    from yunet_tpu_torch.config import get_config
    from yunet_tpu_torch.eval.detect import Detector
    cfg = get_config("scrfd_10g_bnkps")
    with np.load(SCRFD_WEIGHTS) as blob:
        sd = {k: torch.from_numpy(blob[k].astype(np.float32))
              for k in blob.files}
    sd.update({k[:-len("running_mean")] + "num_batches_tracked":
               torch.zeros((), dtype=torch.int64)
               for k in list(sd) if k.endswith(".running_mean")})
    return cfg, Detector(cfg, sd, device=DEV, fused=True)


def _replay_kernels(det, img, label, want, calls=20):
    """The kernels of ``calls`` replayed detects of a conv family's
    Detector in a torch.profiler trace, a call: every kernel, the conv
    kernels (CONV_KERNELS) and their time, those of csrc/scrfd_conv.cu,
    the library's (any other conv kernel), cuDNN's channel padding
    (``nhwcAddPaddingKernel``), PyTorch's non-vectorized elementwise
    kernels (the library route's bias adds ran there), the concatenations
    and adds of bf16 maps, the ReLUs, nms.cu's mask and scan, and every
    kernel's name with its count over the calls. Raises unless every call
    replayed and each count that ``want`` names equals its value there
    (passes it, for a callable)."""
    import collections
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    replays = det.graphs.replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            det.detect(img, use_device_nms=True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in events]
    is_conv = [any(k in n for k in CONV_KERNELS) for n in names]
    count = lambda *keys: sum(any(k in n for k in keys)
                              for n in names) / calls
    got = {"kernels": len(names) / calls,
           "conv": sum(is_conv) / calls,
           "conv_us": sum(e["dur"] for e, c in zip(events, is_conv) if c)
           / calls,
           "scrfd_fprop": count(SCRFD_KERNEL),
           "library_conv": sum(c and SCRFD_KERNEL not in n
                               for n, c in zip(names, is_conv)) / calls,
           "padding": count("nhwcAddPaddingKernel"),
           "elementwise": count("at::native::elementwise_kernel"),
           "cat_bf16": sum("CatArray" in n and "OpaqueType<2u>" in n
                           for n in names) / calls,
           "add_bf16": count("CUDAFunctor_add<c10::BFloat16>"),
           "relu": count("threshold", "clamp_min", "relu"),
           "nms_mask_kernel": count("nms_mask_kernel"),
           "nms_scan_kernel": count("nms_scan_kernel"),
           "names": {n[:200]: c for n, c in collections.Counter(
               names).most_common()}}
    off = {k: got[k] for k, v in want.items()
           if not (v(got[k]) if callable(v) else got[k] == v)}
    if det.graphs.replays - replays != calls or off:
        raise AssertionError(f"{label}: {det.graphs.replays - replays} "
                             f"replays of {calls}; off {off}; kernels a "
                             f"call {got}")
    return got


def _conv_calls(det, img, module, conv, forward):
    """The convs of one eager bf16 trunk on ``img``'s canvas, as
    ``module``'s ``forward`` issues them through its ``conv`` function
    (SCRFD's ``scrfd_conv``, RetinaFace's ``retinaface_conv``) and
    csrc/scrfd_conv.cu: (x, folded conv, the other arguments it got by
    name, the kernel's output)."""
    import torch
    from yunet_tpu_torch.eval.detect import resize_img
    real, calls = getattr(module, conv), []

    def record(x, c, residual=None, upsample=1, **kw):
        out = real(x, c, residual, upsample, **kw)
        calls.append((x, c, dict(kw, residual=residual, upsample=upsample),
                      out))
        return out

    record.launches = 0         # the conv function counts itself by name
    canvas = resize_img(img, "AUTO")[0]
    x = torch.from_numpy(canvas).to(DEV)[None].to(det.dtype)
    setattr(module, conv, record)
    try:
        with torch.inference_mode():
            getattr(module, forward)(det.folded, x.permute(0, 3, 1, 2),
                                     det.cfg.model)
        torch.cuda.synchronize()
    finally:
        setattr(module, conv, real)
    return calls


def _epi_args(c, kw):
    """conv_epi's arguments past (x, w, wp, b) for a recorded call."""
    return dict(stride=c.stride, relu=c.relu, residual=kw["residual"],
                upsample=kw["upsample"], post_add=kw.get("post_add", False),
                out=kw.get("out"))


def _conv_check(calls, label, **want):
    """Each conv of ``calls`` (``_conv_calls``), kernel against plain on
    the card, after the calls' counts that ``want`` names (``convs``;
    those with a shortcut, ``residual``; with a ReLU, ``relu``; adding the
    shortcut after the ReLU, ``post_add``; into a slice, ``sliced``). The
    reference is the plain version in f32 on the kernel's bf16 inputs
    (TF32 off): exact products, f32 sums. The kernel sums in f32 too and
    rounds once to bf16, so it must lie within one bf16 rounding of the
    reference, 2^-8 of |ref|, plus 2^-16 of the conv's largest |ref| for
    the sums' other order where an output cancels to near zero: 'err' is
    the largest |kernel - ref| over that tolerance and must stay <= 1. The
    plain version in bf16 (the library route: the conv, the shortcut add
    and the ReLU each rounded) is read against the same tolerance for
    comparison. Then the wrapper must refuse a non-bf16 and a
    non-channels-last CUDA input. Returns the per-conv errors."""
    import torch
    from yunet_tpu_torch.ops.conv_epi import conv_epi, conv_epi_plain
    counts = {"convs": len(calls),
              "residual": sum(kw["residual"] is not None
                              for *_, kw, _ in calls),
              "relu": sum(c.relu for _, c, *_ in calls),
              "post_add": sum(bool(kw.get("post_add"))
                              for *_, kw, _ in calls),
              "sliced": sum(kw.get("out") is not None for *_, kw, _ in calls)}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: counted {counts}, want {want}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    errs = []
    try:
        with torch.inference_mode():
            for x, c, kw, out in calls:
                args = _epi_args(c, kw)
                res, _ = args.pop("residual"), args.pop("out")
                ref = conv_epi_plain(x.float(), c.w.float(), c.b,
                                     residual=None if res is None
                                     else res.float(), **args)
                plain = conv_epi_plain(x, c.w, c.b, residual=res, **args)
                tol = 2.0 ** -8 * ref.abs() + 2.0 ** -16 * ref.abs().max()
                errs.append((float(((out.float() - ref).abs() / tol).max()),
                             float(((plain.float() - ref).abs()
                                    / tol).max())))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    worst = max(e for e, _ in errs)
    if worst > 1.0:
        raise AssertionError(f"{label} conv: kernel off its reference by "
                             f"{worst} of the tolerance; per conv {errs}")
    x, c, *_ = calls[1]
    for bad, what in ((x.float(), "f32"), (x.contiguous(), "NCHW")):
        try:
            conv_epi(bad, c.w, c.wp, c.b, stride=c.stride, relu=c.relu)
        except (TypeError, ValueError):
            continue
        raise AssertionError(f"conv_epi took a {what} CUDA input")
    return errs


def _conv_bound_ms(convs):
    """The least time (ms) for ``convs`` (utils/flops.Conv) on an H100,
    conv by conv: bf16 bytes once, 2 x the multiply-adds at BF16_FLOPS."""
    bound = 0.0
    for cv in convs:
        oh, ow = cv.out
        act = cv.h * cv.w * cv.cin + oh * ow * cv.cout
        wts = cv.cout * cv.cin * cv.k * cv.k + cv.cout
        bound += bound_ms(2 * (act + wts), 2 * cv.macs, BF16_FLOPS)[0]
    return round(bound, 5)


def _conv_times(calls, bound):
    """ms for the convs of ``calls`` issued back to back, each set
    captured as one CUDA graph and replayed: the kernel, its plain version
    (the library route: cuDNN's conv with its bias, then the shortcut add,
    the upsample, the ReLU and the copy into a slice as passes of their
    own) and the one library call that computes a plain conv with its
    bias, F.conv2d, with a ReLU where the conv has one; with ``bound``, the
    least time for them (``_conv_bound_ms``)."""
    import torch
    import torch.nn.functional as F
    from yunet_tpu_torch.ops.conv_epi import conv_epi, conv_epi_plain

    def kernel():
        for x, c, kw, _ in calls:
            conv_epi(x, c.w, c.wp, c.b, **_epi_args(c, kw))

    def plain():
        for x, c, kw, _ in calls:
            conv_epi_plain(x, c.w, c.b, **_epi_args(c, kw))

    def library():
        for x, c, *_ in calls:
            y = F.conv2d(x, c.w, c.b.to(x.dtype), c.stride,
                         c.w.shape[-1] // 2)
            if c.relu:
                y.relu_()

    times = {}
    with torch.inference_mode():
        for name, fn in (("kernel", kernel), ("plain", plain),
                         ("library", library)):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            times[name] = round(cuda_ms(graph.replay, iters=20), 4)
            del graph
    times["bound"] = bound
    return times


# what a replayed SCRFD detect's trace holds a call (_replay_kernels):
# SCRFD_CONVS conv kernels, all the port's, no channel padding, fewer
# elementwise kernels than the library route's bias adds, one NMS mask and
# scan
SCRFD_REPLAY = {"conv": SCRFD_CONVS, "scrfd_fprop": SCRFD_CONVS,
                "library_conv": 0, "padding": 0,
                "elementwise": lambda v: v < SCRFD_CONVS,
                "nms_mask_kernel": 1, "nms_scan_kernel": 1}


def phase_scrfd():
    """SCRFD-10GF-KPS (``get_config("scrfd_10g_bnkps")``, the benchmark's
    weights) through a fused bf16 Detector's detect with device NMS at
    640x640: GRAPH_CALLS detects, each held bit for bit to the eager
    program (``_graph_run``: a replay equals the eager call); on a new
    Detector, the counted convs of three calls, 58 for the eager first,
    58 for the capture, none for the replay, with K3's 2, 2, 0; a
    profiler trace of replayed calls with the conv kernels and one NMS
    mask and scan a call; the host's wall a detect, graphed and eager in
    turns. Before those, each of the SCRFD_CONVS convs of a detect through
    csrc/scrfd_conv.cu against its plain version (_conv_check), the
    wrapper's refusals, and the convs' time through the kernel, the plain
    version and the library (_conv_times); the counters of
    ``conv_epi`` (launches, those with a shortcut, those with a ReLU) read
    58, 16, 36 for the eager call and the capture and 0 for the replay."""
    import torch
    from yunet_tpu_torch.models import scrfd as scrfd_module
    from yunet_tpu_torch.models.scrfd import scrfd_conv
    from yunet_tpu_torch.ops.conv_epi import conv_epi
    from yunet_tpu_torch.utils import flops
    cfg, det = _scrfd_detector()
    top_k = cfg.test.device_nms_pre
    rng = np.random.RandomState(21)
    imgs = [face_image(rng, 640, 640, rng.randint(2, 12))
            for _ in range(GRAPH_CALLS)]
    conv_calls = _conv_calls(det, imgs[0], scrfd_module, "scrfd_conv",
                             "scrfd_forward")
    conv_errs = _conv_check(conv_calls, "scrfd", convs=SCRFD_CONVS,
                            residual=SCRFD_RESIDUALS, relu=SCRFD_RELUS)
    conv_times = _conv_times(conv_calls, _conv_bound_ms(
        flops.scrfd_convs(cfg.model, 640, 640)))
    del conv_calls
    log(f"[scrfd] the {SCRFD_CONVS} convs through csrc/scrfd_conv.cu "
        f"against their plain version in f32: largest error "
        f"{max(e for e, _ in conv_errs):.3f} of the tolerance (the plain "
        f"version in bf16 reads {max(e for _, e in conv_errs):.3f}); "
        f"non-bf16 and non-channels-last inputs refused; ms for the "
        f"{SCRFD_CONVS} convs, graphed: {conv_times}")
    graphed, walls = _graph_run(det, imgs, top_k)
    reps = GRAPH_CALLS - 2
    if (det.graphs.captures, det.graphs.replays, graphed) != (1, reps,
                                                              reps + 1):
        raise AssertionError(
            f"scrfd: {det.graphs.captures} captures, {det.graphs.replays} "
            f"replays, {graphed} graphed calls; want 1, {reps}, {reps + 1}")
    _, fresh = _scrfd_detector()
    counts = []
    for img in imgs[:3]:
        reset_launch_counts()
        before = (scrfd_conv.launches, conv_epi.launches,
                  conv_epi.launches_residual, conv_epi.launches_relu)
        fresh.detect(img, use_device_nms=True)
        torch.cuda.synchronize()
        counts.append((scrfd_conv.launches - before[0],
                       launch_counts()["greedy_nms"],
                       conv_epi.launches - before[1],
                       conv_epi.launches_residual - before[2],
                       conv_epi.launches_relu - before[3]))
    once = (SCRFD_CONVS, 2, SCRFD_CONVS, SCRFD_RESIDUALS, SCRFD_RELUS)
    want = [once, once, (0, 0, 0, 0, 0)]
    if counts != want or (fresh.graphs.captures,
                          fresh.graphs.replays) != (1, 1):
        raise AssertionError(f"scrfd: counted (convs, K3, conv_epi "
                             f"launches, with a shortcut, with a ReLU) a "
                             f"call {counts}, want {want}")
    del fresh
    kernels = _replay_kernels(det, imgs[0], "scrfd", SCRFD_REPLAY)
    wall = {}
    for which in ("graph", "eager", "eager", "graph"):
        ctx = _eager() if which == "eager" else contextlib.nullcontext()
        with ctx:
            ts = []
            for i in range(200):
                t0 = time.perf_counter()
                det.detect(imgs[i % GRAPH_CALLS], use_device_nms=True)
                ts.append(time.perf_counter() - t0)
        wall.setdefault(which, []).append(
            round(statistics.median(ts) * 1e3, 4))
    report = {"calls_ms": {"first": round(walls[0], 3),
                           "capture": round(walls[1], 3),
                           "replay_median": round(statistics.median(
                               walls[2:]), 3)},
              "counted_convs_k3_epilogue": counts,
              "conv_errors_of_tolerance": [round(e, 4) for e, _ in
                                           conv_errs],
              "conv_ms_58": conv_times, "kernels_a_call": kernels,
              "wall_ms": wall}
    log(f"[scrfd] {GRAPH_CALLS} detects at 640x640 == the eager program "
        f"bit for bit; 1 capture, {reps} replays; counted (convs, K3, "
        f"conv_epi launches, with a shortcut, with a ReLU) of an eager "
        f"call, a capture, a replay {counts}; a replayed call "
        f"in the profiler's trace {kernels}; detect wall ms, median of 200 "
        f"(graph, eager, eager, graph in turns): {wall}")
    return report


def scrfd_only():
    """phase_scrfd alone: python3 -c "import chip_smoke as s;
    s.scrfd_only()" from the repository root. Builds nms.cu and
    scrfd_conv.cu."""
    import torch
    from yunet_tpu_torch.ops import conv_epi, nms
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"nms.cu": nms.LIB, "scrfd_conv.cu": conv_epi.LIB})
    log(f"[scrfd] {smi}: " + json.dumps(phase_scrfd()))



RF_WEIGHTS = os.path.join(ROOT, "portbench", "weights", "retinaface_r50.npz")
# the folded forward's convs a detect (the published 82, less 6: a level's
# class, box and landmark heads are one conv), of which the FPN's two finer
# laterals add the level above after their ReLU, and the SSH's 9 branch
# ends and the 3 heads write into a slice of a wider map
RF_CONVS, RF_POST_ADDS, RF_SLICED = 76, 2, 12


def _rf_detector():
    """A fused bf16 RetinaFace-R50 Detector on the card with the
    benchmark's seeded weights (the conv weights drawn from the file's
    seed, the rest read from it)."""
    import torch
    from portbench.weights.make_retinaface_r50 import load
    from yunet_tpu_torch.config import get_config
    from yunet_tpu_torch.eval.detect import Detector
    cfg = get_config("retinaface_r50")
    sd = load(dataclasses.asdict(cfg.model), RF_WEIGHTS, "cpu")
    sd.update({k[:-len("running_mean")] + "num_batches_tracked":
               torch.zeros((), dtype=torch.int64)
               for k in list(sd) if k.endswith(".running_mean")})
    return cfg, Detector(cfg, sd, device=DEV, fused=True)


# what a replayed RetinaFace detect's trace holds a call (_replay_kernels):
# RF_CONVS conv kernels, all the port's, no channel padding, no ReLU, no
# concatenation of bf16 maps (the decode's and the packing's are f32), one
# bf16 add (the input's mean), one NMS mask and scan
RF_REPLAY = {"conv": RF_CONVS, "scrfd_fprop": RF_CONVS, "library_conv": 0,
             "padding": 0, "cat_bf16": 0, "add_bf16": 1, "relu": 0,
             "nms_mask_kernel": 1, "nms_scan_kernel": 1}
# a canvas of another shape than the benchmark's, for the per-conv check
RF_OTHER_CANVAS = (480, 640)


def _rf_convs(cfg, h, w):
    """utils/flops.retinaface_convs at h x w with each level's class, box
    and landmark heads as the one conv the fold runs (they read one map)."""
    from yunet_tpu_torch.utils import flops
    convs = flops.retinaface_convs(cfg.model, h, w)
    heads = [c for c in convs if c.bias]
    levels = len(heads) // 3
    return [c for c in convs if not c.bias] + [
        c._replace(cout=sum(x.cout for x in heads[i::levels]))
        for i, c in enumerate(heads[:levels])]


def _rf_conv_run(det, img, cfg):
    """The per-conv check (``_conv_check``) and graphed times
    (``_conv_times``) of RetinaFace's RF_CONVS convs on ``img``'s
    canvas."""
    from yunet_tpu_torch.models import retinaface as rf
    h, w = img.shape[:2]
    calls = _conv_calls(det, img, rf, "retinaface_conv",
                        "retinaface_forward")
    errs = _conv_check(calls, f"retinaface {h}x{w}", convs=RF_CONVS,
                       post_add=RF_POST_ADDS, sliced=RF_SLICED)
    return errs, _conv_times(calls, _conv_bound_ms(_rf_convs(cfg, h, w)))


def phase_retinaface():
    """RetinaFace-R50 (``get_config("retinaface_r50")``, the benchmark's
    weights) through a fused bf16 Detector's detect with device NMS at
    640x640: each of the RF_CONVS convs of a detect through
    csrc/scrfd_conv.cu against its plain version (_conv_check), at
    640x640 and on a canvas of RF_OTHER_CANVAS, with the wrapper's
    refusals, and the convs' time graphed through the kernel, the plain
    version and the library (_conv_times); GRAPH_CALLS detects, each held
    bit for bit to the eager program (``_graph_run``); on a new Detector,
    the counted convs and ``conv_epi``'s counters (launches, with the
    shortcut after the ReLU, into a slice) of three calls,
    RF_CONVS/RF_POST_ADDS/RF_SLICED for the eager first and the capture,
    none for the replay, with K3's 2, 2, 0; a profiler trace of replayed
    calls (_replay_kernels); the host's wall a detect, graphed and eager in
    turns."""
    import torch
    from yunet_tpu_torch.models.retinaface import retinaface_conv
    from yunet_tpu_torch.ops.conv_epi import conv_epi
    cfg, det = _rf_detector()
    top_k = cfg.test.device_nms_pre
    rng = np.random.RandomState(26)
    imgs = [face_image(rng, 640, 640, rng.randint(2, 12))
            for _ in range(GRAPH_CALLS)]
    other = face_image(rng, *RF_OTHER_CANVAS, 6)
    conv_runs = {}
    for img in (imgs[0], other):
        errs, times = _rf_conv_run(det, img, cfg)
        shape = "x".join(map(str, img.shape[:2]))
        conv_runs[shape] = {"errors_of_tolerance": [round(e, 4)
                                                    for e, _ in errs],
                            "ms_graphed": times}
        log(f"[retinaface] the {RF_CONVS} convs of a {shape} canvas "
            f"through csrc/scrfd_conv.cu against their plain version in "
            f"f32: largest error {max(e for e, _ in errs):.3f} of the "
            f"tolerance (the plain version in bf16 reads "
            f"{max(e for _, e in errs):.3f}); non-bf16 and "
            f"non-channels-last inputs refused; ms for the {RF_CONVS} "
            f"convs, graphed: {times}")
    graphed, walls = _graph_run(det, imgs, top_k)
    reps = GRAPH_CALLS - 2
    if (det.graphs.captures, det.graphs.replays, graphed) != (1, reps,
                                                              reps + 1):
        raise AssertionError(
            f"retinaface: {det.graphs.captures} captures, "
            f"{det.graphs.replays} replays, {graphed} graphed calls; want "
            f"1, {reps}, {reps + 1}")
    _, fresh = _rf_detector()
    counts = []
    for img in imgs[:3]:
        reset_launch_counts()
        before = (retinaface_conv.launches, conv_epi.launches,
                  conv_epi.launches_post_add, conv_epi.launches_sliced)
        fresh.detect(img, use_device_nms=True)
        torch.cuda.synchronize()
        counts.append((retinaface_conv.launches - before[0],
                       launch_counts()["greedy_nms"],
                       conv_epi.launches - before[1],
                       conv_epi.launches_post_add - before[2],
                       conv_epi.launches_sliced - before[3]))
    once = (RF_CONVS, 2, RF_CONVS, RF_POST_ADDS, RF_SLICED)
    want = [once, once, (0, 0, 0, 0, 0)]
    if counts != want or (fresh.graphs.captures,
                          fresh.graphs.replays) != (1, 1):
        raise AssertionError(f"retinaface: counted (convs, K3, conv_epi "
                             f"launches, adding after the ReLU, into a "
                             f"slice) a call {counts}, want {want}")
    del fresh
    kernels = _replay_kernels(det, imgs[0], "retinaface", RF_REPLAY)
    wall = {}
    for which in ("graph", "eager", "eager", "graph"):
        ctx = _eager() if which == "eager" else contextlib.nullcontext()
        with ctx:
            ts = []
            for i in range(200):
                t0 = time.perf_counter()
                det.detect(imgs[i % GRAPH_CALLS], use_device_nms=True)
                ts.append(time.perf_counter() - t0)
        wall.setdefault(which, []).append(
            round(statistics.median(ts) * 1e3, 4))
    report = {"calls_ms": {"first": round(walls[0], 3),
                           "capture": round(walls[1], 3),
                           "replay_median": round(statistics.median(
                               walls[2:]), 3)},
              "counted_convs_k3_epilogue": counts,
              "convs": conv_runs, "kernels_a_call": kernels,
              "wall_ms": wall}
    log(f"[retinaface] {GRAPH_CALLS} detects at 640x640 == the eager "
        f"program bit for bit; 1 capture, {reps} replays; counted (convs, "
        f"K3, conv_epi launches, adding after the ReLU, into a slice) of "
        f"an eager call, a capture, a replay {counts}; detect wall ms, "
        f"median of 200 (graph, eager, eager, graph in turns): {wall}")
    return report


def retinaface_only():
    """phase_retinaface alone: python3 -c "import chip_smoke as s;
    s.retinaface_only()" from the repository root. Builds nms.cu and
    scrfd_conv.cu."""
    import torch
    from yunet_tpu_torch.ops import conv_epi, nms
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"nms.cu": nms.LIB, "scrfd_conv.cu": conv_epi.LIB})
    log(f"[retinaface] {smi}: " + json.dumps(phase_retinaface()))

# -- the WIDER evaluation path -------------------------------------------------

WIDER_DIR = os.path.join(ROOT, "work_dirs", "chip_wider")
WIDER_IMAGES, WIDER_EVENTS = 64, 4
WIDER_STALE = 5            # the image whose labelv2 header is stale


def wider_split(root=WIDER_DIR, n_images=WIDER_IMAGES, seed=5):
    """A WIDER-val-shaped split drawn with face_sample, numpy only, under
    root: n_images over WIDER_EVENTS events, 1024 wide and 576-1536 high,
    3-24 faces an image with heights log-uniform from 8 px to a third of
    the short side (so easy, medium and hard differ), one face in 20
    marked ignored. Writes labelv2.txt (image WIDER_STALE's header says
    64 px more than its height, so the origin-size sweep runs it solo),
    the decoded .npy cache at data/cache.py's layout (root/cache) and the
    GT .mat files (root/gt, the port's write_gt_mats). Returns (labelv2
    path, cache dir, GT dir)."""
    import shutil
    from yunet_tpu_torch.data.cache import cache_path
    from yunet_tpu_torch.tools.make_synth_wider import write_gt_mats
    shutil.rmtree(root, ignore_errors=True)
    cache, gt = os.path.join(root, "cache"), os.path.join(root, "gt")
    rng = np.random.RandomState(seed)
    lines, per_event = [], {}
    for i in range(n_images):
        event = f"{i % WIDER_EVENTS}--Chip"
        stem = f"chip_{i:04d}"
        h, w = int(rng.randint(576, 1537)), 1024
        n = int(rng.randint(3, 25))
        sizes = np.exp(rng.uniform(np.log(8), np.log(min(h, w) / 3), n))
        img, boxes, kps = face_sample(rng, h, w, n, sizes=sizes)
        ign = rng.uniform(size=n) < 0.05
        path = cache_path(cache, f"{event}/{stem}.jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, img)
        lines.append(f"# {event}/{stem}.jpg {w} "
                     f"{h + 64 if i == WIDER_STALE else h}")
        for b, k, ig in zip(boxes, kps, ign):
            vals = " ".join(f"{v:.1f}" for v in b)
            lines.append(vals + " 1" if ig else vals + " " + " ".join(
                f"{x:.1f} {y:.1f} 1" for x, y, _ in k))
        per_event.setdefault(event, []).append((stem, boxes, kps, ign))
    ann = os.path.join(root, "labelv2.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    write_gt_mats(gt, per_event)
    return ann, cache, gt


class _HostClock:
    """Host time spent in wrapped calls, per label. Wrap with
    ``wrap(owner, attr, label, sync)``; ``sync`` ends the call with
    torch.cuda.synchronize() (the device program's work is then inside its
    label). Calls nested in a timed call of the same thread are not
    counted again. ``restore()`` puts every attribute back."""

    def __init__(self):
        import threading
        self.secs, self._saved = {}, []
        self._local = threading.local()

    def wrap(self, owner, attr, label, sync=False):
        import torch
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        self.secs.setdefault(label, 0.0)
        local = self._local

        def timed(*a, **kw):
            if getattr(local, "busy", False):
                return fn(*a, **kw)
            local.busy = True
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                local.busy = False
                self.secs[label] += time.perf_counter() - t0
        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []


def _sorted_dets(r):
    """A result's (bboxes, kps) rows in one order (score, then corners)."""
    b = r["bboxes"]
    order = np.lexsort(tuple(b[:, j] for j in range(4)) + (-b[:, 4],))
    return b[order], r["kps"][order]


def wider_sweep(mode, device_nms, ann, cache, gt, clock=None):
    """python -m yunet_tpu_torch.tools.test_widerface on the split, through
    its main(): yunet_n, r04 EMA weights, bf16, on the card. Returns
    {aps, aps_plain (the same predictions through _wider_match_numpy),
    results (per image, input order), stats (last_sweep_stats), secs (the
    sweep's wall), launches (the counters over the run)}."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.eval import detect as detect_mod
    from yunet_tpu_torch.eval import widerface
    from yunet_tpu_torch.eval.detect import Detector
    from yunet_tpu_torch.tools import test_widerface as cli
    rec = {}
    sweep = Detector.detect_sweep

    def timed_sweep(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(self, *a, **kw)
        torch.cuda.synchronize()
        rec.update(secs=time.perf_counter() - t0, results=out,
                   stats=dict(self.last_sweep_stats))
        return out

    evaluate = cli.wider_evaluation

    def both_matchers(pred, gt_dir, **kw):
        aps = evaluate(pred, gt_dir, **kw)
        real = widerface.native.wider_match
        widerface.native.wider_match = native._wider_match_numpy
        try:
            rec["aps_plain"] = evaluate(pred, gt_dir)
        finally:
            widerface.native.wider_match = real
        return aps

    clock = clock or _HostClock()
    Detector.detect_sweep = timed_sweep
    cli.wider_evaluation = both_matchers
    clock.wrap(cli, "load_cached", "load (prefetch thread)")
    clock.wrap(detect_mod, "resize", "resize")
    clock.wrap(Detector, "_input", "put")
    for prog in ("serve_packed", "detect_packed", "raw"):
        clock.wrap(Detector, prog, "device program", sync=True)
    argv = ["yunet_n", FIXTURE, "--mode", str(mode), "--ann", ann,
            "--gt-dir", gt, "--cache-dir", cache, "--bucket", "32",
            "--eval-log", os.path.join(WIDER_DIR, "eval.log")]
    reset_launch_counts()
    try:
        rec["aps"] = cli.main(argv + (["--device-nms"] if device_nms
                                      else []))
    finally:
        Detector.detect_sweep = sweep
        cli.wider_evaluation = evaluate
        clock.restore()
    torch.cuda.synchronize()
    rec["launches"] = launch_counts()
    return rec


def phase_wider():
    """The WIDER evaluation path on the card: the port's test_widerface
    CLI over wider_split() in mode 0 (640x640 letterbox, the torch resize)
    and mode 2 (origin size, /32 buckets), each with device and host NMS,
    then a fused bf16 Detector's detect_sweep, detect_tta(flip=True) and
    warmup. Checks (each raises): device-NMS detections equal host-NMS
    ones for every image below the cap, APs equal when none saturated;
    the native matcher's APs equal the plain matcher's; the NMS kernel
    ran on every device-NMS sweep and on no host one; the stale header
    ran solo in mode 2 (in mode 0 every image shares the square canvas);
    APs finite in [0, 1]; 29 fused ConvDP launches, all on the bf16
    route, per fused solo detect; a fused bf16 Detector's detections pair
    with those of the same Detector with the ConvDP kernel's plain version
    in its place, and a fused f32 Detector's with an unfused f32 one's
    (phase_slice's tolerances). Each configuration runs twice, the
    second timed: img/s, and the sweep's host time split into the device
    program (issue to finish), the resize, the host->device put, image
    loads on the prefetch thread, and the rest. Returns ({kernel:
    launches on the path}, {configuration: numbers})."""
    import torch
    from yunet_tpu_torch.apis import init_detector
    from yunet_tpu_torch.data.cache import load_cached
    from yunet_tpu_torch.data.labelv2 import parse_labelv2
    from yunet_tpu_torch.eval.detect import Detector

    t0 = time.perf_counter()
    ann, cache, gt = wider_split()
    log(f"[wider] split: {WIDER_IMAGES} images, 1024 wide, 576-1536 high, "
        f"{time.perf_counter() - t0:.1f} s to draw and write")
    launches = {"greedy_nms": 0}
    report = {}
    for mode in (0, 2):
        runs = {}
        for device_nms in (True, False, True, False):
            clock = _HostClock()
            r = wider_sweep(mode, device_nms, ann, cache, gt, clock)
            r["clock"] = clock.secs
            runs[device_nms] = r                 # the second run is kept
        for device_nms, r in runs.items():
            name = f"mode{mode}_{'device' if device_nms else 'host'}_nms"
            lc, st, aps = r["launches"], r["stats"], r["aps"]
            if device_nms != (lc["greedy_nms"] > 0):
                raise AssertionError(f"{name}: NMS kernel launches "
                                     f"{lc['greedy_nms']}")
            if device_nms:
                launches["greedy_nms"] += lc["greedy_nms"]
            if lc["fused_conv_dp"]:
                raise AssertionError(f"{name}: an unfused Detector launched "
                                     "the ConvDP kernel")
            if st["misfit_solo"] != (1 if mode == 2 else 0):
                raise AssertionError(f"{name}: misfit_solo "
                                     f"{st['misfit_solo']}")
            if not all(np.isfinite(a) and 0 <= a <= 1 for a in aps):
                raise AssertionError(f"{name}: APs {aps}")
            if r["aps_plain"] != aps:
                raise AssertionError(f"{name}: native matcher APs {aps} != "
                                     f"plain {r['aps_plain']}")
            c = r["clock"]
            host = {k: c[k] for k in ("device program", "resize", "put",
                                      "load (prefetch thread)")}
            other = r["secs"] - sum(v for k, v in host.items()
                                    if "prefetch" not in k)
            report[name] = {
                "aps": aps, "img_per_s": WIDER_IMAGES / r["secs"],
                "sweep_s": r["secs"], "batches": st["batches"],
                "misfit_solo": st["misfit_solo"],
                "devnms_saturated": st["devnms_saturated"],
                "nms_launches": lc["greedy_nms"],
                **{k.split(" ")[0] + "_s": v for k, v in host.items()},
                "other_host_s": other}
            log(f"[wider] {name}: APs easy/medium/hard "
                f"{aps[0]:.4f} {aps[1]:.4f} {aps[2]:.4f} (plain matcher "
                f"equal); {WIDER_IMAGES} images in {r['secs']:.4f} s = "
                f"{WIDER_IMAGES / r['secs']:.2f} img/s; {st['batches']} "
                f"batches, {st['misfit_solo']} solo, "
                f"{st['devnms_saturated']} saturated, NMS launches "
                f"{lc['greedy_nms']}")
            log(f"[wider] {name}: device program {host['device program']:.4f}"
                f" s, resize {host['resize']:.4f} s "
                f"({host['resize'] / (r['secs'] - host['device program']):.1%}"
                f" of host time), put {host['put']:.4f} s, other host "
                f"{other:.4f} s; loads {host['load (prefetch thread)']:.4f} "
                "s on the prefetch thread")
        dev, hst = runs[True], runs[False]
        sat = dev["stats"]["devnms_saturated"]
        differ = 0
        for a, b in zip(dev["results"], hst["results"]):
            (ab, ak), (bb, bk) = _sorted_dets(a), _sorted_dets(b)
            if not (np.array_equal(ab, bb) and np.array_equal(ak, bk)):
                differ += 1
        if differ > sat or (sat == 0 and dev["aps"] != hst["aps"]):
            raise AssertionError(f"mode {mode}: {differ} images differ "
                                 f"between device and host NMS, {sat} "
                                 "saturated the cap")
        log(f"[wider] mode {mode}: device NMS == host NMS on "
            f"{WIDER_IMAGES - differ} of {WIDER_IMAGES} images ({sat} "
            f"saturated the cap); APs {'equal' if sat == 0 else 'not held'}")

    # the resize's integer ops give the same bytes on the card as on the
    # host; its time on each for the letterbox of mode 0
    from yunet_tpu_torch.eval.detect import canvas_shape
    from yunet_tpu_torch.ops.resize import resize
    recs = parse_labelv2(ann, test_mode=True)[:8]
    host_ms, card_ms = [], []
    for r in recs:
        img = np.ascontiguousarray(load_cached(cache, r.filename))
        h, w = img.shape[:2]
        ch, cw = canvas_shape(h, w, (640, 640))
        # resize_img's letterbox arithmetic
        if h / w > ch / cw:
            size = (int(ch / (h / w)), ch)
        else:
            size = (cw, int(cw * (h / w)))
        cpu = torch.from_numpy(img)
        t0 = time.perf_counter()
        want = resize(cpu, size)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        gpu = cpu.to(DEV)
        got = resize(gpu, size)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"resize on the card != on the host, "
                                 f"{img.shape} -> {size}")
        card_ms.append(cuda_ms(lambda: resize(gpu, size), warmup=1,
                               iters=5, windows=3))
    log(f"[wider] resize of {len(recs)} images to the 640^2 letterbox: "
        f"card bytes == host bytes; host {statistics.median(host_ms):.4f} "
        f"ms, card {statistics.median(card_ms):.4f} ms an image (medians)")

    # a fused bf16 Detector: a sweep with the stale image, TTA, warmup. In
    # bf16 the folded trunk and the unfused one round at other places (BN
    # folded into bf16 weights): on these images a batch that runs no
    # kernel at all already moves a score by more than phase_slice's
    # 0.05. So the kernel is held against its plain version in the same
    # fused bf16 Detector (phase_slice's bf16 tolerances), and the fused
    # path against the unfused one in f32 (phase_slice's f32 tolerances,
    # the same detection counts)
    from yunet_tpu_torch.models import fused as fused_mod
    from yunet_tpu_torch.ops.convdp import fused_conv_dp_plain
    recs = parse_labelv2(ann, test_mode=True)[:6]
    entries = [((lambda r=r: load_cached(cache, r.filename)),
                (r.height, r.width)) for r in recs]
    udet = init_detector("yunet_n", FIXTURE, device=DEV)
    fdet = Detector(udet.cfg, udet.model, device=DEV, fused=True)
    f32 = [Detector(udet.cfg, udet.model, device=DEV, dtype=torch.float32,
                    fused=fused) for fused in (True, False)]
    img = np.ascontiguousarray(load_cached(cache, recs[0].filename))
    steps = [("detect_sweep", 1, lambda d: d.detect_sweep(
                 entries, "ORIGIN", use_device_nms=True)),
             ("detect_tta", 2, lambda d: [d.detect_tta(img, flip=True)]),
             ("warmup", 1, lambda d: d.warmup([img.shape[:2]]))]
    fused_launches = {"fused_conv_dp": 0, "fused_conv_dp_mma": 0}
    for what, solo, run in steps:
        torch.cuda.synchronize()
        reset_launch_counts()
        got = run(fdet) or []
        torch.cuda.synchronize()
        lc = launch_counts()
        if lc["fused_conv_dp"] != 29 * solo or \
                lc["fused_conv_dp_mma"] != 29 * solo:
            raise AssertionError(f"fused {what}: ConvDP launches {lc}, want "
                                 f"{29 * solo}, all on the bf16 route")
        for k in fused_launches:
            fused_launches[k] += lc[k]
        # eagerly: a graph keeps the kernels of its capture
        kernel = fused_mod.fused_conv_dp
        fused_mod.fused_conv_dp = fused_conv_dp_plain
        try:
            with _eager():
                plain = run(fdet) or []
        finally:
            fused_mod.fused_conv_dp = kernel
        for g, w in zip(got, plain):
            _match(g, w, atol=2.0, rtol=2e-2, score_atol=0.05,
                   min_score=0.1)
        for g, w in zip(run(f32[0]) or [], run(f32[1]) or []):
            _match(g, w, atol=1e-2, rtol=1e-4, score_atol=1e-4)
        off = 0
        for g, w in zip(got, run(udet) or []):
            try:
                _match(g, w, atol=2.0, rtol=2e-2, score_atol=0.05,
                       min_score=0.1)
            except AssertionError:
                off += 1
        log(f"[wider] fused {what}: {lc['fused_conv_dp']} ConvDP launches "
            f"({solo} solo detect(s), all on the bf16 route); bf16 "
            "detections pair with the plain ConvDP's, f32 fused with f32 "
            f"unfused; bf16 fused against bf16 unfused: {off} of "
            f"{len(got)} results outside phase_slice's bf16 tolerances")
    launches["fused_conv_dp"] = fused_launches["fused_conv_dp"]
    launches["fused_conv_dp_mma"] = fused_launches["fused_conv_dp_mma"]
    return launches, report


def wider_only():
    """phase_wider alone, for quick work on the WIDER path:
    python3 -c "import chip_smoke as s; s.wider_only()" from the
    repository root. Builds only the kernels the path runs (csrc/nms.cu,
    csrc/convdp.cu) and the host routines (csrc/host_nms.cpp)."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import convdp, nms
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"nms.cu": nms.LIB, "convdp.cu": convdp.LIB,
                 "host_nms.cpp": native.LIB})
    launches, report = phase_wider()
    log(f"[wider] launches {launches}")
    log(f"[wider] {smi}: " + json.dumps(report))


# -- the training entry point ------------------------------------------------

FIT_DIR = os.path.join(ROOT, "work_dirs", "chip_fit")
FIT_STEPS, FIT_RESUME_STEPS, FIT_FUSED_STEPS = 12, 16, 4
# the throughput run: logged every FIT_RATE_LOG steps, read after the
# first two logs (by then the loader's and the staging thread's queues,
# filled while the model was built, have drained)
FIT_RATE_STEPS, FIT_RATE_LOG = 48, 8
# the eval APs after FIT_STEPS steps may fall this far below r04's at most.
# Not a two-sided band: at the warmup's lr the weights barely move, but BN's
# running statistics (momentum 0.1) move 72% of the way to the training
# split's in 12 steps, which can raise the APs by more than this
FIT_AP_TOL = 0.05


def _patched(owner, attr, wrap):
    """Replace owner.attr by wrap(original); returns a function that puts
    the original back."""
    fn = getattr(owner, attr)
    setattr(owner, attr, wrap(fn))
    return lambda: setattr(owner, attr, fn)


def _timed(calls):
    """A wrapper that appends each call's host seconds (ending in a
    synchronize) to ``calls``."""
    import torch

    def wrap(fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            return out
        return timed
    return wrap


def _metrics(work_dir, mode):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r["mode"] == mode]


def train_cli(argv):
    """python -m yunet_tpu_torch.tools.train through its main() on the
    card, with the launch counters from zero. Returns {launches, first
    host batch, first staged batch (on the CPU), eval seconds per call,
    checkpoint save and load seconds per call, secs}. The first staged
    batch is copied to the host right where the step would read it: on
    the current stream, after the staging copy's event."""
    import torch
    from yunet_tpu_torch.eval import eval_hook as hook_mod
    from yunet_tpu_torch.tools import train as cli
    from yunet_tpu_torch.train import loop as loop_mod
    rec = {"eval_s": [], "save_s": [], "load_s": []}

    def tee_prefetch(prefetch):
        def wrapped(iterator, *, device, depth=2):
            def host():
                for b in iterator:
                    rec.setdefault("host", {k: np.array(v)
                                            for k, v in b.items()})
                    yield b
            for staged in prefetch(host(), device=device, depth=depth):
                if "staged" not in rec:
                    rec["staged"] = {k: v.cpu() for k, v in staged.items()}
                yield staged
        return wrapped

    def timed_hook(make):
        def wrapped(*a, **kw):
            return _timed(rec["eval_s"])(make(*a, **kw))
        return wrapped

    restore = [_patched(loop_mod, "device_prefetch", tee_prefetch),
               _patched(hook_mod, "make_wider_eval_hook", timed_hook),
               _patched(loop_mod, "save_checkpoint", _timed(rec["save_s"])),
               _patched(loop_mod, "load_checkpoint", _timed(rec["load_s"]))]
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rec["ts"] = cli.main(argv, device=DEV)
    finally:
        for r in restore:
            r()
    torch.cuda.synchronize()
    rec["secs"] = time.perf_counter() - t0
    rec["launches"] = launch_counts()
    return rec


def _check_staged(rec, what):
    import torch
    host, staged = rec["host"], rec["staged"]
    if sorted(host) != sorted(staged):
        raise AssertionError(f"{what}: staged keys {sorted(staged)}")
    for k, v in host.items():
        if not torch.equal(staged[k], torch.from_numpy(v)):
            raise AssertionError(f"{what}: the first staged batch's {k} "
                                 "differs from the host batch")


def loader_rates(ann, cache, batches=8):
    """img/s of the TrainLoader alone (no step), yunet_n's 640^2 b16 spec,
    after 2 warm-up batches: {workers: img/s} for no workers (one process)
    over 2 batches, the 4 of data.workers, and one for each CPU this
    process may run on."""
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.data.dataset import SampleSpec
    from yunet_tpu_torch.data.loader import TrainLoader
    d = yunet_n().data
    spec = SampleSpec(img_size=d.img_size, max_gts=d.max_gts,
                      crop_choice=d.crop_choice, flip_ratio=d.flip_ratio)
    out = {}
    for workers in sorted({0, d.workers, len(os.sched_getaffinity(0))}):
        n = 2 if workers == 0 else batches
        loader = TrainLoader(ann, os.path.join(FIT_DIR, "no_images"),
                             batch_size=d.samples_per_device, spec=spec,
                             num_workers=workers, decoded_cache=cache)
        try:
            it = iter(loader)
            for _ in range(2 if workers else 0):
                next(it)
            t0 = time.perf_counter()
            for _ in range(n):
                next(it)
            out[workers] = n * d.samples_per_device / (
                time.perf_counter() - t0)
        finally:
            loader.close()
    return out


def step_alone_ms(sd, batch):
    """ms a step of the shipped yunet_n config at 640^2 b16 on one staged
    batch, the loader out of the way (CUDA events, cuda_ms)."""
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.train import init_train_state, make_train_step
    cfg = yunet_n()
    ts, opt = init_train_state(cfg, steps_per_epoch=1000,
                               total_batch=cfg.data.samples_per_device,
                               device=DEV, state_dict=sd)
    step = make_train_step(cfg, ts.model, opt, img_size=cfg.data.img_size)
    batch = {k: v.to(DEV) for k, v in batch.items() if k != "num_overflow"}
    return cuda_ms(lambda: step(ts, batch), warmup=2, iters=3)


def phase_fit(sd):
    """The training entry point on the card:
    python -m yunet_tpu_torch.tools.train through its main(), yunet_n at
    full width, 640^2 b16 bf16, from the r04 EMA weights as a .pth, on a
    seeded 64-image train split (wider_split with its own root and seed:
    1024 wide, 576-1536 high, landmarks, decoded .npy cache, 4 forked
    loader workers, 4 steps an epoch), with the WIDER eval hook on a
    second split (phase_wider's) in mode 0 with device NMS.

      1. FIT_STEPS steps, a checkpoint every epoch, the eval every 3
         epochs. Checks: every logged loss finite; checkpoints at steps 4,
         8 and 12 and `latest` at 12; the first staged batch equal to its
         host batch; 2 K1 launches a step; K2 launches in the eval; the
         eval's APs equal to test_widerface's on the step-12 checkpoint
         (through init_detector) and at most FIT_AP_TOL below its APs on
         the r04 weights, in the same mode.
      2. --auto-resume to FIT_RESUME_STEPS: starts at 12 (the loader's
         first batch is the stream's 13th), 2 K1 launches a step, step 16
         checkpointed.
      3. FIT_FUSED_STEPS steps with train.fused_kernels: 29 K4 and 29 K5
         launches a step, all on the bf16 route.
      4. FIT_RATE_STEPS shipped steps without eval: the loader-fed img/s
         from metrics.jsonl once the queues filled at start have drained.
    Then the loader alone (TrainLoader with no step) and the shipped step
    alone on a staged batch, to tell which sets the pace. Returns ({kernel:
    launches over the four runs}, {report})."""
    import shutil
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.data.dataset import SampleSpec
    from yunet_tpu_torch.data.loader import TrainLoader
    from yunet_tpu_torch.tools import test_widerface

    t0 = time.perf_counter()
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    train_ann, train_cache, _ = wider_split(os.path.join(FIT_DIR, "train"),
                                            seed=6)
    val_ann, val_cache, val_gt = wider_split(os.path.join(FIT_DIR, "val"))
    pth = os.path.join(FIT_DIR, "r04_ema.pth")
    torch.save({"state_dict": sd}, pth)
    log(f"[fit] train and val splits ({WIDER_IMAGES} images each) and the "
        f".pth: {time.perf_counter() - t0:.1f} s")
    ref_aps = test_widerface.main([
        "yunet_n", FIXTURE, "--mode", "0", "--device-nms", "--ann", val_ann,
        "--gt-dir", val_gt, "--cache-dir", val_cache,
        "--eval-log", os.path.join(FIT_DIR, "eval.log")], device=DEV)

    work = os.path.join(FIT_DIR, "shipped")
    common = ["yunet_n", "--work-dir", work, "--load-pth", pth,
              "--eval-interval", "3", "--eval-mode", "0",
              "--eval-device-nms", "--eval-cache-dir", val_cache,
              "--eval-ann", val_ann, "--eval-gt-dir", val_gt]
    opts = ["--cfg-options", f"data.train_ann={train_ann}",
            "data.train_img_prefix=" + os.path.join(FIT_DIR, "no_images"),
            f"data.decoded_cache={train_cache}", "data.workers=4",
            "train.checkpoint_interval=1", "train.log_interval=2"]
    runs = {}

    # 1. the shipped run
    r = runs["shipped"] = train_cli(common + ["--max-steps", str(FIT_STEPS)]
                                    + opts)
    _check_staged(r, "shipped run")
    rows, vals = _metrics(work, "train"), _metrics(work, "val")
    if [x["step"] for x in rows] != list(range(2, FIT_STEPS + 1, 2)):
        raise AssertionError(f"logged steps {[x['step'] for x in rows]}")
    if not all(np.isfinite(x["loss"]) for x in rows):
        raise AssertionError("a logged loss is not finite")
    want = [f"ckpt_{s:08d}" for s in (4, 8, 12)]
    have = sorted(d for d in os.listdir(work) if d.startswith("ckpt_"))
    with open(os.path.join(work, "latest")) as f:
        latest = os.path.basename(f.read().strip())
    if have != want or latest != want[-1]:
        raise AssertionError(f"checkpoints {have}, latest {latest}")
    lc = r["launches"]
    if lc["simota_streamed"] != 2 * FIT_STEPS:
        raise AssertionError(f"K1 launches {lc['simota_streamed']}, want "
                             f"{2 * FIT_STEPS}")
    if lc["greedy_nms"] <= 0 or [v["step"] for v in vals] != [FIT_STEPS]:
        raise AssertionError(f"eval: K2 launches {lc['greedy_nms']}, val "
                             f"rows {vals}")
    aps = [vals[0][k] for k in ("easy", "medium", "hard")]
    ckpt_aps = test_widerface.main([
        "yunet_n", os.path.join(work, want[-1]), "--mode", "0",
        "--device-nms", "--ann", val_ann, "--gt-dir", val_gt,
        "--cache-dir", val_cache,
        "--eval-log", os.path.join(FIT_DIR, "eval.log")], device=DEV)
    if list(ckpt_aps) != aps:
        raise AssertionError(f"eval hook APs {aps} != test_widerface's on "
                             f"the step-{FIT_STEPS} checkpoint {ckpt_aps}")
    if any(a < r - FIT_AP_TOL for a, r in zip(aps, ref_aps)):
        raise AssertionError(f"eval APs {aps} after {FIT_STEPS} steps fell "
                             f"more than {FIT_AP_TOL} below r04's through "
                             f"test_widerface {list(ref_aps)}")
    log(f"[fit] shipped: {FIT_STEPS} steps in {r['secs']:.2f} s, losses "
        f"{[round(x['loss'], 4) for x in rows]}, img/s "
        f"{[round(x['imgs_per_sec'], 2) for x in rows]}; eval APs {aps} "
        f"(r04: {[round(a, 4) for a in ref_aps]}); launches {lc}")

    # 2. the resume
    r = runs["resume"] = train_cli(
        common + ["--auto-resume", "--max-steps", str(FIT_RESUME_STEPS)]
        + opts)
    rows = _metrics(work, "train")
    new = [x["step"] for x in rows[FIT_STEPS // 2:]]
    if new != list(range(FIT_STEPS + 2, FIT_RESUME_STEPS + 1, 2)):
        raise AssertionError(f"resumed run logged steps {new}")
    if not all(np.isfinite(x["loss"]) for x in rows):
        raise AssertionError("a resumed loss is not finite")
    if r["ts"].step != FIT_RESUME_STEPS or len(r["load_s"]) != 1:
        raise AssertionError(f"resume: step {r['ts'].step}, "
                             f"{len(r['load_s'])} checkpoint loads")
    if not os.path.isdir(os.path.join(work, f"ckpt_{FIT_RESUME_STEPS:08d}")):
        raise AssertionError("no checkpoint at the resumed run's last step")
    lc = r["launches"]
    if lc["simota_streamed"] != 2 * (FIT_RESUME_STEPS - FIT_STEPS):
        raise AssertionError(f"resume: K1 launches {lc['simota_streamed']}")
    d = yunet_n().data
    bsz, size = r["host"]["image"].shape[:2]      # the run's batch shape
    spec = SampleSpec(img_size=size, max_gts=r["host"]["gt_valid"].shape[1],
                      crop_choice=d.crop_choice, flip_ratio=d.flip_ratio)
    cursor = TrainLoader(train_ann, os.path.join(FIT_DIR, "no_images"),
                         batch_size=bsz, spec=spec, num_workers=0,
                         decoded_cache=train_cache, start_step=FIT_STEPS)
    try:
        want_batch = next(iter(cursor))
    finally:
        cursor.close()
    for k, v in want_batch.items():
        if not np.array_equal(r["host"][k], v):
            raise AssertionError(f"resume: the first batch's {k} is not the "
                                 f"stream's batch {FIT_STEPS + 1}")
    _check_staged(r, "resumed run")
    log(f"[fit] resume: {FIT_STEPS} -> {FIT_RESUME_STEPS} in "
        f"{r['secs']:.2f} s, losses {[round(x['loss'], 4) for x in rows]}; "
        f"launches {lc}")

    # 3. the fused run
    fwork = os.path.join(FIT_DIR, "fused")
    r = runs["fused"] = train_cli(
        ["yunet_n", "--work-dir", fwork, "--load-pth", pth,
         "--max-steps", str(FIT_FUSED_STEPS), "--force-experimental"]
        + opts + ["train.fused_kernels=true"])
    _check_staged(r, "fused run")
    lc, n = r["launches"], 29 * FIT_FUSED_STEPS
    want = {"fused_conv_dp": n, "fused_conv_dp_mma": n, "convdp_bwd": n,
            "convdp_bwd_mma": n, "simota_streamed": 2 * FIT_FUSED_STEPS}
    if any(lc[k] != v for k, v in want.items()):
        raise AssertionError(f"fused run: launches {lc}, want {want}")
    frows = _metrics(fwork, "train")
    if not all(np.isfinite(x["loss"]) for x in frows):
        raise AssertionError("a fused loss is not finite")
    log(f"[fit] fused: {FIT_FUSED_STEPS} steps in {r['secs']:.2f} s, losses "
        f"{[round(x['loss'], 4) for x in frows]}; launches {lc}")

    # 4. the loader-fed rate past the queues' start, no eval
    twork = os.path.join(FIT_DIR, "throughput")
    r = runs["throughput"] = train_cli(
        ["yunet_n", "--work-dir", twork, "--load-pth", pth,
         "--max-steps", str(FIT_RATE_STEPS)] + opts
        + [f"train.log_interval={FIT_RATE_LOG}",
           f"train.checkpoint_interval={FIT_RATE_STEPS}"])
    if r["launches"]["simota_streamed"] != 2 * FIT_RATE_STEPS:
        raise AssertionError(f"throughput run: launches {r['launches']}")
    trows = _metrics(twork, "train")
    if not all(np.isfinite(x["loss"]) for x in trows):
        raise AssertionError("a throughput-run loss is not finite")
    fed = trows[2:]
    fed_ips = len(fed) / sum(1 / x["imgs_per_sec"] for x in fed)

    # which sets the pace: the loader alone, the step alone
    rows = _metrics(work, "train")[:FIT_STEPS // 2]
    rates = loader_rates(train_ann, train_cache)
    step_ms = step_alone_ms(sd, runs["shipped"]["staged"])
    bsz = runs["shipped"]["staged"]["image"].shape[0]
    launches = {}
    for run in runs.values():
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    shipped = runs["shipped"]
    report = {
        "loader_fed_train_img_s": fed_ips,
        "loader_fed_train_img_s_per_interval":
            [x["imgs_per_sec"] for x in trows],
        "shipped_run_img_s_per_interval": [x["imgs_per_sec"] for x in rows],
        "loader_alone_img_s": rates,
        "step_alone_ms": step_ms,
        "step_alone_img_s": bsz / (step_ms / 1e3),
        "cpu_count": os.cpu_count(),
        "cpu_affinity": len(os.sched_getaffinity(0)),
        "eval_hook_s": shipped["eval_s"] + runs["resume"]["eval_s"],
        "checkpoint_save_ms": [s * 1e3 for s in shipped["save_s"]],
        "checkpoint_load_ms": [s * 1e3 for s in runs["resume"]["load_s"]],
        "run_secs": {k: v["secs"] for k, v in runs.items()},
        "eval_aps": aps, "r04_aps": list(ref_aps),
        "launches": {k: v["launches"] for k, v in runs.items()}}
    pace = ("the loader" if fed_ips < 0.8 * report["step_alone_img_s"]
            else "the step")
    log(f"[fit] loader-fed train {fed_ips:.2f} img/s (steps "
        f"{2 * FIT_RATE_LOG + 1}-{FIT_RATE_STEPS}), loader "
        f"alone {', '.join(f'{w} workers {v:.2f}' for w, v in rates.items())}"
        f" img/s, step alone {step_ms:.4f} ms "
        f"({report['step_alone_img_s']:.2f} img/s): {pace} sets the pace; "
        f"os.cpu_count() {os.cpu_count()}, affinity "
        f"{report['cpu_affinity']}; eval hook "
        f"{[round(s, 4) for s in report['eval_hook_s']]} s; checkpoint save "
        f"{[round(s, 3) for s in report['checkpoint_save_ms']]} ms, load "
        f"{[round(s, 3) for s in report['checkpoint_load_ms']]} ms")
    return launches, report


def fit_only():
    """phase_fit alone, for quick work on the training entry point:
    python3 -c "import chip_smoke as s; s.fit_only()" from the repository
    root. Builds only the kernels the path runs (csrc/simota.cu,
    csrc/nms.cu, csrc/convdp.cu, csrc/convdp_bwd.cu) and the host routines
    (csrc/host_nms.cpp)."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import convdp, convdp_train, nms, simota
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    watchdog(WATCHDOG_S)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"simota.cu": simota.LIB, "nms.cu": nms.LIB,
                 "convdp.cu": convdp.LIB, "convdp_bwd.cu": convdp_train.LIB,
                 "host_nms.cpp": native.LIB})
    _, sd, _, _ = load_model()
    launches, report = phase_fit(sd)
    log(f"[fit] launches {launches}")
    log(f"[fit] {smi}: " + json.dumps(report))


# -- device-side augmentation ----------------------------------------------

DEVAUG_DIR = os.path.join(ROOT, "work_dirs", "chip_device_aug")
DEVAUG_STEPS, DEVAUG_RESUME_STEPS, DEVAUG_RATE_STEPS = 12, 16, 48
# the producer alone: batches timed after the queue's prefetched ones
DEVAUG_PRODUCER_BATCHES = 32


def fit_train_split():
    """phase_fit's 64-image train split and its .npy cache, drawn when
    phase_fit has not run: (labelv2 path, cache dir)."""
    root = os.path.join(FIT_DIR, "train")
    ann, cache = os.path.join(root, "labelv2.txt"), os.path.join(root,
                                                                  "cache")
    if not os.path.exists(ann):
        ann, cache, _ = wider_split(root, seed=6)
    return ann, cache


def _check_resample(bank_dev, bank_cpu, geo, out_size, max_scale):
    """The card's device_resample against the CPU's on the same bank and
    geometry, tiled (the step's route): f32 within 1e-4, bf16 equal (or
    within one bf16 ulp, with the share of differing values); and the
    card's dense route equal to its tiled one in bf16. Returns
    {f32_max_abs, bf16_max_abs, bf16_share_differing, bf16_max_ulps}."""
    import torch
    from yunet_tpu_torch.data.device_aug import device_resample
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kw = dict(out_size=out_size, dtype=dt, max_scale=max_scale)
        card = device_resample(bank_dev, *(g.to(DEV) for g in geo),
                               **kw).cpu()
        host = device_resample(bank_cpu, *geo, **kw)
        diff = (card.float() - host.float()).abs()
        out[f"{name}_max_abs"] = float(diff.max())
        if name == "f32":
            if out["f32_max_abs"] > 1e-4:
                raise AssertionError(f"device_resample f32: card and CPU "
                                     f"differ by {out['f32_max_abs']}")
            continue
        # one bf16 ulp of the CPU's value: 2^(exponent - 7)
        ulp = torch.ldexp(torch.ones_like(diff), torch.frexp(
            host.float()).exponent - 8)
        ulps = diff / ulp
        out["bf16_share_differing"] = float((diff > 0).float().mean())
        out["bf16_max_ulps"] = float(ulps.max())
        if out["bf16_max_ulps"] > 1:
            raise AssertionError(f"device_resample bf16: card and CPU "
                                 f"differ by {out['bf16_max_ulps']} ulps")
        dense = device_resample(bank_dev, *(g.to(DEV) for g in geo),
                                out_size=out_size, dtype=dt).cpu()
        if not torch.equal(dense, card):
            raise AssertionError("device_resample bf16: dense and tiled "
                                 "differ on the card")
    return out


def phase_device_aug(sd):
    """Device-side augmentation on the card, yunet_n 640^2 b16 bf16 on
    phase_fit's 64-image train split read from the .npy cache:

      1. a DeviceAugLoader (the ImageBank built on the host with
         resize_area) and the bank staged into card memory; its bytes and
         seconds; the staged bank equal to the host's;
      2. device_resample on the card against the CPU's on the same bank
         and the loader's first geometry batch (_check_resample);
      3. device_resample alone per b16 batch, dense against tiled, bf16
         and f32 (tools/bench_resample.py, interleaved windows);
      4. the producer thread alone (geometry batches a second, no step)
         and the device-aug step alone on one batch;
      5. the training CLI with data.device_aug=true: DEVAUG_STEPS steps
         with a checkpoint every epoch, --auto-resume to
         DEVAUG_RESUME_STEPS (the resumed loader's first batch is the
         stream's 13th), then DEVAUG_RATE_STEPS steps for the fed img/s
         (from metrics.jsonl after the first two logs). Checks finite
         losses, the checkpoints, the first staged batch equal to its host
         batch, the staging log line and 2 K1 launches a step.
    Returns ({kernel: launches over the three CLI runs}, {report})."""
    import shutil
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.data.dataset import SampleSpec
    from yunet_tpu_torch.data.device_aug import AUG_KEYS, DeviceAugLoader
    from yunet_tpu_torch.tools import bench_resample

    t0 = time.perf_counter()
    shutil.rmtree(DEVAUG_DIR, ignore_errors=True)
    ann, cache = fit_train_split()
    pth = os.path.join(DEVAUG_DIR, "r04_ema.pth")
    os.makedirs(DEVAUG_DIR)
    torch.save({"state_dict": sd}, pth)
    cfg = yunet_n()
    d = cfg.data
    spec = SampleSpec(img_size=d.img_size, max_gts=d.max_gts,
                      crop_choice=d.crop_choice, flip_ratio=d.flip_ratio)
    no_images = os.path.join(FIT_DIR, "no_images")
    max_scale = max(d.crop_choice) * d.bank_size / d.img_size
    rep = {}

    # 1. the bank
    t = time.perf_counter()
    loader = DeviceAugLoader(ann, no_images, batch_size=d.samples_per_device,
                             spec=spec, seed=cfg.train.seed,
                             bank_size=d.bank_size,
                             bank_canvas=d.bank_canvas, decoded_cache=cache)
    try:
        rep["bank_build_s"] = time.perf_counter() - t
        n = len(loader.bank)
        rep["bank_images"] = n
        rep["bank_build_ms_per_image"] = rep["bank_build_s"] * 1e3 / n
        torch.cuda.synchronize()
        t = time.perf_counter()
        bank = loader.bank.to_device(DEV)
        torch.cuda.synchronize()
        rep["staging_s"] = time.perf_counter() - t
        rep["bank_gb"] = bank.numel() / 1e9
        rep["staging_gb_s"] = rep["bank_gb"] / rep["staging_s"]
        bank_cpu = torch.from_numpy(loader.bank.images)
        if not torch.equal(bank.cpu(), bank_cpu):
            raise AssertionError("the staged bank differs from the host's")
        log(f"[device_aug] bank: {n} images ({rep['bank_gb']:.4f} GB) built "
            f"on the host in {rep['bank_build_s']:.3f} s "
            f"({rep['bank_build_ms_per_image']:.2f} ms an image), staged in "
            f"{rep['staging_s']:.4f} s ({rep['staging_gb_s']:.2f} GB/s)")

        # 2. the card against the CPU
        it = iter(loader)
        batches = [next(it) for _ in range(3)]
        geos = [tuple(torch.from_numpy(b[k]) for k in AUG_KEYS)
                for b in batches]
        rep["resample_check"] = _check_resample(bank, bank_cpu, geos[0],
                                                d.img_size, max_scale)
        log(f"[device_aug] device_resample card vs CPU (b16 640^2, tiled): "
            f"{rep['resample_check']}")

        # 3. the resample alone, dense against tiled
        rep["resample_bench"] = bench_resample.run(
            bank, [tuple(g.to(DEV) for g in geo) for geo in geos],
            out_size=d.img_size, max_scale=max_scale)
        rb = rep["resample_bench"]
        log("[device_aug] device_resample a b16 640^2 batch: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (f32 bound {v['bound_ms']:.4f})"
            for k, v in rb.items() if isinstance(v, dict)))

        # 4. the producer alone; the device-aug step alone
        t = time.perf_counter()
        for _ in range(DEVAUG_PRODUCER_BATCHES):
            next(it)
        dt = time.perf_counter() - t
        rep["producer_ms_per_batch"] = dt * 1e3 / DEVAUG_PRODUCER_BATCHES
        rep["producer_img_s"] = (DEVAUG_PRODUCER_BATCHES
                                 * d.samples_per_device / dt)
        step_batch = {k: torch.from_numpy(v)
                      for k, v in batches[0].items()}
        step_batch["bank"] = bank
        rep["step_alone_ms"] = step_alone_ms(sd, step_batch)
        rep["step_alone_img_s"] = d.samples_per_device / (
            rep["step_alone_ms"] / 1e3)
        log(f"[device_aug] producer alone {rep['producer_ms_per_batch']:.3f}"
            f" ms a batch ({rep['producer_img_s']:.1f} img/s); the "
            f"device-aug step alone {rep['step_alone_ms']:.4f} ms "
            f"({rep['step_alone_img_s']:.2f} img/s)")
    finally:
        loader.close()
    del bank

    # 5. the CLI
    work = os.path.join(DEVAUG_DIR, "run")
    common = ["yunet_n", "--work-dir", work, "--load-pth", pth]
    opts = ["--cfg-options", f"data.train_ann={ann}",
            f"data.train_img_prefix={no_images}",
            f"data.decoded_cache={cache}", "data.device_aug=true",
            "train.checkpoint_interval=1", "train.log_interval=2"]
    runs = {}
    r = runs["shipped"] = train_cli(
        common + ["--max-steps", str(DEVAUG_STEPS)] + opts)
    _check_staged(r, "device-aug run")
    if sorted(r["host"]) != sorted(AUG_KEYS + (
            "gt_bboxes", "gt_labels", "gt_kps", "gt_valid", "num_overflow")):
        raise AssertionError(f"device-aug batch keys {sorted(r['host'])}")
    rows = _metrics(work, "train")
    if [x["step"] for x in rows] != list(range(2, DEVAUG_STEPS + 1, 2)):
        raise AssertionError(f"logged steps {[x['step'] for x in rows]}")
    if not all(np.isfinite(x["loss"]) for x in rows):
        raise AssertionError("a device-aug loss is not finite")
    want = [f"ckpt_{s:08d}" for s in (4, 8, 12)]
    have = sorted(x for x in os.listdir(work) if x.startswith("ckpt_"))
    with open(os.path.join(work, "latest")) as f:
        latest = os.path.basename(f.read().strip())
    if have != want or latest != want[-1]:
        raise AssertionError(f"checkpoints {have}, latest {latest}")
    with open(os.path.join(work, "train.log")) as f:
        staged = [x for x in f if "into device HBM" in x]
    if len(staged) != 1 or f"staged {n} images" not in staged[0]:
        raise AssertionError(f"staging log lines {staged}")
    if r["launches"]["simota_streamed"] != 2 * DEVAUG_STEPS:
        raise AssertionError(f"K1 launches {r['launches']}")
    log(f"[device_aug] {DEVAUG_STEPS} steps in {r['secs']:.2f} s, losses "
        f"{[round(x['loss'], 4) for x in rows]}, img/s "
        f"{[round(x['imgs_per_sec'], 2) for x in rows]}; "
        f"{staged[0].split(' - INFO - ')[-1].strip()}; launches "
        f"{r['launches']}")

    r = runs["resume"] = train_cli(
        common + ["--auto-resume", "--max-steps", str(DEVAUG_RESUME_STEPS)]
        + opts)
    rows = _metrics(work, "train")
    new = [x["step"] for x in rows[DEVAUG_STEPS // 2:]]
    if new != list(range(DEVAUG_STEPS + 2, DEVAUG_RESUME_STEPS + 1, 2)):
        raise AssertionError(f"resumed run logged steps {new}")
    if not all(np.isfinite(x["loss"]) for x in rows):
        raise AssertionError("a resumed device-aug loss is not finite")
    if r["ts"].step != DEVAUG_RESUME_STEPS or len(r["load_s"]) != 1:
        raise AssertionError(f"resume: step {r['ts'].step}, "
                             f"{len(r['load_s'])} checkpoint loads")
    if not os.path.isdir(os.path.join(work,
                                      f"ckpt_{DEVAUG_RESUME_STEPS:08d}")):
        raise AssertionError("no checkpoint at the resumed run's last step")
    if r["launches"]["simota_streamed"] != 2 * (DEVAUG_RESUME_STEPS
                                                - DEVAUG_STEPS):
        raise AssertionError(f"resume: K1 launches {r['launches']}")
    cursor = DeviceAugLoader(ann, no_images, batch_size=d.samples_per_device,
                             spec=spec, seed=cfg.train.seed,
                             start_step=DEVAUG_STEPS, bank_size=d.bank_size,
                             bank_canvas=d.bank_canvas, decoded_cache=cache)
    try:
        want_batch = next(iter(cursor))
    finally:
        cursor.close()
    for k, v in want_batch.items():
        if not np.array_equal(r["host"][k], v):
            raise AssertionError(f"resume: the first batch's {k} is not the "
                                 f"stream's batch {DEVAUG_STEPS + 1}")
    _check_staged(r, "resumed device-aug run")
    log(f"[device_aug] resume: {DEVAUG_STEPS} -> {DEVAUG_RESUME_STEPS} in "
        f"{r['secs']:.2f} s, losses {[round(x['loss'], 4) for x in rows]}; "
        f"launches {r['launches']}")

    twork = os.path.join(DEVAUG_DIR, "throughput")
    r = runs["throughput"] = train_cli(
        ["yunet_n", "--work-dir", twork, "--load-pth", pth,
         "--max-steps", str(DEVAUG_RATE_STEPS)] + opts
        + [f"train.log_interval={FIT_RATE_LOG}",
           f"train.checkpoint_interval={DEVAUG_RATE_STEPS}"])
    if r["launches"]["simota_streamed"] != 2 * DEVAUG_RATE_STEPS:
        raise AssertionError(f"throughput run: launches {r['launches']}")
    trows = _metrics(twork, "train")
    if not all(np.isfinite(x["loss"]) for x in trows):
        raise AssertionError("a throughput-run loss is not finite")
    fed = trows[2:]
    rep["fed_train_img_s"] = len(fed) / sum(1 / x["imgs_per_sec"]
                                            for x in fed)
    rep["fed_train_img_s_per_interval"] = [x["imgs_per_sec"] for x in trows]
    rep["run_secs"] = {k: v["secs"] for k, v in runs.items()}
    rep["checkpoint_load_ms"] = [x * 1e3 for x in runs["resume"]["load_s"]]
    rep["launches"] = {k: v["launches"] for k, v in runs.items()}
    rep["phase_s"] = time.perf_counter() - t0
    launches = {}
    for run in runs.values():
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    pace = ("the producer" if rep["producer_img_s"]
            < 1.25 * rep["fed_train_img_s"] else "the step")
    log(f"[device_aug] device-aug-fed train {rep['fed_train_img_s']:.2f} "
        f"img/s (steps {2 * FIT_RATE_LOG + 1}-{DEVAUG_RATE_STEPS}), the "
        f"step alone {rep['step_alone_img_s']:.2f} img/s, the producer "
        f"alone {rep['producer_img_s']:.1f} img/s: {pace} sets the pace; "
        f"phase {rep['phase_s']:.1f} s")
    return launches, rep


def device_aug_only():
    """phase_device_aug alone, for quick work on device-side augmentation:
    python3 -c "import chip_smoke as s; s.device_aug_only()" from the
    repository root. Builds only the kernel the path runs (csrc/simota.cu)
    and draws phase_fit's train split if it is not there."""
    import torch
    from yunet_tpu_torch.ops import simota
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    watchdog(WATCHDOG_S)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"simota.cu": simota.LIB})
    _, sd, _, _ = load_model()
    launches, report = phase_device_aug(sd)
    log(f"[device_aug] launches {launches}")
    log(f"[device_aug] {smi}: " + json.dumps(report))


# -- data-parallel training ------------------------------------------------

DIST_DIR = os.path.join(ROOT, "work_dirs", "chip_dist")
# phase 1: steps of the f32 comparison and of the bf16 pair on one batch;
# the bf16 step time and the all_reduce's share over DIST_TIME_STEPS steps
DIST_STEPS, DIST_TIME_STEPS = 4, 10
DIST_CLI_STEPS, DIST_NCCL_STEPS = 8, 3
DIST_BATCH, DIST_IMG = 16, 640          # a rank's rows, and the crop
# 2 ranks against one process at 2x the batch with bn_group: JAX's own
# mesh-against-one-device tolerances (tests/test_train_step.py:55-90,
# 357-397)
DIST_LOSS_RTOL, DIST_PARAM_TOL, DIST_STAT_TOL = 1e-4, (1e-3, 3e-5), (1e-4,
                                                                      1e-6)
# the gathered hook against one process's, bf16 (the port's bf16 band)
DIST_AP_TOL = 0.02
DIST_TIMEOUT_S = 420


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dist_cfg(dtype, **train):
    """yunet_n at full width, DIST_IMG crops and DIST_BATCH rows a rank (or
    ``batch`` rows), in ``dtype`` with ``train`` on top."""
    import dataclasses
    from yunet_tpu_torch.config import yunet_n
    cfg = yunet_n()
    batch = train.pop("batch", DIST_BATCH)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, img_size=DIST_IMG,
                                      samples_per_device=batch),
        train=dataclasses.replace(cfg.train, bf16=dtype == "bf16", **train))


def _dist_train(cfg, sd, mesh, batches, device):
    """Steps of cfg from ``sd`` on ``device`` over host batches, this
    rank's rows of each (all rows without a mesh), the launch counters
    from zero: {metrics per step, state dict, EMA, launches} on the
    CPU."""
    import torch
    from yunet_tpu_torch.parallel import shard_batch
    from yunet_tpu_torch.train import init_train_state, make_train_step
    world = mesh.size if mesh is not None else 1
    ts, opt = init_train_state(
        cfg, steps_per_epoch=1000,
        total_batch=cfg.data.samples_per_device * world, device=device,
        state_dict=sd)
    step = make_train_step(cfg, ts.model, opt, img_size=cfg.data.img_size,
                           mesh=mesh)
    reset_launch_counts()
    metrics = []
    for b in batches:
        ts, m = step(ts, {k: torch.from_numpy(v).to(device)
                          for k, v in shard_batch(b, mesh).items()})
        metrics.append(m)
    _sync(device)
    return {"metrics": [{k: float(v) for k, v in m.items()}
                        for m in metrics],
            "state": {k: v.cpu() for k, v in ts.model.state_dict().items()},
            "ema": [e.cpu() for e in ts.ema] if ts.ema else None,
            "launches": launch_counts(), "ts": ts, "step": step}


def _dist_batches(path):
    data = np.load(path)
    keys = ("image", "gt_bboxes", "gt_labels", "gt_kps", "gt_valid")
    return [{k: data[f"{k}{i}"] for k in keys} for i in range(DIST_STEPS)]


def _dist_job_step(args):
    """Phase 1 in a rank: the f32 comparison run (TF32 off, EMA on); then
    the shipped bf16 config (warmup off) DIST_STEPS steps on the rank's
    rows of the first batch, and its step time alone and with each
    all_reduce timed (a synchronize either side)."""
    import torch
    import torch.distributed as dist
    from yunet_tpu_torch.parallel import make_mesh, shard_batch
    device = args["device"]
    mesh = make_mesh(device, always=True)
    sd = torch.load(args["sd"], weights_only=True)
    batches = _dist_batches(args["batches"])
    out = {"f32": _dist_train(_dist_cfg("f32", ema_momentum=0.9), sd, mesh,
                              batches, device)}
    bf = _dist_train(_dist_cfg("bf16", warmup_iters=0), sd, mesh,
                     batches[:1] * DIST_STEPS, device)
    ts, step = bf.pop("ts"), bf.pop("step")
    rows = {k: torch.from_numpy(v).to(device)
            for k, v in shard_batch(batches[1], mesh).items()}
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(DIST_TIME_STEPS):
        step(ts, rows)
    _sync(device)
    bf["step_ms"] = (time.perf_counter() - t0) * 1e3 / DIST_TIME_STEPS
    spent, reduce = [], dist.all_reduce

    def timed(*a, **kw):
        _sync(device)
        t = time.perf_counter()
        out = reduce(*a, **kw)
        _sync(device)
        spent.append(time.perf_counter() - t)
        return out
    dist.all_reduce = timed
    try:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(DIST_TIME_STEPS):
            step(ts, rows)
        _sync(device)
    finally:
        dist.all_reduce = reduce
    bf["timed_step_ms"] = (time.perf_counter() - t0) * 1e3 / DIST_TIME_STEPS
    bf["all_reduce_ms"] = sum(spent) * 1e3 / DIST_TIME_STEPS
    bf["all_reduces_a_step"] = len(spent) / DIST_TIME_STEPS
    bf.pop("ema")
    out["f32"].pop("ts")
    out["f32"].pop("step")
    out["bf16"] = bf
    return out


def _dist_job_cli(args):
    """Phase 2 (and 3) in a rank: the training CLI through its main() with
    args["argv"], the launch counters from zero; the rank's loader shard
    and bank size, its checkpoint writes, the backend and world size fit
    ran with."""
    import torch.distributed as dist
    from yunet_tpu_torch.tools import train as cli
    from yunet_tpu_torch.train import checkpoint, loop
    rec = {"writes": [], "loaders": [], "groups": []}
    os.environ.update(args.get("env", {}))

    def counted_write(write):
        def wrapped(*a, **kw):
            rec["writes"].append(os.path.basename(a[1]))
            return write(*a, **kw)
        return wrapped

    def recorded_build(build):
        def wrapped(*a, **kw):
            loader = build(*a, **kw)
            rec["loaders"].append((loader.process_index,
                                   loader.process_count,
                                   len(getattr(loader, "bank", ()))))
            return loader
        return wrapped

    def recorded_fit(fit):
        def wrapped(*a, **kw):
            rec["groups"].append((dist.get_backend(), kw["mesh"].size))
            return fit(*a, **kw)
        return wrapped

    restore = [_patched(checkpoint, "_write", counted_write),
               _patched(loop, "build_loader", recorded_build),
               _patched(loop, "fit", recorded_fit)]
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ts = cli.main(args["argv"], device=args.get("device"))
    finally:
        for r in restore:
            r()
    _sync(next(ts.model.parameters()).device)
    rec["secs"] = time.perf_counter() - t0
    rec["step"] = ts.step
    rec["launches"] = launch_counts()
    rec["group_destroyed"] = not dist.is_initialized()
    return rec


DIST_JOBS = {"step": _dist_job_step, "cli": _dist_job_cli}


def _dist_rank(job, rank, world, init, out, args):
    """A rank of phase_distributed, in a spawned process (it imports
    yunet_tpu_torch only; the kernels were built by phase_build): joins
    the group ``init`` names (args["backend"], on args["device"]) unless
    ``init`` is None, runs DIST_JOBS[job] and saves its result to
    ``out``. An exception exits the process non-zero."""
    import torch
    import torch.distributed as dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if init is not None:
        if args["backend"] == "nccl":
            torch.cuda.set_device(args["device"])
        dist.init_process_group(args["backend"], init_method=init, rank=rank,
                                world_size=world)
    try:
        result = DIST_JOBS[job](args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, out)


def run_ranks(job, rank_args, *, init=True, timeout=DIST_TIMEOUT_S):
    """DIST_JOBS[job] in len(rank_args) spawned ranks (a FileStore group
    unless ``init`` is False). Returns their results; a rank that exits
    non-zero or overruns ``timeout`` fails the call, and every rank is
    stopped before it returns."""
    import multiprocessing as mp
    import torch
    world = len(rank_args)
    tag = f"{job}-{time.monotonic_ns()}"
    store = "file://" + os.path.join(DIST_DIR, f"{tag}.store")
    outs = [os.path.join(DIST_DIR, f"{tag}.rank{r}.pt") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(
        job, r, world, store if init else None, outs[r], a))
        for r, a in enumerate(rank_args)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{job}: rank exit codes {codes} (a negative "
                             f"code: killed at the {timeout} s timeout)")
    # written by this run's own ranks
    return [torch.load(o, weights_only=False) for o in outs]


def _close(what, got, want, rtol, atol):
    import torch
    bad = ~((got - want).abs() <= atol + rtol * want.abs())
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {want.numel()} values off, worst "
            f"|diff| {float((got - want).abs().max()):.3g}")


def _check_dist_run(label, got, want, param_names):
    """One rank's f32 run against the one-process run, under the mesh
    tolerances; returns the worst relative loss gap."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        if g["num_pos"] != w["num_pos"]:
            raise AssertionError(f"{label}: num_pos {g['num_pos']} != "
                                 f"{w['num_pos']} at step {i}")
        for k in ("loss", "loss_cls", "loss_obj", "loss_bbox", "loss_kps"):
            gap = abs(g[k] - w[k]) / abs(w[k])
            worst = max(worst, gap)
            if gap > DIST_LOSS_RTOL:
                raise AssertionError(f"{label}: {k} {g[k]} != {w[k]} at "
                                     f"step {i}")
    for k, v in want["state"].items():
        if not v.is_floating_point():
            continue
        tol = DIST_PARAM_TOL if k in param_names else DIST_STAT_TOL
        _close(f"{label}: {k}", got["state"][k], v, *tol)
    for i, (g, w) in enumerate(zip(got["ema"], want["ema"])):
        _close(f"{label}: EMA {i}", g, w, *DIST_PARAM_TOL)
    return worst


def fit_val_split():
    """phase_fit's val split (phase_wider's draw), drawn when phase_fit
    has not run: (labelv2 path, cache dir, GT dir)."""
    root = os.path.join(FIT_DIR, "val")
    paths = (os.path.join(root, "labelv2.txt"), os.path.join(root, "cache"),
             os.path.join(root, "gt"))
    return paths if os.path.exists(paths[0]) else wider_split(root)


def phase_distributed(sd):
    """Data-parallel training on the card, one process a rank (spawned;
    each imports yunet_tpu_torch only and loads the kernels phase_build
    built):

      1. two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
         card), DIST_STEPS steps of yunet_n at DIST_IMG^2, DIST_BATCH rows
         a rank, f32 with TF32 off and EMA on, from r04 on seeded
         train_batch rows, against one process at 2 x DIST_BATCH with
         train.bn_group=DIST_BATCH on the same rows: losses, num_pos,
         params, EMA and BN statistics under the mesh tolerances, and 2
         K1 launches a rank a step. Then the shipped bf16 config (warmup
         off) on one batch: finite and falling losses, the ranks' states
         torch.equal, the step time a rank and the all_reduce's share of
         it (two ranks sharing one card: not a scaling figure);
      2. the training CLI in the same two ranks (the group initialised by
         the worker, main() joins it) with data.device_aug=true and
         data.bank_sharded=true on phase_fit's 64-image split,
         DIST_CLI_STEPS steps, checkpoints every epoch, the eval hook in
         mode 0 with device NMS every 2 epochs. Checks: each rank's bank
         holds its 32 images; rank 0 alone writes the checkpoints and
         metrics.jsonl; 2 K1 launches a rank a step and K2/K3 launches on
         each rank's shard of the sweep; the gathered APs equal one
         process's test_widerface on the last checkpoint within
         DIST_AP_TOL;
      3. NCCL: the CLI with --distributed at world size 1 from torchrun's
         environment variables (DIST_NCCL_STEPS --smoke steps); with two
         or more cards, phase 1's f32 comparison in two NCCL ranks, one
         card each.
    Returns ({kernel: launches over the phase's ranks}, {report})."""
    import shutil
    import socket
    import torch
    from yunet_tpu_torch.tools import test_widerface

    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    rng = np.random.RandomState(9)
    batches = [train_batch(rng, 2 * DIST_BATCH, DIST_IMG)
               for _ in range(DIST_STEPS)]
    bpath = os.path.join(DIST_DIR, "batches.npz")
    np.savez(bpath, **{f"{k}{i}": v for i, b in enumerate(batches)
                       for k, v in b.items()})
    sd_path = os.path.join(DIST_DIR, "r04.pt")
    torch.save(sd, sd_path)
    rep, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # 1. the reference: one process at 2 x DIST_BATCH, bn_group=DIST_BATCH
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    one = _dist_train(_dist_cfg("f32", ema_momentum=0.9,
                                batch=2 * DIST_BATCH, bn_group=DIST_BATCH),
                      sd, None, batches, DEV)
    param_names = {n for n, _ in one.pop("ts").model.named_parameters()}
    one.pop("step")
    torch.cuda.empty_cache()
    ranks_args = {"device": DEV, "backend": "gloo", "sd": sd_path,
                  "batches": bpath}
    split_ann, split_cache = fit_train_split()
    val_ann, val_cache, val_gt = fit_val_split()
    pth = os.path.join(DIST_DIR, "r04_ema.pth")
    torch.save({"state_dict": sd}, pth)
    work = os.path.join(DIST_DIR, "cli")
    argv = ["yunet_n", "--distributed", "--work-dir", work, "--load-pth",
            pth, "--max-steps", str(DIST_CLI_STEPS), "--eval-interval", "2",
            "--eval-mode", "0", "--eval-device-nms", "--eval-cache-dir",
            val_cache, "--eval-ann", val_ann, "--eval-gt-dir", val_gt,
            "--cfg-options", f"data.train_ann={split_ann}",
            "data.train_img_prefix=" + os.path.join(FIT_DIR, "no_images"),
            f"data.decoded_cache={split_cache}", "data.device_aug=true",
            "data.bank_sharded=true", "train.checkpoint_interval=1",
            "train.log_interval=2"]
    t = time.perf_counter()
    steps = run_ranks("step", [ranks_args, ranks_args])
    rep["phase1_s"] = time.perf_counter() - t
    worst = 0.0
    for r, res in enumerate(steps):
        got = res["f32"]
        worst = max(worst, _check_dist_run(f"rank {r} f32", got, one,
                                           param_names))
        if got["launches"]["simota_streamed"] != 2 * DIST_STEPS:
            raise AssertionError(f"rank {r}: K1 launches {got['launches']}")
        add(got["launches"])
        bf = res["bf16"]
        losses = [m["loss"] for m in bf["metrics"]]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"rank {r} bf16: losses {losses}")
        add(bf["launches"])
    for k, v in steps[0]["bf16"]["state"].items():
        if not torch.equal(v, steps[1]["bf16"]["state"][k]):
            raise AssertionError(f"bf16: the ranks' {k} differ")
    bf = [s["bf16"] for s in steps]
    rep["f32_worst_loss_rel_gap"] = worst
    rep["f32_losses"] = [m["loss"] for m in steps[0]["f32"]["metrics"]]
    rep["bf16_losses"] = [m["loss"] for m in bf[0]["metrics"]]
    rep["bf16_step_ms_a_rank"] = [b["step_ms"] for b in bf]
    rep["bf16_timed_step_ms_a_rank"] = [b["timed_step_ms"] for b in bf]
    rep["bf16_all_reduce_ms_a_rank"] = [b["all_reduce_ms"] for b in bf]
    rep["all_reduces_a_step"] = bf[0]["all_reduces_a_step"]
    rep["bf16_all_reduce_share"] = [b["all_reduce_ms"] / b["timed_step_ms"]
                                    for b in bf]
    log(f"[dist] 2 gloo ranks on {DEV} == one process at b"
        f"{2 * DIST_BATCH} bn_group {DIST_BATCH} over {DIST_STEPS} f32 "
        f"steps (worst loss gap {worst:.3g}); bf16 losses "
        f"{[round(x, 4) for x in rep['bf16_losses']]}, ranks equal; a bf16 "
        f"step {[round(x, 3) for x in rep['bf16_step_ms_a_rank']]} ms a "
        f"rank, all_reduce {[round(x, 3) for x in rep['bf16_all_reduce_ms_a_rank']]}"
        f" ms of {[round(x, 3) for x in rep['bf16_timed_step_ms_a_rank']]} "
        f"({rep['all_reduces_a_step']:.0f} a step; two ranks share one "
        "card: not a scaling figure)")

    # 2. the CLI in two gloo ranks on one card
    t = time.perf_counter()
    cli = run_ranks("cli", [dict(ranks_args, argv=argv, device=DEV)] * 2)
    rep["phase2_s"] = time.perf_counter() - t
    n_ckpt = DIST_CLI_STEPS // 2     # 32 images a rank, 16 a step
    want = [f"ckpt_{2 * (i + 1):08d}" for i in range(n_ckpt)]
    if cli[0]["writes"] != want or cli[1]["writes"]:
        raise AssertionError(f"checkpoint writes {cli[0]['writes']}, "
                             f"{cli[1]['writes']}")
    for r, res in enumerate(cli):
        if res["loaders"] != [(r, 2, WIDER_IMAGES // 2)]:
            raise AssertionError(f"rank {r}: loader {res['loaders']}")
        if res["groups"] != [("gloo", 2)] or res["step"] != DIST_CLI_STEPS:
            raise AssertionError(f"rank {r}: {res['groups']}, step "
                                 f"{res['step']}")
        lc = res["launches"]
        if (lc["simota_streamed"] != 2 * DIST_CLI_STEPS
                or lc["greedy_nms"] <= 0):
            raise AssertionError(f"rank {r}: launches {lc}")
        add(lc)
    rows, vals = _metrics(work, "train"), _metrics(work, "val")
    if [x["step"] for x in rows] != list(range(2, DIST_CLI_STEPS + 1, 2)):
        raise AssertionError(f"logged steps {[x['step'] for x in rows]}")
    if not all(np.isfinite(x["loss"]) for x in rows):
        raise AssertionError("a logged loss is not finite")
    if [v["step"] for v in vals] != [4, DIST_CLI_STEPS]:
        raise AssertionError(f"val rows {vals}")
    aps = [vals[-1][k] for k in ("easy", "medium", "hard")]
    ckpt_aps = list(test_widerface.main([
        "yunet_n", os.path.join(work, want[-1]), "--mode", "0",
        "--device-nms", "--ann", val_ann, "--gt-dir", val_gt,
        "--cache-dir", val_cache,
        "--eval-log", os.path.join(DIST_DIR, "eval.log")], device=DEV))
    gap = max(abs(a - b) for a, b in zip(aps, ckpt_aps))
    if gap > DIST_AP_TOL:
        raise AssertionError(f"gathered APs {aps} vs one process's "
                             f"{ckpt_aps}")
    rep.update({"cli_secs": [c["secs"] for c in cli], "cli_aps": aps,
                "one_process_aps": ckpt_aps, "cli_ap_gap": gap,
                "cli_img_s_per_interval": [x["imgs_per_sec"] for x in rows],
                "cli_launches": [c["launches"] for c in cli]})
    log(f"[dist] CLI, 2 gloo ranks, sharded bank (32 images a rank): "
        f"{DIST_CLI_STEPS} steps, losses "
        f"{[round(x['loss'], 4) for x in rows]}, img/s (both ranks) "
        f"{[round(x['imgs_per_sec'], 2) for x in rows]}; gathered APs {aps} "
        f"vs one process {ckpt_aps}; rank 0 wrote {cli[0]['writes']}; "
        f"launches {rep['cli_launches']}")

    # 3. NCCL
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    (nccl,) = run_ranks("cli", [{"env": env, "argv": [
        "yunet_n", "--distributed", "--smoke", "--max-steps",
        str(DIST_NCCL_STEPS), "--work-dir", os.path.join(DIST_DIR, "nccl"),
        "--cfg-options", "train.log_interval=1"]}], init=False)
    backend = "nccl" if torch.device(DEV).type == "cuda" else "gloo"
    if (nccl["groups"] != [(backend, 1)] or not nccl["group_destroyed"]
            or nccl["launches"]["simota_streamed"] != 2 * DIST_NCCL_STEPS):
        raise AssertionError(f"NCCL world of one: {nccl}")
    nrows = _metrics(os.path.join(DIST_DIR, "nccl"), "train")
    if len(nrows) != DIST_NCCL_STEPS or not all(np.isfinite(x["loss"])
                                                for x in nrows):
        raise AssertionError(f"NCCL run rows {nrows}")
    add(nccl["launches"])
    rep["nccl_world_1_losses"] = [x["loss"] for x in nrows]
    ran = [f"NCCL at world size 1 ({DIST_NCCL_STEPS} --smoke steps, "
           "torchrun's variables)"]
    if torch.cuda.device_count() >= 2:
        pair = run_ranks("step", [
            dict(ranks_args, backend="nccl", device=f"cuda:{r}")
            for r in range(2)])
        for r, res in enumerate(pair):
            _check_dist_run(f"NCCL rank {r} f32", res["f32"], one,
                            param_names)
            add(res["f32"]["launches"])
            add(res["bf16"]["launches"])
        ran.append("2 NCCL ranks on 2 cards against one process")
    else:
        ran.append(f"2 NCCL ranks skipped: {torch.cuda.device_count()} "
                   "card(s) on this host")
    rep["nccl"] = ran
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"[dist] {'; '.join(ran)}: losses "
        f"{[round(x, 4) for x in rep['nccl_world_1_losses']]}; phase "
        f"{rep['phase_s']:.1f} s")
    return launches, rep


def distributed_only():
    """phase_distributed alone, for quick work on data-parallel training:
    python3 -c "import chip_smoke as s; s.distributed_only()" from the
    repository root. Builds only the kernels the path runs (csrc/simota.cu,
    csrc/nms.cu) and the host routines (csrc/host_nms.cpp), and draws
    phase_fit's splits if they are not there."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import nms, simota
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    watchdog(WATCHDOG_S)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"simota.cu": simota.LIB, "nms.cu": nms.LIB,
                 "host_nms.cpp": native.LIB})
    _, sd, _, _ = load_model()
    launches, report = phase_distributed(sd)
    log(f"[dist] launches {launches}")
    log(f"[dist] {smi}: " + json.dumps(report))


# -- the profiling and check tools ----------------------------------------

TOOLS_DIR = os.path.join(ROOT, "work_dirs", "chip_tools")
TOOLS_VERIFY = ("nms", "simota", "convdp", "convdp_bwd", "convdp_cm")
TOOLS_SERVE_KERNELS = ("nms_mask_kernel", "nms_scan_kernel")        # K2
TOOLS_TRAIN_KERNELS = ("valid_best_kernel", "topk_kernel")          # K1
TOOLS_SERVE_BATCH, TOOLS_VALIDATE_STEPS = 16, 600
TOOLS_TEST_IMAGES, TOOLS_MAP_TOL = 16, 1e-4


def _profile_table(tot, cnt, steps):
    """A profile tool's result as {"device_ms", "categories": {category:
    [ms, launches] a step}, "port_kernels": {...}}."""
    from yunet_tpu_torch.utils.trace_profile import categories, port_kernels
    ours = port_kernels([(k, us, cnt[k]) for k, us in tot.items()])
    return {"device_ms": sum(tot.values()) / steps / 1e3,
            "categories": {c: [us / steps / 1e3, n / steps] for c, (us, n)
                           in categories(tot, cnt).items()},
            "port_kernels": {k: [us / steps / 1e3, n / steps]
                             for k, (us, n) in ours.items()}}


def phase_tools():
    """The port's profiling and check tools through their main()s, on the
    card:

      (a) verify_device_kernels.check_all, the body of its main: each of
          TOOLS_VERIFY passes (main's exit code 0), every bf16 ConvDP
          call on its tensor-core route;
      (b) profile_serve (b16, 320^2, 20 calls) and profile_train_step
          (b16, 640^2, 3 steps): device-lane tables whose port kernels
          (trace_profile.port_kernels of the returned counters) include
          K2's mask and scan kernels and K1's two kernels;
      (c) bench_train_step --simota folded,xla (b16, 5 iterations, 3
          interleaved windows): the medians;
      (d) validate_training: TOOLS_VALIDATE_STEPS steps on
          tests/fixtures/validate_training_160.npz with K1 in every step,
          recall >= 0.9;
      (e) tools/test.py in f32 (TF32 off) on the first TOOLS_TEST_IMAGES
          images of phase_wider's split from the decoded cache, on the card
          and on this host's CPU: mAPs within TOOLS_MAP_TOL.

    Every kernel, and the tensor-core route of K4, K5 and K6, launched at
    least once over the phase. Returns ({kernel: launches over the phase},
    {report})."""
    import shutil
    import torch
    from yunet_tpu_torch.ops.simota import streamed_simota
    from yunet_tpu_torch.tools import (bench_train_step, profile_serve,
                                       profile_train_step, test,
                                       validate_training,
                                       verify_device_kernels)
    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    rep = {}
    reset_launch_counts()

    results = verify_device_kernels.check_all(torch.device(DEV))
    if list(results) != list(TOOLS_VERIFY) or any(results.values()):
        raise AssertionError(f"verify_device_kernels: {results}")
    rep["verify"] = {n: "PASS" for n in results}

    for name, tool, argv, steps, want in (
            ("profile_serve", profile_serve,
             ["--batch", str(TOOLS_SERVE_BATCH), "--iters", "20"], 20,
             TOOLS_SERVE_KERNELS),
            ("profile_train_step", profile_train_step,
             ["--batch", "16", "--img-size", "640", "--steps", "3"], 3,
             TOOLS_TRAIN_KERNELS)):
        got = tool.main(argv + ["--out", os.path.join(TOOLS_DIR, name)],
                        device=DEV)
        if got is None:
            raise AssertionError(f"{name}: the trace holds no device event")
        rep[name] = _profile_table(*got, steps)
        absent = [k for k in want if k not in rep[name]["port_kernels"]]
        if absent:
            raise AssertionError(f"{name}: the report names no {absent}")
        if name == "profile_serve":
            rep[name]["throughput_bound_img_s"] = TOOLS_SERVE_BATCH / (
                rep[name]["device_ms"] / 1e3)

    rep["bench_train_step"] = bench_train_step.main([
        "--batch", "16", "--simota", "folded,xla", "--iters", "5",
        "--windows", "3"], device=DEV)

    before = streamed_simota.launches
    t0 = time.perf_counter()
    recall, kp_err = validate_training.run(
        steps=TOOLS_VALIDATE_STEPS, data=validate_training.load_data(),
        device=DEV)
    k1 = streamed_simota.launches - before
    rep["validate_training"] = {"recall": recall, "kps_err_px": kp_err,
                                "k1_launches": k1,
                                "seconds": time.perf_counter() - t0}
    if recall < 0.9 or k1 != 2 * TOOLS_VALIDATE_STEPS:
        raise AssertionError(f"validate_training: recall {recall} (gate 0.9),"
                             f" {k1} K1 launches for {TOOLS_VALIDATE_STEPS} "
                             "steps")

    ann, cache, _ = fit_val_split()
    argv = ["yunet_n", FIXTURE, "--ann", ann, "--cache-dir", cache,
            "--limit", str(TOOLS_TEST_IMAGES)]
    restore = _patched(test, "Detector", lambda cls: (
        lambda *a, **kw: cls(*a, dtype=torch.float32, **kw)))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        maps = {d: test.main(argv, device=d) for d in (DEV, "cpu")}
    finally:
        restore()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rep["test_map"] = maps
    if not abs(maps[DEV] - maps["cpu"]) <= TOOLS_MAP_TOL:
        raise AssertionError(f"tools/test.py mAP on the card {maps[DEV]} vs "
                             f"the CPU {maps['cpu']} (tolerance "
                             f"{TOOLS_MAP_TOL})")
    rep["phase_s"] = time.perf_counter() - t_phase
    launches = launch_counts()
    idle = [k for k, v in launches.items() if not v]
    if idle:
        raise AssertionError(f"tools: no launch of {idle} ({launches})")
    log(f"[tools] verify PASS {list(TOOLS_VERIFY)}; serve device "
        f"{rep['profile_serve']['device_ms']:.4f} ms a call, train step "
        f"{rep['profile_train_step']['device_ms']:.4f} ms; bench medians "
        + json.dumps({k: v["imgs_per_s_median"]
                      for k, v in rep["bench_train_step"].items()})
        + f"; validate recall {recall:.3f}, kps error {kp_err:.2f} px; "
        f"mAP card {maps[DEV]:.6f} / CPU {maps['cpu']:.6f}; launches "
        f"{launches}; phase {rep['phase_s']:.1f} s")
    return launches, rep


def tools_only():
    """phase_tools alone, for quick work on the tools: python3 -c "import
    chip_smoke as s; s.tools_only()" from the repository root. Builds
    every kernel (the verify tool checks them all) and draws phase_wider's
    split if it is not there."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    watchdog(WATCHDOG_S)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build()
    load_model()                                   # TF32 off
    launches, report = phase_tools()
    log(f"[tools] {smi}: " + json.dumps(report))


# -- the last modules: harness, rehearsal, study tools, mesh, augmentation --

STUDY_DIR = os.path.join(ROOT, "work_dirs", "chip_study")
STUDY_ONNX_AP_TOL = 1e-4       # the ONNX engine, card against CPU
STUDY_BF16_AP_TOL = 0.02       # bf16 torch engine against the f32 ONNX
STUDY_FPS_ITERS = 20
# the rehearsal: 64 images at b16 = 4 steps an epoch, a checkpoint each
REH_EPOCHS, REH_KILL_AT = 3, 5
REH_TIMEOUT_S = 240


def counted_train(count_path, argv):
    """python -m yunet_tpu_torch.tools.train's main(argv) in a rehearsal
    leg, appending after each step a line "steps K1 K2" (this process's
    launch counters) to count_path, and "end K1 K2" when main returns, so
    a SIGKILLed leg leaves its counts too."""
    from yunet_tpu_torch.ops.nms import greedy_nms_keep
    from yunet_tpu_torch.ops.simota import streamed_simota
    from yunet_tpu_torch.tools import train as cli
    from yunet_tpu_torch.train import loop

    def counts():
        return f"{streamed_simota.launches} {greedy_nms_keep.launches}"

    def wrap(make):
        def made(*a, **kw):
            step = make(*a, **kw)
            done = [0]

            def counted(*sa, **skw):
                out = step(*sa, **skw)
                done[0] += 1
                with open(count_path, "a") as f:
                    f.write(f"{done[0]} {counts()}\n")
                return out
            return counted
        return made

    loop.make_train_step = wrap(loop.make_train_step)
    cli.main(argv)
    with open(count_path, "a") as f:
        f.write(f"end {counts()}\n")


def _leg_counts(path):
    """counted_train's lines -> [[(steps, K1, K2), ..., ("end", K1, K2)?]
    a leg]: a leg starts where the step count restarts at 1."""
    legs = []
    with open(path) as f:
        for line in f:
            a, k1, k2 = line.split()
            if a == "1":
                legs.append([])
            legs[-1].append((a, int(k1), int(k2)))
    return legs


def phase_study():
    """The modules ported last, through their entry points, on the card:

      (a) compare_inference --eval over phase_fit's val split (wider_split,
          64 images from the decoded cache, "640,640") with
          torch:yunet_n:<r04> (bf16, device NMS: K3 on every detect) and
          onnx:<the port's export at 640^2> (the torch ONNX executor); the
          same ONNX engine on this host's CPU: APs within
          STUDY_ONNX_AP_TOL; the torch engine's within STUDY_BF16_AP_TOL of
          the ONNX engine's; then the FPS mode (run_bench) of both on one
          image, with the per-stage times.
      (b) run_rehearsal on phase_fit's 64-image train split with the
          device-aug bank, b16 at 640^2, a checkpoint every epoch, EMA,
          --eval-both-params with --eval-device-nms at the end, from the
          r04 weights (a step-0 checkpoint in the work dir, which the
          first leg auto-resumes), SIGKILLed at step REH_KILL_AT and
          auto-resumed: the tool's bit-exact gate on every duplicated
          step, 2 K1 launches a step in each leg (its trainer runs as
          counted_train).
      (c) ema_ab_table over (b)'s metrics.jsonl.
      (d) export_band_fixture on (b)'s last checkpoint over the val split
          with device NMS: the file read back through load_flat_npz equal
          to the checkpoint's EMA shadow, its mode-0 and mode-2 APs equal
          to test_widerface's on the same weights and split.
      (e) Detector.mesh = [cuda:0, cuda:0] at serve b16 320^2 with device
          NMS against the unsharded call: JAX's sharded tolerances
          (tests/test_detect.py: rtol 1e-5, atol 1e-4 boxes, 1e-3 kps),
          equal counts, one K2 call (two launches) a shard.
      (f) data/aug_extra.py and data/auto_augment.py, every transform once
          on this host, which has no OpenCV.

    Returns ({kernel: launches over the phase, the rehearsal's trainers
    included}, {report})."""
    import shutil
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.eval.detect import Detector
    from yunet_tpu_torch.export.onnx_export import export_onnx
    from yunet_tpu_torch.ops.nms import greedy_nms_keep
    from yunet_tpu_torch.tools import (compare_inference, ema_ab_table,
                                       export_band_fixture, run_rehearsal,
                                       test_widerface)
    from yunet_tpu_torch.train.checkpoint import read_state, save_checkpoint
    from yunet_tpu_torch.train.step import init_train_state
    from yunet_tpu_torch.utils.jax_params import (_leaves, jax_from_state_dict,
                                                  load_flat_npz,
                                                  state_dict_from_jax)
    t_phase = time.perf_counter()
    shutil.rmtree(STUDY_DIR, ignore_errors=True)
    os.makedirs(STUDY_DIR)
    rep = {}
    cfg = yunet_n()
    train_ann, train_cache = fit_train_split()
    val_ann, val_cache, val_gt = fit_val_split()
    reset_launch_counts()

    # (a) the cross-engine harness (load_model also turns TF32 off, which
    # the f32 ONNX engine's card-against-CPU check needs)
    model = load_model()[2]
    onnx = os.path.join(STUDY_DIR, "yunet_n_640.onnx")
    with open(onnx, "wb") as f:
        f.write(export_onnx(model, cfg.model, input_shape=(640, 640)))
    specs = {"torch": f"torch:yunet_n:{FIXTURE}", "onnx": f"onnx:{onnx}"}
    argv = ["--eval", "--ann", val_ann, "--gt-dir", val_gt, "--cache-dir",
            val_cache, "--mode", "640,640"]
    t0 = time.perf_counter()
    k3 = greedy_nms_keep.launches
    aps = {"torch": compare_inference.main(
        ["--models", specs["torch"]] + argv, device=DEV)[specs["torch"]]}
    k3 = greedy_nms_keep.launches - k3
    aps["onnx"] = compare_inference.main(
        ["--models", specs["onnx"]] + argv, device=DEV)[specs["onnx"]]
    rep["eval_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    aps["onnx_cpu"] = compare_inference.main(
        ["--models", specs["onnx"]] + argv, device="cpu")[specs["onnx"]]
    rep["eval_onnx_cpu_s"] = time.perf_counter() - t0
    rep["eval_aps"] = {k: [float(a) for a in v] for k, v in aps.items()}
    rep["eval_k3_launches"] = k3
    gap_cpu = max(abs(a - b) for a, b in zip(aps["onnx"], aps["onnx_cpu"]))
    gap_bf16 = max(abs(a - b) for a, b in zip(aps["torch"], aps["onnx"]))
    if gap_cpu > STUDY_ONNX_AP_TOL or gap_bf16 > STUDY_BF16_AP_TOL:
        raise AssertionError(f"compare_inference APs {rep['eval_aps']}: "
                             f"ONNX card-CPU gap {gap_cpu}, bf16 torch-ONNX "
                             f"gap {gap_bf16}")
    if k3 != 2 * WIDER_IMAGES:
        raise AssertionError(f"torch engine: {k3} NMS launches for "
                             f"{WIDER_IMAGES} detects, want 2 each")
    from yunet_tpu_torch.data.cache import load_cached
    from yunet_tpu_torch.data.labelv2 import parse_labelv2
    img = load_cached(val_cache, parse_labelv2(val_ann, test_mode=True)[0]
                      .filename)
    bench = types.SimpleNamespace(mode="640,640", iters=STUDY_FPS_ITERS)
    rep["fps"] = {}
    for name, spec in specs.items():
        eng = compare_inference.build_engine(spec, device=DEV)
        fps = compare_inference.run_bench(eng, spec, bench, img)
        rep["fps"][name] = {"fps": fps, "stage_ms": {
            k: t.total / STUDY_FPS_ITERS * 1e3
            for k, t in eng.times.timers.items()}}
    log(f"[study] compare_inference: APs {rep['eval_aps']} (ONNX card-CPU "
        f"gap {gap_cpu:.2e}, bf16-ONNX gap {gap_bf16:.4f}), K3 {k3}; FPS "
        + json.dumps(rep["fps"]))

    # (b) the rehearsal, from the r04 weights through a step-0 checkpoint
    work = os.path.join(STUDY_DIR, "rehearsal")
    cfg_ema = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_momentum=0.0002))
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, cfg.model))
    ts0, opt0 = init_train_state(cfg_ema, steps_per_epoch=1, total_batch=16,
                                 device="cpu", state_dict=sd)
    save_checkpoint(work, ts0, opt0, epoch=0, meta={"config": "yunet_n"})
    data = FIT_DIR
    count_path = os.path.join(STUDY_DIR, "launches.txt")
    cmd_of = run_rehearsal.train_cmd

    def counted_cmd(args, device):
        cmd = cmd_of(args, device)
        i = cmd.index("-m")
        return [cmd[0], "-c", "import sys; sys.path.insert(0, "
                f"{ROOT!r}); import chip_smoke; chip_smoke.counted_train("
                f"{count_path!r}, sys.argv[1:])"] + cmd[i + 2:]

    legs = []
    run_leg = run_rehearsal.run_leg

    def timed_leg(*a, **kw):
        t = time.perf_counter()
        out = run_leg(*a, **kw)
        legs.append(time.perf_counter() - t)
        return out

    restore = [_patched(run_rehearsal, "train_cmd", lambda _: counted_cmd),
               _patched(run_rehearsal, "run_leg", lambda _: timed_leg)]
    try:
        rc = run_rehearsal.main([
            "--data", data, "--work-dir", work, "--batch", "16",
            "--epochs", str(REH_EPOCHS), "--eval-interval", str(REH_EPOCHS),
            "--kill-at", str(REH_KILL_AT),
            "--leg-timeout", str(REH_TIMEOUT_S),
            "--decoded-cache", train_cache, "--eval-cache-dir", val_cache,
            "--eval-both-params", "--eval-device-nms", "--cfg-options",
            "train.checkpoint_interval=1", "train.log_interval=1"],
            device=DEV)
    finally:
        for r in restore:
            r()
    metrics = os.path.join(work, "metrics.jsonl")
    dup, exact = run_rehearsal.check_resume_bitexact(metrics)
    counted = _leg_counts(count_path)
    rep["rehearsal"] = {"rc": rc, "duplicated": dup, "bit_exact": exact,
                        "legs_s": legs, "leg_steps": [
                            [int(r[0]) for r in leg if r[0] != "end"][-1]
                            for leg in counted]}
    if rc != 0 or dup == 0 or exact != dup or len(counted) != 2:
        raise AssertionError(f"rehearsal: {rep['rehearsal']}")
    k1_total = k2_total = 0
    for leg in counted:
        for a, k1, _ in leg:
            if a != "end" and k1 != 2 * int(a):
                raise AssertionError(f"rehearsal leg: {k1} K1 launches after "
                                     f"{a} steps, want 2 a step")
        k1_total += leg[-1][1]
        k2_total += leg[-1][2]
    if counted[1][-1][0] != "end" or counted[1][-1][2] <= 0:
        raise AssertionError(f"the resumed leg ran no eval NMS: {counted[1]}")
    rep["rehearsal"].update(k1_launches=k1_total, k2_launches=k2_total)
    log(f"[study] rehearsal: {rep['rehearsal']}")

    # (c) the EMA / raw table
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        table_rc = ema_ab_table.main([metrics, "--markdown"])
    log(buf.getvalue().rstrip())
    if table_rc != 0 or "endpoint (step 12)" not in buf.getvalue():
        raise AssertionError(f"ema_ab_table: rc {table_rc}")
    rep["ema_table"] = buf.getvalue()

    # (d) the band fixture on the last checkpoint
    ckpt = open(os.path.join(work, "latest")).read().strip()
    band = os.path.join(STUDY_DIR, "band.npz")
    t0 = time.perf_counter()
    meta = export_band_fixture.main([
        "--ckpt", ckpt, "--data", data, "--out", band, "--cache-dir",
        val_cache, "--device-nms"], device=DEV)
    rep["band_fixture_s"] = time.perf_counter() - t0
    state = read_state(ckpt)
    names = [n for n, _ in model.named_parameters()]
    want_sd = dict(state["model"])
    want_sd.update(zip(names, state["ema"]))
    want = jax_from_state_dict(want_sd, cfg.model)
    got = load_flat_npz(band, cfg.model)
    for wt, gt in zip(want, got):
        for (path, w), (_, g) in zip(_leaves(wt), _leaves(gt)):
            if not np.array_equal(w, g):
                raise AssertionError(f"band fixture leaf {path} differs")
    band_aps = {}
    for key, mode in (("mode0_aps", 0), ("mode2_aps", 2)):
        aps_cli = test_widerface.main([
            "yunet_n", band, "--mode", str(mode), "--device-nms", "--ann",
            val_ann, "--gt-dir", val_gt, "--cache-dir", val_cache,
            "--eval-log", os.path.join(STUDY_DIR, "eval.log")], device=DEV)
        rec = [meta[key][k] for k in ("easy", "medium", "hard")]
        band_aps[key] = rec
        if rec != [float(a) for a in aps_cli]:
            raise AssertionError(f"band fixture {key} {rec} != "
                                 f"test_widerface's {list(aps_cli)}")
    rep["band_aps"] = band_aps
    log(f"[study] band fixture {meta['n_params']} + {meta['n_state']} "
        f"leaves equal to the EMA shadow; APs {band_aps} equal to "
        "test_widerface's")

    # (e) Detector.mesh: two shards on the one card
    rng = np.random.RandomState(2)
    imgs = [face_image(rng, 320, 320, rng.randint(2, 7)) for _ in range(16)]
    # f32 (TF32 off): cuDNN may pick other bf16 algorithms at b8 than at
    # b16, and a bf16 rounding flip moves a box by more than the tolerance
    det = Detector(cfg, sd, device=DEV, dtype=torch.float32)
    ref = det.detect_batch(imgs, "AUTO", use_device_nms=True)
    det.mesh = [DEV, DEV]
    before = greedy_nms_keep.launches
    shard = det.detect_batch(imgs, "AUTO", use_device_nms=True)
    torch.cuda.synchronize()
    mesh_launches = greedy_nms_keep.launches - before
    worst = [0.0, 0.0]
    for r, s in zip(ref, shard):
        if r["bboxes"].shape != s["bboxes"].shape:
            raise AssertionError("Detector.mesh: detection counts differ")
        for i, (key, atol) in enumerate((("bboxes", 1e-4), ("kps", 1e-3))):
            np.testing.assert_allclose(s[key], r[key], rtol=1e-5, atol=atol)
            if len(r[key]):
                worst[i] = max(worst[i], float(np.abs(s[key] - r[key]).max()))
    if mesh_launches != 2 * 2:
        raise AssertionError(f"Detector.mesh: {mesh_launches} NMS launches "
                             "for 2 shards, want one call (2) a shard")
    rep["mesh"] = {"detections": sum(len(r["bboxes"]) for r in shard),
                   "max_abs_diff_boxes": worst[0], "max_abs_diff_kps":
                   worst[1], "nms_launches": mesh_launches}
    log(f"[study] Detector.mesh [{DEV}, {DEV}]: {rep['mesh']}")

    # (f) the augmentation library without OpenCV
    from yunet_tpu_torch.data import aug_extra, auto_augment
    arng = np.random.RandomState(0)
    aimg, boxes, kps = face_sample(arng, 320, 320, 4)
    aimg = aimg.astype(np.float32)
    outs = [aug_extra.photometric_distortion(aimg, arng),
            aug_extra.random_affine(aimg, boxes, kps, arng)[0],
            aug_extra.mosaic4([(aimg, boxes, kps)] * 4, arng,
                              out_size=640)[0],
            aug_extra.mixup(aimg, boxes, kps, aimg, boxes, kps, arng,
                            img_scale=(320, 320))[0],
            aug_extra.expand(aimg, boxes, kps, arng)[0],
            aug_extra.cutout(aimg, arng)]
    for policy in auto_augment.default_policies():
        outs.append(auto_augment.apply_policy(
            aimg, boxes, kps, arng, [dict(p, prob=1.0) for p in policy])[0])
    if not all(np.isfinite(o).all() and o.ndim == 3 for o in outs):
        raise AssertionError("augmentation output not finite")
    rep["augment"] = {"calls": len(outs), "cv2_loaded": "cv2" in sys.modules}
    log(f"[study] aug_extra and auto_augment: {len(outs)} calls, cv2 "
        f"loaded: {'cv2' in sys.modules}")

    rep["phase_s"] = time.perf_counter() - t_phase
    launches = launch_counts()
    launches["simota_streamed"] += k1_total
    launches["greedy_nms"] += k2_total
    rep["launches"] = launches
    for name in ("simota_streamed", "greedy_nms"):
        if not launches[name]:
            raise AssertionError(f"study: no launch of {name} ({launches})")
    log(f"[study] launches {launches}; phase {rep['phase_s']:.1f} s")
    return launches, rep


def study_only():
    """phase_study alone, for quick work on the last modules: python3 -c
    "import chip_smoke as s; s.study_only()" from the repository root.
    Builds nms.cu, simota.cu and host_nms.cpp and draws phase_fit's splits
    if they are not there."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import nms, simota
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    watchdog(WATCHDOG_S)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"nms.cu": nms.LIB, "simota.cu": simota.LIB,
                 "host_nms.cpp": native.LIB})
    launches, report = phase_study()
    log(f"[study] {smi}: " + json.dumps(report))


# -- export and import -----------------------------------------------------

EXPORT_DIR = os.path.join(ROOT, "work_dirs", "chip_export")
# (label, file, batch, height, width) of the executor checks
EXPORT_RUNS = (("static 640^2 b1", "static", 1, 640, 640),
               ("dynamic 320^2 b4", "dynamic", 4, 320, 320),
               ("dynamic 640^2 b1", "dynamic", 1, 640, 640))
# (height, width) of the face images the imported Detector detects on
EXPORT_IMAGES = ((640, 640), (640, 640), (480, 640))


def _check_folded_equal(got, want, path="folded"):
    """Every tensor of the imported tree torch.equal to the fold's, the
    same topology and relu flags."""
    import torch
    from yunet_tpu_torch.models.fused import FoldedUnit
    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"{path}: keys {list(got)} != {list(want)}")
        for k in want:
            _check_folded_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} units, want "
                                 f"{len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _check_folded_equal(a, b, f"{path}/{i}")
    elif isinstance(want, FoldedUnit):
        for f in ("w1", "b1", "wd", "bd"):
            _check_folded_equal(getattr(got, f), getattr(want, f),
                                f"{path}.{f}")
        if got.relu != want.relu:
            raise AssertionError(f"{path}: relu {got.relu}")
    elif not (got.device == want.device and torch.equal(got, want)):
        raise AssertionError(f"{path}: the imported tensor differs from "
                             "the fold")


def phase_export(sd):
    """Export and import on the card, yunet_n with the r04 weights, TF32
    off:

      1. export_onnx at 640^2 and with dynamic axes, and generate_cpp, from
         the model on the card into work_dirs/chip_export/ (bytes, host
         ms); the same bytes from a copy of the model on the CPU (the
         card's BN fold is the host's);
      2. the files through OnnxExecutor(device="cuda"): the static file at
         640^2 b1, the dynamic one at 320^2 b4 and 640^2 b1, on face
         images, within rtol 1e-3 / atol 1e-5 of the model's f32 outputs;
      3. load_onnx_params(device="cuda") torch.equal to
         fold_inference_params of the model;
      4. Detector(cfg, None, folded=imported) in f32 and bf16,
         detect(use_device_nms=True) on EXPORT_IMAGES: the detections equal
         to Detector(fused=True)'s from the model; K4 and K2/K3 counted
         over these calls (29 and 2 a detect, the bf16 ones all on K4's
         tensor-core route); K4 held to its plain version on this
         Detector's own unit inputs (bf16: verify_device_kernels'
         convdp_bf16_call; f32: fused_forward with the kernel against
         without it, and the detections); K2/K3's keep sets equal to the
         host NMS's;
      5. the CLIs through their main() on the card: detect_image on an .npy
         face image with --fused --device-nms (its box count equal to
         the API's), yunet2onnx --verify;
      6. the executor's time against Detector.raw's (the imported
         Detector, f32 and bf16, and the unfused model's f32) on the same
         batch, 640^2 b1 and 320^2 b16, CUDA events, in the order
         executor, raw..., raw... reversed, executor.
    Returns ({kernel: launches in 4 and 5}, {report})."""
    import dataclasses
    import shutil
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.apis import init_detector
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.eval.detect import Detector
    from yunet_tpu_torch.export import export_onnx, generate_cpp
    from yunet_tpu_torch.export.onnx_import import load_onnx_params
    from yunet_tpu_torch.export.onnx_runtime import OnnxExecutor
    from yunet_tpu_torch.models import fused as fused_mod
    from yunet_tpu_torch.models.detector import YuNet
    from yunet_tpu_torch.models.fused import (fold_inference_params,
                                              fused_forward)
    from yunet_tpu_torch.models.head import flatten_level_outputs
    from yunet_tpu_torch.ops.convdp import fused_conv_dp_plain
    from yunet_tpu_torch.ops.nms import device_nms
    from yunet_tpu_torch.tools import detect_image, yunet2onnx
    from yunet_tpu_torch.tools.verify_device_kernels import convdp_bf16_call
    from yunet_tpu_torch.tools.yunet2onnx import flat_outputs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    full = yunet_n()
    cfg = full.model
    model = YuNet(cfg, device=DEV)
    model.load_state_dict(sd)
    host_model = YuNet(cfg, device="cpu")
    host_model.load_state_dict(sd)
    rep = {"export": {}}

    # 1. the files
    paths = {}
    makers = {"static": ("yunet_n_640_640.onnx", lambda m: export_onnx(
                  m, cfg, input_shape=(640, 640))),
              "dynamic": ("yunet_n_dynamic.onnx", lambda m: export_onnx(
                  m, cfg, dynamic=True)),
              "cpp": ("facedetectcnn-data.cpp", lambda m: generate_cpp(
                  m, cfg).encode())}
    for what, (name, make) in makers.items():
        t = time.perf_counter()
        blob = make(model)
        ms = (time.perf_counter() - t) * 1e3
        if make(host_model) != blob:
            raise AssertionError(f"export {what}: the card's model and the "
                                 "host's write different files")
        paths[what] = os.path.join(EXPORT_DIR, name)
        with open(paths[what], "wb") as f:
            f.write(blob)
        rep["export"][what] = {"bytes": len(blob), "host_ms": ms}
        log(f"[export] {name}: {len(blob)} bytes in {ms:.2f} ms (host), "
            "equal to the CPU model's")

    # 2. the executor against the model
    rng = np.random.RandomState(12)
    executors = {w: OnnxExecutor(paths[w], device=DEV)
                 for w in ("static", "dynamic")}
    rep["executor_max_abs_err"] = {}
    for label, what, b, h, w in EXPORT_RUNS:
        x = np.stack([face_image(rng, h, w, rng.randint(2, 9))
                      for _ in range(b)]).transpose(0, 3, 1, 2).astype(
                          np.float32)
        got = executors[what](x)
        want = flat_outputs(model, x)
        err = 0.0
        for k, v in want.items():
            e = float(np.abs(got[k] - v).max())
            if got[k].shape != v.shape or not np.allclose(
                    got[k], v, rtol=1e-3, atol=1e-5):
                raise AssertionError(
                    f"executor {label}: {k} differs from the model (max abs "
                    f"err {e}, rtol 1e-3, atol 1e-5)")
            err = max(err, e)
        rep["executor_max_abs_err"][label] = err
        log(f"[export] executor {label}: the 12 outputs within rtol 1e-3 / "
            f"atol 1e-5 of the f32 model, max abs err {err:.3e}")

    # 3. the import
    imported = load_onnx_params(paths["static"], cfg, device=DEV)
    _check_folded_equal(imported, fold_inference_params(model, cfg))
    log("[export] load_onnx_params: every tensor torch.equal to "
        "fold_inference_params")

    # 4. the imported Detector
    imgs = [face_image(rng, h, w, 6) for h, w in EXPORT_IMAGES]
    dets = {dt: Detector(full, None, folded=imported, device=DEV, dtype=dt)
            for dt in (torch.float32, torch.bfloat16)}
    refs = {dt: Detector(full, model, device=DEV, dtype=dt, fused=True)
            for dt in dets}
    torch.cuda.synchronize()
    reset_launch_counts()
    results = {dt: [d.detect(img, use_device_nms=True) for img in imgs]
               for dt, d in dets.items()}
    torch.cuda.synchronize()
    lc = launch_counts()
    n = len(imgs) * len(dets)
    if lc["fused_conv_dp"] != 29 * n or lc["greedy_nms"] != 2 * n or \
            lc["fused_conv_dp_mma"] != 29 * len(imgs):
        raise AssertionError(f"imported Detector launches {lc}, want 29 K4 "
                             f"(29 of them bf16 on the tensor-core route) "
                             f"and 2 K2/K3 a detect, {n} detects")
    launches = {k: lc[k] for k in ("fused_conv_dp", "fused_conv_dp_mma",
                                   "greedy_nms")}
    counts = {}
    for dt, det in dets.items():
        name = str(dt).split(".")[-1]
        for i, (img, r) in enumerate(zip(imgs, results[dt])):
            want = refs[dt].detect(img, use_device_nms=True)
            for k in ("bboxes", "kps", "labels"):
                if not np.array_equal(r[k], want[k]):
                    raise AssertionError(f"imported Detector {name}, image "
                                         f"{i}: {k} differ from "
                                         "Detector(fused=True)'s")
            if not all(np.all(np.isfinite(v)) for v in r.values()):
                raise AssertionError("non-finite detection output")
        counts[name] = [r["bboxes"].shape[0] for r in results[dt]]
        if min(counts[name]) == 0:
            raise AssertionError(f"imported Detector {name} found no face "
                                 f"in an image: {counts[name]}")
    rep["detections"] = counts
    log(f"[export] imported Detector detect(use_device_nms=True): "
        f"detections {counts} equal to Detector(fused=True)'s; launches "
        f"{launches}")

    # K4 against its plain version on the imported Detector. bf16: each of
    # the 29 unit calls of one detect, on its own inputs, by the
    # bf16_excess rule; f32: the whole folded trunk with and without the
    # kernel, and the detections
    calls = []
    kernel = fused_mod.fused_conv_dp

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)
    fused_mod.fused_conv_dp = record
    try:
        dets[torch.bfloat16].raw(dets[torch.bfloat16]._input([imgs[0]]),
                                 conv_kernel=True)
    finally:
        fused_mod.fused_conv_dp = kernel
    worst = 0.0
    for i, (args, kwargs) in enumerate(calls):
        excess, _ = convdp_bf16_call(f"imported unit {i}", *args, **kwargs)
        worst = max(worst, excess)
    if len(calls) != 29:
        raise AssertionError(f"{len(calls)} ConvDP calls in a detect")
    x = torch.from_numpy(imgs[0][None].transpose(0, 3, 1, 2).astype(
        np.float32)).to(DEV)
    a, b = (flatten_level_outputs(fused_forward(imported, x, cfg,
                                                use_kernel=k))
            for k in (True, False))
    f32_err = max(float((a[k] - b[k]).abs().max()) for k in a)
    if not all(torch.allclose(a[k], b[k], rtol=1e-4, atol=1e-4) for k in a):
        raise AssertionError(f"imported f32 trunk: kernel against plain, max "
                             f"abs err {f32_err} (rtol/atol 1e-4)")
    # eagerly: a graph keeps the kernels of its capture
    graph_calls = (dets[torch.float32].graphs.captures,
                   dets[torch.float32].graphs.replays)
    fused_mod.fused_conv_dp = fused_conv_dp_plain
    try:
        with _eager():
            plain = [dets[torch.float32].detect(img, use_device_nms=True)
                     for img in imgs]
    finally:
        fused_mod.fused_conv_dp = kernel
    if (dets[torch.float32].graphs.captures,
            dets[torch.float32].graphs.replays) != graph_calls:
        raise AssertionError("the plain units' detects captured or "
                             "replayed a graph")
    for g, w in zip(results[torch.float32], plain):
        _match(g, w, atol=1e-2, rtol=1e-4, score_atol=1e-4)
    rep["k4_bf16_excess"], rep["k4_f32_trunk_max_abs_err"] = worst, f32_err
    log(f"[export] K4 on the imported Detector: bf16 excess {worst:.3f} of "
        f"2^-24 S over its 29 unit calls (limit 2), f32 trunk max abs err "
        f"{f32_err:.3e} against the plain units (rtol/atol 1e-4), f32 "
        "detections pair with the plain units'")
    thr, iou = full.test.score_thr, full.test.nms_iou_thr
    for dt, det in dets.items():
        for i, img in enumerate(imgs):
            scores, boxes, _ = det.raw(det._input([img]), conv_kernel=True)
            _, keep, idx = device_nms(boxes[0], scores[0], top_k=5000,
                                      iou_thr=iou, score_thr=thr)
            s, bx = scores[0].cpu().numpy(), boxes[0].cpu().numpy()
            valid = s >= thr
            host = np.flatnonzero(valid)[native.nms(bx[valid], s[valid],
                                                    iou)]
            if not np.array_equal(host, idx[keep].cpu().numpy()):
                raise AssertionError(f"K2/K3 keep != host NMS, imported "
                                     f"{dt}, image {i}")
    log("[export] K2/K3 keep sets equal to the host NMS's on the imported "
        "Detector's raw outputs (f32 and bf16, every image)")

    # 5. the CLIs
    pth = os.path.join(EXPORT_DIR, "r04_ema.pth")
    torch.save({"state_dict": sd}, pth)
    npy = os.path.join(EXPORT_DIR, "face.npy")
    np.save(npy, imgs[0])
    out = os.path.join(EXPORT_DIR, "result.npy")
    torch.cuda.synchronize()
    reset_launch_counts()
    r = detect_image.main(["yunet_n", pth, npy, "--out", out, "--fused",
                           "--device-nms"], device=DEV)
    torch.cuda.synchronize()
    lc = launch_counts()
    if lc["fused_conv_dp"] != 29 or lc["greedy_nms"] != 2:
        raise AssertionError(f"detect_image launches {lc}")
    for k in launches:
        launches[k] += lc[k]
    api = init_detector(dataclasses.replace(full, test=dataclasses.replace(
        full.test, score_thr=0.3)), pth, device=DEV, fused=True)
    want = api.detect(imgs[0], use_device_nms=True)
    if r["bboxes"].shape != want["bboxes"].shape or \
            not np.array_equal(r["bboxes"], want["bboxes"]):
        raise AssertionError(f"detect_image: {r['bboxes'].shape[0]} boxes, "
                             f"the API {want['bboxes'].shape[0]}")
    if np.load(out).shape != imgs[0].shape or r["bboxes"].shape[0] == 0:
        raise AssertionError("detect_image: no faces, or no image written")
    onnx_cli = os.path.join(EXPORT_DIR, "cli_640.onnx")
    yunet2onnx.main(["yunet_n", pth, "--output", onnx_cli, "--verify"],
                    device=DEV)
    with open(onnx_cli, "rb") as f, open(paths["static"], "rb") as g:
        if f.read() != g.read():
            raise AssertionError("yunet2onnx wrote another file than "
                                 "export_onnx")
    log(f"[export] CLIs: detect_image --fused --device-nms found "
        f"{r['bboxes'].shape[0]} faces (the API too); yunet2onnx --verify "
        "passed on the card, its file equal to export_onnx's")

    # 6. the deployed file against the native program
    rep["times_ms"] = {}
    unfused = Detector(full, model, device=DEV, dtype=torch.float32)
    for b, hw in ((1, 640), (16, 320)):
        batch = np.stack([face_image(rng, hw, hw, 4) for _ in range(b)])
        nhwc = torch.from_numpy(batch).to(DEV)
        nchw = nhwc.permute(0, 3, 1, 2).float().contiguous()
        progs = {"executor_f32": lambda: executors["dynamic"].run(nchw),
                 "raw_f32": lambda: dets[torch.float32].raw(
                     nhwc, conv_kernel=b == 1),
                 "raw_bf16": lambda: dets[torch.bfloat16].raw(
                     nhwc, conv_kernel=b == 1),
                 "raw_unfused_f32": lambda: unfused.raw(
                     nhwc, conv_kernel=False)}
        t = {k: [] for k in progs}
        for k in list(progs) + list(progs)[::-1]:
            t[k].append(cuda_ms(progs[k]))
        key = f"{hw}^2 b{b}"
        rep["times_ms"][key] = t
        log(f"[export] time {key}: " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in t.items())
            + (" (the imported raw on the K4 units)" if b == 1 else
               " (the imported raw on the library convs)"))
    rep["phase_s"] = time.perf_counter() - t0
    log(f"[export] phase {rep['phase_s']:.1f} s")
    return launches, rep


def export_only():
    """phase_export alone, for quick work on export and import:
    python3 -c "import chip_smoke as s; s.export_only()" from the
    repository root. Builds the kernels the path runs (convdp.cu, nms.cu)
    and the host NMS."""
    import torch
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import convdp, nms
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    watchdog(WATCHDOG_S)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi}")
    phase_build({"convdp.cu": convdp.LIB, "nms.cu": nms.LIB,
                 "host_nms.cpp": native.LIB})
    _, sd, _, _ = load_model()
    launches, report = phase_export(sd)
    log(f"[export] launches {launches}")
    log(f"[export] {smi}: " + json.dumps(report))


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




# the five heaviest units of a 640^2 b16 step; shapes that are not whole
# 8 x 16 tiles, (N, H, W, Cin, Cout): two at yunet_n's widths, one at
# yunet_s's 32 channels and one whose channels take the scalar loads
HEAVY_UNITS = ("stem_dp", "m1a", "m1b", "m2a", "m2b")
RAGGED_BWD = ((2, 21, 19, 16, 64), (2, 21, 19, 64, 10), (1, 17, 33, 32, 32),
              (2, 9, 7, 3, 1))


def _check_convdp_bwd(label, x, w1, b1, wd, dz, worst):
    """verify_device_kernels.convdp_bwd_call, its shares and f32 abs error
    folded into ``worst``. Returns the shares."""
    import torch
    from yunet_tpu_torch.tools.verify_device_kernels import convdp_bwd_call
    shares, abs_err = convdp_bwd_call(label, x, w1, b1, wd, dz)
    key = "bf16" if x.dtype == torch.bfloat16 else "f32"
    worst[key] = max(worst[key], *shares.values())
    worst["f32_abs"] = max(worst["f32_abs"], abs_err)
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
    from yunet_tpu_torch.tools.verify_device_kernels import BWD_TOL
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


def phase_convdp_cm():
    """The channels-major ConvDP kernel (verify_device_kernels'
    convdp_cm_call) at the bench shape (64 -> 64, 160^2, N = 128; seeded
    on the card) and at the ragged shapes of CM_RAGGED. Times the bf16
    kernel, its plain version and the library pair at the bench shape, then
    runs the bench twin with the launch counters from zero: all 120
    launches on the tensor-core route."""
    import torch
    import torch.nn.functional as F
    from yunet_tpu_torch.ops.convdp_cm import (fused_conv_dp_cm,
                                               fused_conv_dp_cm_plain)
    from yunet_tpu_torch.tools import bench_convdp_cm as bench
    from yunet_tpu_torch.tools.verify_device_kernels import convdp_cm_call
    n, h, w, cin, cout = bench.N, bench.H, bench.W, bench.CIN, bench.COUT
    gen = torch.Generator(device=DEV).manual_seed(7)

    def draw(n, h, w, cin, cout):
        return (torch.randn((n, h, w, cin), generator=gen, device=DEV),
                *(torch.randn(s, generator=gen, device=DEV) * 0.3
                  for s in ((cin, cout), (cout,), (9, cout), (cout,))))

    x32, w1, b1, wd, bd = draw(n, h, w, cin, cout)
    def cm_log(line):
        log(f"[convdp_cm] {line}")

    max_err, share = convdp_cm_call(f"{h}x{w} {cin}->{cout} N={n}", x32,
                                    w1, b1, wd, bd, log=cm_log)
    for rh, rw, rci, rco, rn in CM_RAGGED:
        e, s = convdp_cm_call(f"{rh}x{rw} {rci}->{rco} N={rn}",
                              *draw(rn, rh, rw, rci, rco), log=cm_log)
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


def nms_only(*others):
    """phase_nms alone, for quick work on the NMS kernel:
    python3 -c "import chip_smoke as s; s.nms_only()" from the repository
    root. Builds only csrc/nms.cu. Each of others is the path of another
    NMS source with csrc/nms.cu's C interface (a scratch copy of an
    earlier version or a variant, in a directory .gitignore lists, e.g.
    git show HEAD~1:yunet_tpu_torch/csrc/nms.cu > work_dirs/p/nms.cu): it
    is built with the same flags, held equal to the plain version on every
    case and timed beside the kernel, alone (phase_nms) and inside the
    serving and detect programs (phase_nms_walls)."""
    import torch
    from yunet_tpu_torch.ops import nms
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)} | {nvidia_smi_line()}")
    builds = {path: nms_build(path) for path in others}
    phase_build({"nms.cu": nms.LIB, **builds})
    keep_fns = {name: nms_keep_fn(lib) for name, lib in builds.items()}
    phase_nms(keep_fns, builds)
    phase_nms_walls(keep_fns)


def phase_nms_walls(others):
    """The walls of the programs the NMS kernel runs in, with the kernel
    and with each other build's keep function (nms_keep_fn) in its place:
    serve b16 and b128 at 320^2 and the fused detect b1 at 640^2, the
    event time per back-to-back call (cuda_ms), in the order others,
    kernel, kernel, others reversed. A build stands in for the kernel by
    taking greedy_nms_keep's name in ops/nms.py, where device_nms_batched
    looks it up."""
    from yunet_tpu_torch.apis import init_detector
    from yunet_tpu_torch.eval.detect import Detector
    from yunet_tpu_torch.ops import nms
    det = init_detector("yunet_n", FIXTURE, device=DEV)
    fdet = Detector(det.cfg, det.model, device=DEV, fused=True)
    rng = np.random.RandomState(3)
    progs = {}
    for bsz in (16, 128):
        x = fdet._input([face_image(rng, 320, 320, 4) for _ in range(bsz)])
        progs[f"serve b{bsz} 320^2"] = (
            lambda x=x: fdet.serve_packed(x, 750))
    x640 = fdet._input([face_image(rng, 640, 640, 4)])
    progs["detect b1 640^2"] = lambda: fdet.detect_packed(x640, 5000)
    kernel = nms.greedy_nms_keep
    fns = {"kernel": kernel, **others}
    order = list(others) + ["kernel", "kernel"]
    try:
        for prog, run in progs.items():
            for name in order + order[-3::-1]:
                nms.greedy_nms_keep = fns[name]
                log(f"[walls] {prog}, {name} NMS: {cuda_ms(run):.4f} ms "
                    "an event-timed back-to-back call")
    finally:
        nms.greedy_nms_keep = kernel


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


def watchdog(seconds):
    """Dump every thread's stack to stderr and exit non-zero if the run is
    still going after ``seconds`` (a hang then fails fast and shows where
    it is)."""
    import faulthandler
    faulthandler.dump_traceback_later(seconds, exit=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    watchdog(WATCHDOG_S)
    # the package first: without it the script fails before printing
    import yunet_tpu_torch  # noqa: F401
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = {}

    def phase(fn, *args):
        """fn(*args), its seconds logged and kept under its name."""
        t = time.perf_counter()
        out = fn(*args)
        secs[fn.__name__] = round(time.perf_counter() - t, 1)
        log(f"[phase] {fn.__name__}: {secs[fn.__name__]} s")
        return out

    phase(phase_build)
    nms_err, nms_t = phase(phase_nms)
    cfg, sd, model, folded = phase(load_model)
    conv_err, conv_t = phase(phase_convdp, folded, cfg)
    simota_err, simota_t = phase(phase_simota, model, cfg)
    _, fdet, serve_launches = phase(phase_slice)
    log(f"[graph] {smi}: " + json.dumps(phase(phase_graph, model)))
    log(f"[scrfd] {smi}: " + json.dumps(phase(phase_scrfd)))
    log(f"[retinaface] {smi}: " + json.dumps(phase(phase_retinaface)))
    train_launches, batches = phase(phase_train, sd)
    bwd_err, bwd_t = phase(phase_convdp_bwd, folded, cfg)
    fused_launches, _ = phase(phase_train_fused, sd, batches)
    cm_err, (cm_launches, cm_mma), cm_t = phase(phase_convdp_cm)
    phase(phase_times, fdet)
    phase(phase_train_times, sd, batches[0])
    wider_launches, wider_report = phase(phase_wider)
    log(f"[wider] {smi}: " + json.dumps(wider_report))
    fit_launches, fit_report = phase(phase_fit, sd)
    log(f"[fit] {smi}: " + json.dumps(fit_report))
    devaug_launches, devaug_report = phase(phase_device_aug, sd)
    log(f"[device_aug] {smi}: " + json.dumps(devaug_report))
    export_launches, export_report = phase(phase_export, sd)
    log(f"[export] {smi}: " + json.dumps(export_report))
    dist_launches, dist_report = phase(phase_distributed, sd)
    log(f"[dist] {smi}: " + json.dumps(dist_report))
    tools_launches, tools_report = phase(phase_tools)
    log(f"[tools] {smi}: " + json.dumps(tools_report))
    study_launches, study_report = phase(phase_study)
    log(f"[study] {smi}: " + json.dumps(study_report))
    log(f"[phase] seconds {json.dumps(secs)}")

    kernels = [
        {"name": "greedy_nms", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/nms.cu",
         "replaces": "yunet_tpu/ops/nms_pallas.py:78",
         "also_replaces": "yunet_tpu/ops/nms_pallas.py:40",
         "launches": serve_launches["greedy_nms"],
         # the tools path (phase_tools): verify_device_kernels, the
         # profiles, bench_train_step, validate_training, tools/test.py
         "launches_tools": tools_launches["greedy_nms"],
         # the last modules (phase_study): compare_inference, the
         # rehearsal's two trainers, the band fixture, Detector.mesh
         "launches_study": study_launches["greedy_nms"],
         # the WIDER sweeps with --device-nms, mode 0 and mode 2
         "launches_wider": wider_launches["greedy_nms"],
         # the eval hook of the training CLI (phase_fit)
         "launches_training_cli": fit_launches["greedy_nms"],
         # the ONNX-imported Detector's detects and detect_image
         # (phase_export)
         "launches_export": export_launches["greedy_nms"],
         # the gathered eval hook of the 2-rank CLI (phase_distributed),
         # both ranks' shards of the sweep
         "launches_distributed": dist_launches["greedy_nms"],
         "max_abs_err": nms_err,
         # no single PyTorch call computes greedy NMS (no torchvision)
         "library_ms": None,
         # the serving path's b16 shape
         **nms_t["b16_k750_n300"], "shapes": nms_t},
        {"name": "fused_conv_dp", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp.cu",
         "replaces": "yunet_tpu/ops/convdp_pallas.py:29",
         "launches": serve_launches["fused_conv_dp"],
         # the tools path (phase_tools): verify_device_kernels, the
         # profiles, bench_train_step, validate_training, tools/test.py
         "launches_tools": tools_launches["fused_conv_dp"],
         # the last modules (phase_study): compare_inference, the
         # rehearsal's two trainers, the band fixture, Detector.mesh
         "launches_study": study_launches["fused_conv_dp"],
         # of those, the launches of the bf16 (tensor-core) route
         "launches_mma": serve_launches["fused_conv_dp_mma"],
         # a fused Detector's solo detects on the WIDER path: the sweep's
         # stale image, detect_tta(flip=True) and warmup
         "launches_wider": wider_launches["fused_conv_dp"],
         "launches_mma_wider": wider_launches["fused_conv_dp_mma"],
         # also the forward of fused_pw_dw on the fused training path
         "also_runs_on": "training path with train.fused_kernels",
         "launches_fused_training": fused_launches["fused_conv_dp"],
         "launches_mma_fused_training": fused_launches["fused_conv_dp_mma"],
         # the training CLI's fused run (phase_fit)
         "launches_training_cli": fit_launches["fused_conv_dp"],
         "launches_mma_training_cli": fit_launches["fused_conv_dp_mma"],
         # the ONNX-imported Detector's detects (f32 and bf16) and
         # detect_image --fused (phase_export)
         "launches_export": export_launches["fused_conv_dp"],
         "launches_mma_export": export_launches["fused_conv_dp_mma"],
         "max_abs_err": conv_err["f32"],
         "bf16_excess": conv_err["bf16_excess"], **conv_t},
        {"name": "simota_streamed", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/simota.cu",
         "replaces": "yunet_tpu/ops/simota_pallas.py:233",
         "also_replaces": "yunet_tpu/ops/simota_pallas.py:118",
         "launches": train_launches["simota_streamed"],
         # the tools path (phase_tools): verify_device_kernels, the
         # profiles, bench_train_step, validate_training, tools/test.py
         "launches_tools": tools_launches["simota_streamed"],
         # the last modules (phase_study): compare_inference, the
         # rehearsal's two trainers, the band fixture, Detector.mesh
         "launches_study": study_launches["simota_streamed"],
         # the training CLI: shipped, resumed and fused runs (phase_fit)
         "launches_training_cli": fit_launches["simota_streamed"],
         # the training CLI with data.device_aug=true: 12 steps, the
         # resume to 16 and 48 steps (phase_device_aug)
         "launches_device_aug": devaug_launches["simota_streamed"],
         # data-parallel training (phase_distributed), summed over the
         # ranks: 2 a rank a step in the f32 and bf16 pairs, the 2-rank
         # CLI and the NCCL run
         "launches_distributed": dist_launches["simota_streamed"],
         "max_abs_err": simota_err,
         # no single PyTorch call computes the SimOTA reductions
         "library_ms": None, **simota_t},
        {"name": "convdp_bwd", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp_bwd.cu",
         "replaces": "yunet_tpu/ops/convdp_pallas_impl.py:61",
         "launches": fused_launches["convdp_bwd"],
         # the tools path (phase_tools): verify_device_kernels, the
         # profiles, bench_train_step, validate_training, tools/test.py
         "launches_tools": tools_launches["convdp_bwd"],
         # the last modules (phase_study): compare_inference, the
         # rehearsal's two trainers, the band fixture, Detector.mesh
         "launches_study": study_launches["convdp_bwd"],
         # of those, the launches of the bf16 (tensor-core) route
         "launches_mma": fused_launches["convdp_bwd_mma"],
         # the training CLI's fused run (phase_fit)
         "launches_training_cli": fit_launches["convdp_bwd"],
         "launches_mma_training_cli": fit_launches["convdp_bwd_mma"],
         "max_abs_err": bwd_err["f32_abs"], **bwd_t},
        {"name": "convdp_cm", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp_cm.cu",
         "replaces": "yunet_tpu/ops/convdp_cm_pallas.py:57",
         "launches": cm_launches,
         # the tools path (phase_tools): verify_device_kernels, the
         # profiles, bench_train_step, validate_training, tools/test.py
         "launches_tools": tools_launches["convdp_cm"],
         # the last modules (phase_study): compare_inference, the
         # rehearsal's two trainers, the band fixture, Detector.mesh
         "launches_study": study_launches["convdp_cm"],
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
