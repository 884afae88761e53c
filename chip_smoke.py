#!/usr/bin/env python3
"""Smoke test of the PyTorch port (yunet_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from yunet_tpu_torch/csrc/ (nvcc, sm_90a),
compares each kernel with its plain PyTorch version on the card, drives the
serving path (yunet_n at full width, trained r04 EMA weights from
tests/fixtures/r04_ema.npz) through the user entry points, shows through
the launch counters that the path ran the kernels, and times kernels and
the path with CUDA events. Any failed check raises, and the script exits
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


# -- inputs ----------------------------------------------------------------

def clustered_boxes(rng, n, size):
    """(n, 4) xyxy boxes in clusters, so that many pairs overlap."""
    centers = rng.uniform(20, size - 20, (max(n // 8, 1), 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 8, (n, 2))
    wh = rng.uniform(8, 80, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def face_image(rng, h, w, n_faces):
    """A noisy background with simple face renders (skin-tone ellipse,
    dark eyes, mouth), drawn with numpy in the style of
    tools/make_synth_wider.py, on which the r04 weights were trained."""
    img = rng.randint(40, 200, (h, w, 3)).astype(np.float32)
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_faces):
        s = rng.uniform(24, min(h, w) / 3)
        cx, cy = rng.uniform(s, w - s), rng.uniform(s, h - s)
        face = ((xx - cx) / (0.40 * s)) ** 2 + ((yy - cy) / (0.50 * s)) ** 2
        img[face <= 1] = (rng.randint(90, 160), rng.randint(120, 190),
                          rng.randint(170, 240))
        for ex in (-0.18, 0.18):
            eye = (xx - cx - ex * s) ** 2 + (yy - cy + 0.13 * s) ** 2
            img[eye <= (0.07 * s) ** 2] = 30
        mouth = (np.abs(yy - cy - 0.27 * s) <= max(0.03 * s, 1)) & \
            (np.abs(xx - cx) <= 0.14 * s)
        img[mouth] = (40, 40, 120)
    return np.clip(img, 0, 255).astype(np.uint8)


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

def phase_build():
    from yunet_tpu_torch import native
    from yunet_tpu_torch.ops import convdp, nms
    for name, lib in (("convdp.cu", convdp.LIB), ("nms.cu", nms.LIB),
                      ("native yunet_ops.cpp", native.LIB)):
        t0 = time.perf_counter()
        lib.get()
        dt = time.perf_counter() - t0
        log(f"[build] {name}: {dt:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"        {line.strip()}")


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
        times[f"b{bsz}_k{kk}_n{cnt}"] = {"ms": ms, "plain_ms": plain}
        log(f"[nms] time B={bsz} K={kk} n={cnt}: kernel {ms:.4f} ms, "
            f"plain {plain:.2f} ms")
    return max_err, times["b16_k750_n300"]


def _ulp_bf16(t):
    import torch
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def phase_convdp(folded, cfg):
    """The ConvDP kernel against its plain version at every unit shape of
    yunet_n's b1 fused forward at 320^2 and 640^2, plus ragged 37x45 and
    Cin=3: f32 within 1e-5, bf16 within one bf16 ulp of the output."""
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
    max_err = {"f32": 0.0, "bf16_ulps": 0.0}
    t_kernel = t_plain = 0.0
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
        gb = fused_conv_dp(xb, w1, b1, wd, bd, relu=relu).float()
        wb = fused_conv_dp_plain(xb, w1, b1, wd, bd, relu=relu).float()
        ulps = float(((gb - wb).abs() / _ulp_bf16(
            torch.maximum(gb.abs(), wb.abs()))).max())
        if ulps > 1.0:
            raise AssertionError(f"ConvDP kernel != plain (bf16) at {name}: "
                                 f"{ulps} ulp")
        max_err["f32"] = max(max_err["f32"], err)
        max_err["bf16_ulps"] = max(max_err["bf16_ulps"], ulps)
        if name.startswith("640:"):
            # the main path's time: one 640^2 b1 forward's units, bf16
            ms = cuda_ms(lambda: fused_conv_dp(xb, w1, b1, wd, bd,
                                               relu=relu))
            pms = cuda_ms(lambda: fused_conv_dp_plain(xb, w1, b1, wd, bd,
                                                      relu=relu))
            t_kernel += ms
            t_plain += pms
            key = (h, w, w1.shape[0], w1.shape[1])
            if key not in seen:
                seen.add(key)
                log(f"[convdp] time {name} {h}x{w} {w1.shape[0]}->"
                    f"{w1.shape[1]} bf16: kernel {ms:.4f} ms, plain "
                    f"{pms:.4f} ms")
        log(f"[convdp] {name} N={n} {h}x{w} {w1.shape[0]}->{w1.shape[1]}: "
            f"f32 err {err:.2e}, bf16 {ulps:.2f} ulp")
    log(f"[convdp] 640^2 b1 bf16, all units: kernel {t_kernel:.4f} ms, "
        f"plain {t_plain:.4f} ms")
    return max_err, t_kernel, t_plain


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
    from yunet_tpu_torch.ops.convdp import fused_conv_dp
    from yunet_tpu_torch.ops.nms import device_nms_batched, greedy_nms_keep

    rng = np.random.RandomState(2)
    imgs = [face_image(rng, 320, 320, rng.randint(2, 7)) for _ in range(16)]
    img640 = face_image(rng, 640, 640, 8)
    det = init_detector("yunet_n", FIXTURE, device=DEV)

    # the main path, with the launch counters from zero
    fused_conv_dp.launches = 0
    greedy_nms_keep.launches = 0
    batch = det.detect_batch(imgs, "AUTO", use_device_nms=True)
    fdet = Detector(det.cfg, det.model, device=DEV, fused=True)
    single = fdet.detect(img640, use_device_nms=True)
    torch.cuda.synchronize()
    launches = {"fused_conv_dp": fused_conv_dp.launches,
                "greedy_nms": greedy_nms_keep.launches}
    log(f"[slice] launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main path")
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
    # phase_convdp holds each unit to one bf16 ulp
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    # the package first: without it the script fails before printing
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.models.detector import YuNet
    from yunet_tpu_torch.models.fused import fold_inference_params
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build()
    nms_err, nms_t = phase_nms()
    cfg = yunet_n().model
    model = YuNet(cfg, device=DEV)
    model.load_state_dict(state_dict_from_jax(*load_flat_npz(FIXTURE, cfg)))
    conv_err, conv_ms, conv_plain = phase_convdp(
        fold_inference_params(model, cfg), cfg)
    _, fdet, launches = phase_slice()
    phase_times(fdet)

    kernels = [
        {"name": "greedy_nms", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/nms.cu",
         "replaces": "yunet_tpu/ops/nms_pallas.py:78",
         "also_replaces": "yunet_tpu/ops/nms_pallas.py:40",
         "launches": launches["greedy_nms"], "max_abs_err": nms_err,
         "ms": nms_t["ms"], "plain_ms": nms_t["plain_ms"]},
        {"name": "fused_conv_dp", "route": "cuda",
         "source": "yunet_tpu_torch/csrc/convdp.cu",
         "replaces": "yunet_tpu/ops/convdp_pallas.py:29",
         "launches": launches["fused_conv_dp"],
         "max_abs_err": conv_err["f32"], "ms": conv_ms,
         "plain_ms": conv_plain},
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
