"""Drive the port's CUDA kernels on the card and differential-check them
against their plain versions — counterpart of
``tools/misc/verify_device_kernels.py``, the on-card complement to the CPU
tests (which run the plain versions only: a CUDA kernel cannot run
without a card).

  python -m yunet_tpu_torch.tools.verify_device_kernels          # all
  python -m yunet_tpu_torch.tools.verify_device_kernels --quick  # no SimOTA

JAX's two checks on JAX's seeded inputs:

  * nms: the batched greedy-NMS kernel's keep sets (K2) equal the
    per-image ones (K3, the same kernel at B=1) and the plain suppression
    loop's, at (B, P, top_k) = (4, 400, 256) and (2, 900, 750) with 0, 1,
    12 and 60 candidates an image;
  * simota: fg_mask and matched_gt of the streamed SimOTA kernel (K1,
    standing for K7 too) equal the dense plain assignment's (B=4, P=8400,
    G=32).

One check for each of the other three kernels, at one small shape, through
the per-call checkers that chip_smoke.py's kernel phases call at the main
path's shapes (``convdp_f32_call``, ``convdp_bf16_call``,
``convdp_bwd_call``, ``convdp_cm_call``):

  * convdp (K4): f32 within rtol/atol 1e-5; bf16 within
    ``ops/convdp.py:BF16_EXCESS_LIMIT`` of ``bf16_excess``;
  * convdp_bwd (K5): every gradient within 1e-4 of its largest magnitude,
    bf16's dx beyond one bf16 ulp;
  * convdp_cm (K6): against its plain version and the NHWC kernel, f32
    within rtol/atol 1e-5; bf16 within one bf16 ulp of the channel's
    largest |y1| times sum|wd|, plus one ulp.

Each bf16 call must take the tensor-core route (its wrapper's
``launches_mma`` rises by one) and repeat bit for bit.

Prints PASS/FAIL per check (``check_all`` returns each check's error or
None); exit code 0 iff all pass. There is no CPU path:
without a CUDA device it exits 1 (the plain version against itself would
check nothing).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

IOU, SCORE = 0.45, 0.02
F32_TOL = 1e-5            # rtol and atol, f32 ConvDP outputs
GRADS = ("dx", "dw1", "db1", "dwd", "dbd")
# K5, kernel against its plain version, as shares of each gradient's
# largest magnitude: f32 sums over up to 409,600 positions in another
# order (the kernel's per-block sums and fixed-order reduction against
# torch's reductions and f32 matmuls; in bf16 the recomputed y1, rounded to
# bf16 after sums in another order, may round the other way). Measured on
# an H100 at most 4.4e-6. dx in bf16, rounded once by both, may differ by
# one bf16 ulp more: where its sum cancels, the f32 noise of the sum order
# is many ulps of the small result
BWD_TOL = 1e-4


def _boxes(rng, n):
    xy = rng.uniform(0, 900, (n, 2)).astype(np.float32)
    wh = rng.uniform(8, 120, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


def nms_inputs(quick=False):
    """[(boxes (B, n, 4), scores (B, n), top_k)] from RandomState(77), as
    JAX's check_nms draws them."""
    rng = np.random.RandomState(77)
    shapes = ((4, 400, 256), (2, 900, 750)) if not quick else ((4, 400, 256),)
    out = []
    for bsz, n, top_k in shapes:
        boxes = np.stack([_boxes(rng, n) for _ in range(bsz)])
        scores = rng.uniform(0, 0.003, (bsz, n)).astype(np.float32)
        counts = [0, 1, 12, min(60, n)][:bsz]
        for b, cnt in enumerate(counts):
            scores[b, rng.choice(n, cnt, replace=False)] = rng.uniform(
                0.1, 1.0, cnt)
        out.append((boxes, scores, top_k))
    return out


def plain_nms(boxes, scores, top_k):
    """(keep (B, K), idx (B, K)) of the plain suppression loop."""
    from ..ops.nms import greedy_nms_keep_plain, topk_candidates
    top_boxes, _, idx, counts = topk_candidates(boxes, scores, top_k, SCORE)
    return greedy_nms_keep_plain(top_boxes.contiguous(), counts, IOU), idx


def check_nms(device, quick=False):
    """The batched kernel, the per-image kernel and the plain loop give
    the same keep sets and candidate indices, including the sparse-score
    regime (0 / 1 / few / many candidates an image)."""
    from ..ops.nms import device_nms, device_nms_batched
    for boxes, scores, top_k in nms_inputs(quick):
        bsz, n = scores.shape
        bt = torch.from_numpy(boxes).to(device)
        st = torch.from_numpy(scores).to(device)
        t0 = time.perf_counter()
        _, kb, ib = device_nms_batched(bt, st, top_k=top_k, iou_thr=IOU,
                                       score_thr=SCORE)
        kb_h = kb.cpu()
        dt = time.perf_counter() - t0
        k0, i0 = plain_nms(bt, st, top_k)
        for b in range(bsz):
            _, k1, i1 = device_nms(bt[b], st[b], top_k=top_k, iou_thr=IOU,
                                   score_thr=SCORE)
            for what, got, want in (("batched keep", kb_h[b], k1),
                                    ("per-image keep", k1, k0[b]),
                                    ("batched idx", ib[b], i1),
                                    ("per-image idx", i1, i0[b])):
                if not torch.equal(got.cpu(), want.cpu()):
                    raise AssertionError(f"{what} differs at b{bsz}/n{n}/"
                                         f"k{top_k} image {b}")
        print(f"  nms b{bsz}/n{n}/k{top_k}: keep sets identical "
              f"(batched kernel run {dt:.2f}s)")


def simota_inputs():
    """(scores, priors, decoded, gt_bboxes, gt_labels, gt_valid) numpy
    arrays from RandomState(7), as JAX's check_simota draws them."""
    rng = np.random.RandomState(7)
    b, p, g = 4, 8400, 32
    pri = np.stack([rng.uniform(0, 640, p), rng.uniform(0, 640, p),
                    np.full(p, 8.0), np.full(p, 8.0)], -1).astype(
        np.float32)
    scores = rng.uniform(1e-4, 1, (b, p, 1)).astype(np.float32)
    c = rng.uniform(20, 600, (b, p, 2))
    wh = rng.uniform(4, 80, (b, p, 2))
    dec = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    gc = rng.uniform(20, 600, (b, g, 2))
    gwh = rng.uniform(8, 100, (b, g, 2))
    gtb = np.concatenate([gc - gwh / 2, gc + gwh / 2], -1).astype(
        np.float32)
    return (scores, pri, dec, gtb, np.zeros((b, g), np.int32),
            rng.uniform(size=(b, g)) < 0.7)


def check_simota(device):
    """The streamed SimOTA kernel against the dense plain assignment."""
    from ..ops.assign import sim_ota_assign_batched
    args = [torch.from_numpy(a).to(device) for a in simota_inputs()]
    r_d = sim_ota_assign_batched(*args, use_streamed=False)
    r_k = sim_ota_assign_batched(*args, use_streamed=True)
    b, p, g = args[0].shape[0], args[1].shape[0], args[3].shape[1]
    for what in ("fg_mask", "matched_gt"):
        if not torch.equal(getattr(r_d, what), getattr(r_k, what)):
            raise AssertionError(f"simota {what}: kernel != dense")
    print("  simota: streamed kernel == dense assignment "
          f"(b{b}, P={p}, G={g})")


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _route(fn, before, want, what):
    """The wrapper's tensor-core route counter rose by ``want`` since
    ``before``."""
    got = fn.launches_mma - before
    if got != want:
        raise AssertionError(f"{what}: {got} tensor-core route launches, "
                             f"{want} expected")


def convdp_f32_call(label, x, w1, b1, wd, bd, relu):
    """One f32 ConvDP kernel call (K4, the scalar route) against its plain
    version, within rtol/atol F32_TOL. Returns the max abs error."""
    from ..ops.convdp import fused_conv_dp, fused_conv_dp_plain
    got = fused_conv_dp(x, w1, b1, wd, bd, relu=relu)
    want = fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu)
    _sync(x)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL):
        raise AssertionError(f"ConvDP kernel != plain (f32) at {label}: max "
                             f"abs err {err} (rtol/atol {F32_TOL})")
    return err


def convdp_bf16_call(label, x, w1, b1, wd, bd, relu):
    """One bf16 ConvDP kernel call (K4) against its plain version:
    ``bf16_excess`` within BF16_EXCESS_LIMIT; on a card, on the tensor-core
    route (its counter rises by one) where the channels allow, and a second
    call bit-equal. Returns (excess, elements more than one bf16 ulp
    off)."""
    from ..ops.convdp import (BF16_EXCESS_LIMIT, bf16_excess, fused_conv_dp,
                              fused_conv_dp_plain, ulp_bf16)
    before = fused_conv_dp.launches_mma
    got = fused_conv_dp(x, w1, b1, wd, bd, relu=relu)
    _route(fused_conv_dp, before, int(x.is_cuda and max(w1.shape) <= 64),
           f"ConvDP {label} bf16")
    again = fused_conv_dp(x, w1, b1, wd, bd, relu=relu)
    want = fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu)
    _sync(x)
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


def convdp_bwd_call(label, x, w1, b1, wd, dz):
    """One ConvDP backward kernel call (K5) against its plain version:
    each gradient within BWD_TOL of its largest magnitude, bf16's dx
    beyond one bf16 ulp. On a card also: the call took the route of its
    dtype (the tensor-core one for bf16, by its counter), and a second
    bf16 call gives the same gradients bit for bit. Returns ({gradient:
    share}, the f32 max abs diff (0 for bf16))."""
    from ..ops.convdp import ulp_bf16
    from ..ops.convdp_train import fused_pw_dw_bwd, fused_pw_dw_bwd_plain
    bf16 = x.dtype == torch.bfloat16
    before = fused_pw_dw_bwd.launches_mma
    got = fused_pw_dw_bwd(x, w1, b1, wd, dz)
    _route(fused_pw_dw_bwd, before, int(x.is_cuda and bf16),
           f"convdp_bwd {label} {x.dtype}")
    want = fused_pw_dw_bwd_plain(x, w1, b1, wd, dz)
    _sync(x)
    shares, abs_err = {}, 0.0
    for name, g, wt in zip(GRADS, got, want):
        if g.shape != wt.shape or g.dtype != wt.dtype:
            raise AssertionError(f"convdp_bwd {label}: {name} "
                                 f"{g.shape}/{g.dtype} vs plain "
                                 f"{wt.shape}/{wt.dtype}")
        d = (g.float() - wt.float()).abs()
        if name == "dx" and bf16:
            # what is left over one bf16 ulp
            d = (d - ulp_bf16(torch.maximum(g.float().abs(),
                                            wt.float().abs()))).clamp_min(0)
        elif not bf16:
            abs_err = max(abs_err, float(d.max()))
        shares[name] = float(d.max() / wt.float().abs().max()
                             .clamp_min(1e-30))
    if bf16:
        again = fused_pw_dw_bwd(x, w1, b1, wd, dz)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"convdp_bwd {label}: two bf16 calls gave "
                                 "different gradients")
    bad = {k: v for k, v in shares.items() if v > BWD_TOL}
    if bad:
        raise AssertionError(f"convdp_bwd kernel != plain at {label} "
                             f"{x.dtype}: {bad} (tolerance {BWD_TOL})")
    return shares, abs_err


def convdp_cm_call(label, x32, w1, b1, wd, bd, log=None):
    """The channels-major kernel (K6) on x32 (N, H, W, Cin; f32) laid out
    as (H, Cin, W*N), in f32 and bf16, with and without ReLU, against its
    plain version and against the NHWC kernel on the same data. f32 (the
    scalar route) within rtol/atol F32_TOL: sums in another order. bf16:
    y1 is rounded to bf16 (the plain version too, after another sum order,
    so it may round the other way; the NHWC kernel keeps it f32), which
    moves an output by at most one bf16 ulp of its channel's largest |y1|
    through the nine taps, plus one ulp of the output. On a card, every
    bf16 call at 64 channels or fewer on the tensor-core route, and a
    second call bit-equal. ``log`` takes a line for each comparison.
    Returns (f32 max abs err against the plain version, worst bf16 diff as
    a share of its tolerance)."""
    from ..ops.convdp import fused_conv_dp, ulp_bf16
    from ..ops.convdp_cm import fused_conv_dp_cm, fused_conv_dp_cm_plain
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
            _route(fused_conv_dp_cm, before,
                   int(x32.is_cuda and bf16 and max(cin, cout) <= 64),
                   f"convdp_cm {label} {dt}")
            if bf16:
                again = fused_conv_dp_cm(xc, w1, b1, wd, bd, w=w, n=n,
                                         relu=relu)
            plain = fused_conv_dp_cm_plain(xc, w1, b1, wd, bd, w=w, n=n,
                                           relu=relu)
            k4 = fused_conv_dp(xn, w1, b1, wd, bd, relu=relu).permute(
                1, 3, 2, 0).reshape(h, cout, w * n)
            _sync(x32)
            if bf16 and not torch.equal(got, again):
                raise AssertionError(f"convdp_cm {label} bf16: two calls "
                                     "differ")
            g = got.float()
            for what, ref in (("plain", plain.float()), ("nhwc", k4.float())):
                d = (g - ref).abs()
                if not bf16:
                    if what == "plain":
                        f32_err = max(f32_err, float(d.max()))
                    ok = bool((d <= F32_TOL + F32_TOL * ref.abs()).all())
                else:
                    tol = y1_tol + ulp_bf16(torch.maximum(g.abs(),
                                                          ref.abs()))
                    share = max(share, float((d / tol).max()))
                    ok = bool((d <= tol).all())
                if log is not None:
                    log(f"{label} {str(dt)[6:]} relu={relu} kernel vs "
                        f"{what}: max abs diff {float(d.max()):.3e}")
                if not ok:
                    raise AssertionError(f"convdp_cm kernel != {what} at "
                                         f"{label} ({dt}, relu={relu})")
            del got, plain, k4, g
    return f32_err, share


def _unit(rng, cin, cout, device):
    """Seeded (w1, b1, wd, bd) of one ConvDPUnit on ``device``."""
    return [torch.from_numpy(a).to(device) for a in (
        rng.randn(cin, cout).astype(np.float32) * 0.2,
        rng.randn(cout).astype(np.float32) * 0.2,
        rng.randn(9, cout).astype(np.float32) * 0.2,
        rng.randn(cout).astype(np.float32) * 0.2)]


def check_convdp(device):
    """K4 at (N, H, W) = (2, 37, 45), 16 -> 64, with and without ReLU."""
    rng = np.random.RandomState(11)
    w1, b1, wd, bd = _unit(rng, 16, 64, device)
    x = torch.from_numpy(rng.uniform(0, 3, (2, 37, 45, 16)).astype(
        np.float32)).to(device)
    for relu in (True, False):
        label = f"37x45 16->64 relu={relu}"
        err = convdp_f32_call(label, x, w1, b1, wd, bd, relu)
        excess, _ = convdp_bf16_call(label, x.to(torch.bfloat16), w1, b1,
                                     wd, bd, relu)
        print(f"  convdp relu={relu}: f32 max abs err {err:.2e}, bf16 excess "
              f"{excess:.3f} of 2^-24 S")


def check_convdp_bwd(device):
    """K5 at (N, H, W) = (2, 21, 19), 16 -> 64, f32 and bf16."""
    rng = np.random.RandomState(12)
    w1, b1, wd, _ = _unit(rng, 16, 64, device)
    x32 = torch.from_numpy(rng.uniform(0, 3, (2, 21, 19, 16)).astype(
        np.float32)).to(device)
    dz32 = torch.from_numpy(rng.randn(2, 21, 19, 64).astype(
        np.float32)).to(device)
    for dt in (torch.float32, torch.bfloat16):
        shares, _ = convdp_bwd_call("21x19 16->64", x32.to(dt), w1, b1, wd,
                                    dz32.to(dt))
        print(f"  convdp_bwd {str(dt)[6:]}: worst share "
              f"{max(shares.values()):.2e}")


def check_convdp_cm(device):
    """K6 at (N, H, W) = (8, 12, 16), 16 -> 32, in the (H, C, W*N) layout,
    f32 and bf16, with and without ReLU."""
    rng = np.random.RandomState(13)
    w1, b1, wd, bd = _unit(rng, 16, 32, device)
    x32 = torch.from_numpy(rng.uniform(0, 3, (8, 12, 16, 16)).astype(
        np.float32)).to(device)
    err, share = convdp_cm_call("12x16 16->32 N=8", x32, w1, b1, wd, bd)
    print(f"  convdp_cm: f32 max abs err {err:.2e}, bf16 diff at most "
          f"{share:.3f} of its tolerance")


CHECKS = ("nms", "simota", "convdp", "convdp_bwd", "convdp_cm")


def check_all(device, quick=False):
    """Runs each check of CHECKS on ``device`` (a CUDA device), printing
    PASS or FAIL for each; ``quick`` skips simota. Returns {check: None if
    it passed, else its error}."""
    results = {}
    for name in CHECKS:
        if quick and name == "simota":
            continue
        try:
            if name == "nms":
                check_nms(device, quick)
            else:
                globals()[f"check_{name}"](device)
            torch.cuda.synchronize(device)
            results[name] = None
            print(f"PASS {name}")
        except Exception as e:  # noqa: BLE001 (report each check, go on)
            results[name] = f"{type(e).__name__}: {e}"
            print(f"FAIL {name}: {results[name]}")
    return results


def main(argv=None, *, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="skip SimOTA")
    args = p.parse_args(argv)

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        print(f"verify_device_kernels: no CUDA device (asked for {device}); "
              "the kernels run only on a card, and the plain versions are "
              "checked by the CPU tests", file=sys.stderr)
        return 1
    device = torch.device(device)
    print(f"device: {torch.cuda.get_device_name(device)}")

    results = check_all(device, args.quick)
    return 1 if any(results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
