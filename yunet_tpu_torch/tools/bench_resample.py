"""A/B: the dense against the row-tiled device_aug resample on the card —
the twin of ``tools/misc/bench_resample.py``.

The dense route (``device_resample`` without ``max_scale``) gathers whole
bank images and contracts the canvas height with a dense tent matrix; the
row-tiled route (``max_scale`` given) reads only the strip of rows an
output tile can touch and contracts over it. Both run f32 GEMMs on
operands rounded to the working dtype (data/device_aug.py), so in bf16 the
two give the same bits.

The variants take turns in windows, each window timed with CUDA events
over ``iters`` calls that cycle through the geometry batches. It prints
the median ms a batch, the GEMMs' FLOPs and the f32 bound (FLOPs over 67
TFLOP/s, the H100's f32 rate outside the tensor cores), and checks that
the two routes agree (bf16: equal; f32: within 1e-3). It needs a CUDA
device and has no CPU path:

    python -m yunet_tpu_torch.tools.bench_resample --batch 16
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data.device_aug import device_resample, row_tiling

F32_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores (data sheet)
CHOICES = (0.5, 0.7, 0.9, 1.1, 1.3, 1.5)


def make_geometry(rng: np.random.RandomState, batch: int, n_bank: int,
                  canvas: int, out_size: int, choices=CHOICES):
    """(idx, y0, x0, side, flip) numpy arrays: crops of choices x out_size
    that may reach past the canvas (gray-blend), as tools/misc/
    bench_resample.py draws them."""
    scale = rng.choice(choices, batch).astype(np.float32)
    side = scale * out_size
    y0 = rng.uniform(-0.2 * side, canvas - 0.8 * side).astype(np.float32)
    x0 = rng.uniform(-0.2 * side, canvas - 0.8 * side).astype(np.float32)
    idx = rng.randint(0, n_bank, batch).astype(np.int32)
    flip = rng.uniform(size=batch) < 0.5
    return idx, y0, x0, side, flip


def gemm_flops(batch: int, h: int, w: int, out_size: int, *,
               max_scale=None, tile=None) -> float:
    """The FLOPs of the two GEMMs device_resample runs on this shape: the
    y-stage over the canvas height (dense) or over each tile's strip, and
    the x-stage over the canvas width."""
    strip = row_tiling(out_size, h, max_scale, tile)[1] or h
    y = 2.0 * batch * out_size * strip * w * 3
    x = 2.0 * batch * out_size * out_size * w * 3
    return y + x


def run(bank: torch.Tensor, geos: Sequence[Tuple[torch.Tensor, ...]], *,
        out_size: int = 640, max_scale: float = max(CHOICES),
        dtypes: Sequence[torch.dtype] = (torch.bfloat16, torch.float32),
        windows: int = 5, iters: int = 6) -> Dict[str, dict]:
    """{"<route>_<dtype>": {"ms", "windows", "gflop", "bound_ms"}} and the
    routes' agreement, for device_resample on ``bank`` (a CUDA tensor) and
    each geometry batch of ``geos`` (tensors on the bank's device)."""
    if not bank.is_cuda:
        raise RuntimeError("bench_resample needs the bank on a CUDA device")
    variants = {}
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        variants[f"dense_{name}"] = dict(dtype=dt)
        variants[f"tiled_{name}"] = dict(dtype=dt, max_scale=max_scale)
    out: Dict[str, dict] = {}
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        worst = 0.0
        for g in geos:
            a = device_resample(bank, *g, out_size=out_size, dtype=dt)
            b = device_resample(bank, *g, out_size=out_size, dtype=dt,
                                max_scale=max_scale)
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        limit = 0.0 if dt == torch.bfloat16 else 1e-3
        if worst > limit:
            raise AssertionError(f"{name}: tiled and dense differ by {worst}"
                                 f" (limit {limit})")
        out[f"tiled_vs_dense_{name}_max_abs"] = worst
    times: Dict[str, List[float]] = {k: [] for k in variants}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for kw in variants.values():          # warm-up
        device_resample(bank, *geos[0], out_size=out_size, **kw)
    torch.cuda.synchronize()
    for _ in range(windows):
        for name, kw in variants.items():
            start.record()
            for i in range(iters):
                device_resample(bank, *geos[i % len(geos)],
                                out_size=out_size, **kw)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    batch = int(geos[0][0].shape[0])
    for name, kw in variants.items():
        flops = gemm_flops(batch, bank.shape[1], bank.shape[2], out_size,
                           max_scale=kw.get("max_scale"))
        out[name] = {"ms": statistics.median(times[name]),
                     "windows": times[name], "gflop": flops / 1e9,
                     "bound_ms": flops / F32_FLOPS * 1e3}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bank", type=int, default=64)
    ap.add_argument("--canvas", type=int, default=1152)
    ap.add_argument("--out-size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_resample needs a CUDA device")
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    bank = torch.from_numpy(rng.randint(
        0, 256, (args.bank, args.canvas, args.canvas, 3)).astype(
            np.uint8)).to(dev)
    geos = [tuple(torch.from_numpy(a).to(dev) for a in make_geometry(
        rng, args.batch, args.bank, args.canvas, args.out_size))
        for _ in range(3)]
    res = run(bank, geos, out_size=args.out_size, windows=args.windows,
              iters=args.iters)
    print(torch.cuda.get_device_name(0))
    for k, v in res.items():
        if isinstance(v, dict):
            print(f"{k}: median {v['ms']:.4f} ms a batch of {args.batch}, "
                  f"{v['gflop']:.2f} GFLOP, f32 bound {v['bound_ms']:.4f} "
                  f"ms; windows {[round(t, 4) for t in v['windows']]}")
        else:
            print(f"{k}: {v}")


if __name__ == "__main__":
    main()
