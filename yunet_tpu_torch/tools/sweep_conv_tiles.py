"""Time block tiles of ``csrc/scrfd_conv.cu`` on each conv of a folded
detect trunk, on the card, and print the fastest beside the one
``ops/conv_epi.py:tiles``' rule gives and the one ``conv_epi`` picked (a
wide conv's timed pick, at the trunk's first run): the sweep that SCRFD's
rule in ``tiles`` was fitted to, and a check of the timed picks.

  python -m yunet_tpu_torch.tools.sweep_conv_tiles retinaface_r50 \\
      [--shape 640 640] [--batch 1] [--out sweep.json]

The preset's folded bf16 trunk (seeded weights, a seeded 0-255 input)
runs once; each distinct conv it issues (shape, stride, shortcut, output
view) then runs REPS launches captured as one CUDA graph and replayed,
timed with CUDA events, for each tile of ``conv_epi.candidates``. Prints a
line a conv and the totals a forward (each conv's time times its count),
and writes every timing as JSON with --out. Needs a CUDA device: exits 1
without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys

import torch

REPS = 20                   # launches a graph


def record_convs(cfg, batch: int, h: int, w: int):
    """Every conv_epi call of one folded bf16 forward on the card, as
    (args, kwargs)."""
    from ..models import architecture, retinaface, scrfd
    from ..ops import conv_epi as ce
    gen = torch.Generator().manual_seed(0)
    model = architecture(cfg.model)(cfg.model, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (2.0 / p[0].numel()) ** 0.5)
    folded = model.to("cuda").fold(torch.bfloat16)
    x = torch.randint(0, 256, (batch, h, w, 3), generator=gen).to(
        "cuda", torch.bfloat16).permute(0, 3, 1, 2)
    calls = []

    def record(*args, **kw):
        calls.append((args, dict(kw)))
        return real(*args, **kw)

    real = ce.conv_epi
    mods = (retinaface, scrfd)
    for m in mods:
        m.conv_epi = record
    try:
        with torch.inference_mode():
            type(model).forward_folded(folded, x, cfg.model,
                                       use_kernel=True)
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.conv_epi = real
    return calls


def key(args, kw):
    x, w = args[0], args[1]
    out = kw.get("out")
    return (x.shape[0], x.shape[2], x.shape[3], x.shape[1], w.shape[0],
            w.shape[-1], kw["stride"], kw.get("residual") is not None,
            kw.get("upsample", 1), bool(kw.get("post_add")),
            out is not None)


def time_tile(args, kw, tile) -> float:
    """us a launch of the conv with ``tile``, REPS launches replayed as
    one graph, median of five replays."""
    from ..ops import conv_epi as ce
    real = ce._pick_tile
    ce._pick_tile = lambda device, shape, launch: tile
    try:
        with torch.inference_mode():
            ce.conv_epi(*args, **kw)                 # refusals raise here
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                ce.conv_epi(*args, **kw)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(REPS):
                    ce.conv_epi(*args, **kw)
    finally:
        ce._pick_tile = real
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / REPS)
    return statistics.median(times)


def main(argv=None) -> int:
    from ..config import get_config
    from ..ops import conv_epi as ce
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--shape", type=int, nargs=2, default=[640, 640])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_conv_tiles: no CUDA device", file=sys.stderr)
        return 1
    cfg = get_config(args.config)
    calls = record_convs(cfg, args.batch, *args.shape)
    groups = collections.OrderedDict()
    for a, kw in calls:
        groups.setdefault(key(a, kw), []).append((a, kw))
    rows, sums = [], dict.fromkeys(("rule", "picked", "best"), 0.0)
    for k, members in groups.items():
        a, kw = members[0]
        n, _, _, cin, cout, ks, stride = k[:7]
        ho, wo = ce._out_hw(a[0], a[1], stride)
        shape = (n, ho, wo, cin, cout, ks, stride)
        timed = {}
        for tile in ce.candidates(*shape):
            try:
                timed[tile] = time_tile(a, kw, tile)
            except RuntimeError:
                continue
        picks = {"rule": ce.tiles(*shape),
                 "picked": ce._TUNED.get((a[0].device.index, shape),
                                         ce.tiles(*shape)),
                 "best": min(timed, key=timed.get)}
        row = {"conv": k, "out": [ho, wo], "count": len(members),
               "top": sorted(timed.items(), key=lambda kv: kv[1])[:8],
               "all": sorted(timed.items())}
        for name, tile in picks.items():
            sums[name] += timed[tile] * len(members)
            row[name] = [tile, timed[tile]]
        rows.append(row)
        print(f"{k} -> {ho}x{wo} x{len(members)}: " + ", ".join(
            f"{name} {tile} {timed[tile]:.2f} us"
            for name, tile in picks.items()), flush=True)
    print(f"{len(calls)} convs, us a forward: " + ", ".join(
        f"{name} {us:.1f}" for name, us in sums.items())
        + f" ({torch.cuda.get_device_name(0)})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"config": args.config, "shape": args.shape,
                       "batch": args.batch, "convs": rows,
                       **{f"{name}_us": us for name, us in sums.items()}},
                      f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
