"""Profile the batched serving program — counterpart of
``tools/misc/profile_serve.py``.

The program is the port's counterpart of ``bench.py:_serve_fn``:
``Detector(fused=True)`` in bf16 calling ``serve_packed(x, 512)`` (folded
trunk on the library convs, decode, the whole-batch greedy-NMS kernel) at
320x320. It runs one call to warm up, traces ``--iters`` calls under
``utils/profiling.trace``, and prints the per-category / per-op device
table (on the card it names the NMS kernel's ``nms_mask_kernel`` and
``nms_scan_kernel``) and the device-time throughput bound. A run on the
CPU has no device lane and ends in that error.

Weights: ``--weights`` (a flat .npz of JAX leaves, a reference .pth or a
training checkpoint directory); by default tests/fixtures/r04_ema.npz for
yunet_n. The repository holds no yunet_s weights, so yunet_s without
``--weights`` runs a seeded random init (``apis.init_detector``), as JAX's
tool does when its .pth is missing, and says so.

JAX's --stem-s2d, --ab-composed and --ab-stem (TPU layout variants of the
same function) have no counterpart.

  python -m yunet_tpu_torch.tools.profile_serve --batch 16 --iters 20
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

TOP_K = 512          # bench.py:_serve_fn's pallas_nms_batched top_k
CANVAS = 320
R04 = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "r04_ema.npz")


def main(argv=None, *, device="cuda"):
    """Returns the trace's (us, launches) Counters by kernel name, or None
    when the trace holds no device event (the error is printed)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20,
                    help="dispatches inside the trace")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--config", default="yunet_n",
                    choices=["yunet_n", "yunet_s"])
    ap.add_argument("--weights", default=None,
                    help="default: tests/fixtures/r04_ema.npz for yunet_n, "
                    "a seeded random init for yunet_s")
    ap.add_argument("--out", default=None,
                    help="trace directory (default: yunet_serve_trace under "
                    "the temporary directory)")
    args = ap.parse_args(argv)

    from ..apis import init_detector
    from ..utils.profiling import default_trace_dir, trace
    from ..utils.trace_profile import NoDeviceEvents, aggregate_trace, report

    out_dir = args.out or default_trace_dir("yunet_serve_trace")
    weights = args.weights or (R04 if args.config == "yunet_n" else None)
    if weights is None:
        print(f"{args.config}: no weights given; a seeded random init")
    det = init_detector(args.config, weights, device=device, fused=True)
    serve = det.serve_packed

    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randint(0, 256, (args.batch, CANVAS, CANVAS,
                                                3)).astype(np.uint8))
          .to(device) for _ in range(4)]
    serve(xs[0], TOP_K).cpu()

    with trace(out_dir):
        out = None
        for i in range(args.iters):
            out = serve(xs[i % 4], TOP_K)
        out.cpu()

    try:
        tot, cnt = aggregate_trace(out_dir)
    except (FileNotFoundError, NoDeviceEvents) as e:
        print(e)
        return None
    report(tot, cnt, args.iters, args.top)
    ms = sum(tot.values()) / args.iters / 1e3
    print(f"\ndevice-time throughput bound: "
          f"{args.batch / (ms / 1e3):.0f} img/s at batch {args.batch} "
          f"(wall-clock bench adds dispatch/host overhead)")
    return tot, cnt


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
