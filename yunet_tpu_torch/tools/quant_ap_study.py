"""Quantization AP study: float against fp16/dynamic/int8 TFLite files
through the full WIDER protocol on a synthetic val set — counterpart of
``tools/misc/quant_ap_study.py``.

Every engine letterboxes to the file's static input, decodes through the
same numpy path (``compare_inference.numpy_decode_yunet``) and is scored
by ``wider_evaluation`` against the GT .mat files, so the float-against-
quantized AP delta is measured, not asserted. The float32 anchor is the
ONNX export through compare_inference's ``onnx:`` engine (onnxruntime, or
the torch ONNX executor on ``device``); the rows ``none``, ``fp16``,
``dynamic`` and ``int8`` are ``export/tflite_export.py``'s files through
its ``tflite:`` engine.

This tool needs TensorFlow (the converter and the interpreter), so it
runs on a host that has it, not on the card host.

  python -m yunet_tpu_torch.tools.quant_ap_study \\
      --ckpt work_dirs/rehearsal/ckpt_00002400 \\
      --data data/synth_wider/val --shape 640 640

Writes the table to stdout (markdown).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from types import SimpleNamespace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AP of float against "
                                "quantized TFLite exports")
    p.add_argument("--ckpt", default="work_dirs/rehearsal/ckpt_00002400")
    p.add_argument("--data", default="data/synth_wider/val")
    p.add_argument("--config", default="yunet_n")
    p.add_argument("--shape", type=int, nargs=2, default=[640, 640],
                   help="H W static export shape")
    p.add_argument("--modes", nargs="+",
                   default=["none", "fp16", "dynamic", "int8"])
    p.add_argument("--limit", type=int, default=0,
                   help="0 = all (the .mat GT requires predictions for "
                   "every val image; use a limit only with a matching "
                   "GT subset)")
    p.add_argument("--rep-count", type=int, default=32)
    p.add_argument("--score-thr", type=float, default=0.02)
    p.add_argument("--cache-dir", default=None,
                   help="read val images from this decoded .npy cache "
                   "(data/cache.py layout) instead of decoding the JPEGs")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """Returns the rows [(name, bytes, [easy, medium, hard])]. ``device``:
    where the ONNX anchor's torch executor runs (the tests pass the CPU);
    the TFLite interpreter runs on the host."""
    args = parse_args(argv)
    from ..config import get_config
    from ..export.onnx_export import export_onnx
    from ..export.tflite_export import export_tflite
    from ..models.detector import YuNet
    from . import compare_inference as ci
    from .export_band_fixture import ema_checkpoint_state
    from .yunet2tflite import rep_images

    cfg = get_config(args.config)
    sd, step, _ = ema_checkpoint_state(cfg, os.path.abspath(args.ckpt))
    model = YuNet(cfg.model, device="cpu")
    model.load_state_dict(sd)
    model.eval()
    print(f"checkpoint {args.ckpt} (step {step}, EMA params)")
    h, w = args.shape

    ev = SimpleNamespace(
        ann=os.path.join(args.data, "labelv2.txt"),
        img_prefix=os.path.join(args.data, "images"),
        gt_dir=os.path.join(args.data, "gt"),
        mode=None, limit=args.limit, cache_dir=args.cache_dir)

    rows = []
    with tempfile.TemporaryDirectory() as d:
        onnx_p = os.path.join(d, "m.onnx")
        with open(onnx_p, "wb") as f:
            f.write(export_onnx(model, cfg.model, input_shape=(h, w)))
        eng = ci.build_engine(f"onnx:{onnx_p}", score_thr=args.score_thr,
                              device=device)
        aps = ci.run_eval(eng, "onnx float32 (anchor)", ev)
        rows.append(("onnx float32", os.path.getsize(onnx_p), aps))

        cal = None
        for mode in args.modes:
            if mode == "int8" and cal is None:
                train_imgs = os.path.join(
                    os.path.dirname(args.data.rstrip("/")),
                    "train", "images")
                cal = list(rep_images(
                    h, w, train_imgs if os.path.isdir(train_imgs)
                    else None, args.rep_count))
                src = ("train split" if os.path.isdir(train_imgs)
                       else "synthetic renders")
                print(f"int8 calibration: {len(cal)} images ({src})")
            tp = os.path.join(d, f"m_{mode}.tflite")
            with open(tp, "wb") as f:
                f.write(export_tflite(
                    model, cfg.model, input_shape=(h, w),
                    quantize=mode, rep_images=cal))
            eng = ci.build_engine(f"tflite:{tp}", score_thr=args.score_thr,
                                  device=device)
            aps = ci.run_eval(eng, f"tflite {mode}", ev)
            rows.append((f"tflite {mode}", os.path.getsize(tp), aps))

    print(f"\n| artifact ({w}x{h} letterbox) | KB | AP easy | AP medium "
          "| AP hard |")
    print("|---|---|---|---|---|")
    for name, size, aps in rows:
        print(f"| {name} | {size // 1024} | {aps[0]:.4f} | {aps[1]:.4f} "
              f"| {aps[2]:.4f} |")
    return rows


if __name__ == "__main__":
    main()
