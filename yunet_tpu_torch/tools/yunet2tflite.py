"""TFLite export CLI — counterpart of ``tools/yunet2tflite.py`` (reference
tools/yunet2tflite.py surface). A host tool: it needs TensorFlow, and the
weights load on the CPU.

  python -m yunet_tpu_torch.tools.yunet2tflite yunet_n weights.pth \\
      --output yunet_n.tflite --shape 256 320 [--quantize int8] [--verify]

The TF graph is built from the port's weights (BN folded) and converted
with tf.lite.TFLiteConverter; ``--verify`` runs the flatbuffer with
tf.lite.Interpreter and holds it to the port's f32 model.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from ..config import get_config
from ..ops.resize import resize
from .detect_image import read_image
from .make_synth_wider import make_image
from .yunet2onnx import flat_outputs, load_model


def rep_images(h, w, img_dir=None, count=32):
    """Calibration batches (1, 3, H, W) float32 raw-BGR for int8 PTQ.

    From a directory of images (.npy, or .jpg/.jpeg/.png/.bmp through
    cv2), letterboxed like the serving path with ``ops/resize.py`` (the
    bytes of cv2.resize), when given; else synthetic face renders
    (``make_synth_wider.make_image``, as the JAX CLI draws them).
    """
    if img_dir:
        paths = sorted(
            p for p in glob.glob(os.path.join(img_dir, "**", "*"),
                                 recursive=True)
            if p.lower().endswith((".npy", ".jpg", ".jpeg", ".png",
                                   ".bmp")))
        if not paths:
            raise SystemExit(f"no images under {img_dir}")
        for p in paths[:count]:
            img = read_image(p)
            s = min(w / img.shape[1], h / img.shape[0])
            rs = resize(torch.from_numpy(img), (
                max(1, int(img.shape[1] * s)),
                max(1, int(img.shape[0] * s)))).numpy()
            canvas = np.zeros((h, w, 3), np.uint8)
            canvas[:rs.shape[0], :rs.shape[1]] = rs
            yield np.transpose(canvas.astype(np.float32), (2, 0, 1))[None]
        return
    rng = np.random.RandomState(7)
    for _ in range(count):
        img = make_image(rng, w, h)[0]
        yield np.transpose(img.astype(np.float32), (2, 0, 1))[None]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("checkpoint")
    p.add_argument("--output", default=None)
    p.add_argument("--shape", type=int, nargs="+", default=[256, 320],
                   help="H W (reference default 256x320)")
    p.add_argument("--verify", action="store_true",
                   help="run the .tflite and compare against the model")
    p.add_argument("--quantize",
                   choices=["none", "fp16", "dynamic", "int8"],
                   default="none",
                   help="post-training quantization: fp16 weights, "
                   "dynamic-range (int8 weights), or full-integer "
                   "(int8 weights + activations, calibrated)")
    p.add_argument("--rep-images", default=None,
                   help="directory of calibration images for --quantize "
                   "int8 (default: 32 synthetic face renders)")
    p.add_argument("--rep-count", type=int, default=32)
    args = p.parse_args(argv)

    try:
        import tensorflow  # noqa: F401
    except ImportError:
        print("tensorflow is not installed; cannot convert. "
              "Use yunet_tpu_torch.tools.yunet2onnx + onnx2tf on a "
              "machine with TF.")
        return 1

    from ..export.tflite_export import export_tflite, run_tflite

    cfg = get_config(args.config)
    model = load_model(cfg, args.checkpoint)
    h, w = args.shape[0], args.shape[-1]
    out_path = args.output or f"{args.config}_{w}x{h}.tflite"
    rep = None
    if args.quantize == "int8":
        rep = list(rep_images(h, w, args.rep_images, args.rep_count))
        print(f"calibrating int8 on {len(rep)} images")
    blob = export_tflite(model, cfg.model, input_shape=(h, w),
                         quantize=args.quantize, rep_images=rep)
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"wrote {out_path} ({len(blob) // 1024} KB, "
          f"quantize={args.quantize})")

    if args.verify:
        rng = np.random.RandomState(0)
        if args.quantize == "none":
            img = rng.randint(0, 256, (1, 3, h, w)).astype(np.float32)
        else:
            # verify quantized models on in-distribution content
            face = make_image(rng, w, h)[0]
            img = np.transpose(face.astype(np.float32), (2, 0, 1))[None]
        got = run_tflite(blob, img)
        want = flat_outputs(model, img)
        for key, sig in (("cls", True), ("obj", True), ("bbox", False),
                         ("kps", False)):
            names = [f"{key}_{s}" for s in cfg.model.strides]
            if args.quantize == "none":
                for k in names:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                               atol=1e-4, err_msg=k)
                continue
            # int8/dynamic PTQ: correlation gate over all levels of the
            # branch (per-level maps can be as small as 12 values) + a
            # loose bound for the sigmoid-squashed maps
            a = np.concatenate([got[k].ravel() for k in names])
            b = np.concatenate([want[k].ravel() for k in names])
            cc = float(np.corrcoef(a, b)[0, 1])
            if not cc > 0.97:
                raise AssertionError(f"{key}: corr {cc:.4f}")
            err = float(np.abs(a - b).max())
            if sig and not err < 0.2:
                raise AssertionError(f"{key}: max sigmoid err {err:.3f}")
        print("verification passed: tflite outputs match the torch model"
              + ("" if args.quantize == "none"
                 else " (quantized, correlation gate)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
