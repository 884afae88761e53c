"""ONNX export CLI — counterpart of ``tools/yunet2onnx.py`` (reference
tools/yunet2onnx.py parity).

  python -m yunet_tpu_torch.tools.yunet2onnx yunet_n weights.pth \\
      --output yunet_n.onnx --shape 640 640 [--dynamic] [--verify]

Writes the JAX package's file from the same weights, byte for byte (12
outputs {cls,obj,bbox,kps}_{8,16,32}, sigmoid in-graph, BN folded; the
export runs on the host). ``--verify`` runs the written file through the
port's OnnxExecutor on ``--device`` and holds it to the port's f32 model
there (rtol 1e-3, atol 1e-5, the gate of the JAX CLI), with TF32 off on a
CUDA device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..apis import read_weights
from ..config import get_config
from ..export import export_onnx
from ..models.detector import YuNet


def load_model(cfg, checkpoint: str) -> YuNet:
    """The port's YuNet on the CPU with the weights in ``checkpoint``."""
    model = YuNet(cfg.model, device=torch.device("cpu"))
    model.load_state_dict(read_weights(cfg, checkpoint))
    return model


def flat_outputs(model: YuNet, img: np.ndarray) -> dict:
    """The model's outputs in the ONNX contract for an NCHW f32 batch:
    (B, HW, C) per level, sigmoid on cls/obj (in f64 on the host, as the
    JAX CLI's check does)."""
    device = next(model.parameters()).device
    with torch.no_grad():
        outs = model(torch.from_numpy(img).to(device))
    res = {}
    for key, sig in (("cls", True), ("obj", True), ("bbox", False),
                     ("kps", False)):
        for m, stride in zip(outs[key], model.cfg.strides):
            m = m.permute(0, 2, 3, 1).cpu().numpy()
            m = m.reshape(m.shape[0], -1, m.shape[-1])
            if sig:
                m = 1 / (1 + np.exp(-m.astype(np.float64)))
            res[f"{key}_{stride}"] = m.astype(np.float32)
    return res


def verify(path: str, model: YuNet, shape, device) -> float:
    """The written file through OnnxExecutor against ``model`` on
    ``device`` at ``shape`` (H, W), batch 1, a seeded random image; raises
    past rtol 1e-3 / atol 1e-5. Returns the largest absolute error."""
    from ..export.onnx_runtime import OnnxExecutor
    device = torch.device(device)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(0)
        img = rng.randint(0, 256, (1, 3) + tuple(shape)).astype(np.float32)
        got = OnnxExecutor(path, device=device)(img)
        want = flat_outputs(model.to(device), img)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    err = 0.0
    for k, m in want.items():
        np.testing.assert_allclose(got[k], m, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
        err = max(err, float(np.abs(got[k] - m).max()))
    return err


def main(argv=None, *, device="cuda"):
    """Export (and verify); returns the output path. ``device``: the
    default of ``--device``, where ``--verify`` runs."""
    p = argparse.ArgumentParser()
    p.add_argument("config", help="yunet_n | yunet_s")
    p.add_argument("checkpoint")
    p.add_argument("--output", default=None)
    p.add_argument("--shape", type=int, nargs="+", default=[640, 640])
    p.add_argument("--dynamic", action="store_true")
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default=device,
                   help="where --verify runs the file and the model")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    model = load_model(cfg, args.checkpoint)
    h, w = args.shape[0], args.shape[-1]
    blob = export_onnx(model, cfg.model, input_shape=(h, w),
                       dynamic=args.dynamic)
    out = args.output or (
        f"{args.config}_{'dynamic' if args.dynamic else f'{h}_{w}'}.onnx")
    with open(out, "wb") as f:
        f.write(blob)
    print(f"wrote {out} ({len(blob) / 1024:.0f} KB)")

    if args.verify:
        shape = (320, 320) if args.dynamic else (h, w)
        verify(out, model, shape, args.device)
        print("verification passed: onnx outputs match the torch model")
    return out


if __name__ == "__main__":
    main()
