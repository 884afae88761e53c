"""TFLite export of YuNet via tf.lite.TFLiteConverter — counterpart of
``yunet_tpu/export/tflite_export.py``.

The reference converts its torch model with Alibaba TinyNN
(tools/yunet2tflite.py:80-97, default input 1x3x256x320). Here the TF
graph is built from the port's ``YuNet`` weights, BatchNorm folded into
the depthwise convolutions as in the C++ and ONNX exporters, the same
graph the JAX package builds. The body runs NHWC (TFLite's layout); the
graph input is NCHW (1, 3, H, W), as for every engine (ONNX, C++,
TFLite), with a single Transpose after the input.

Outputs: the twelve {cls,obj,bbox,kps}_{8,16,32} tensors of shape
(B, HW, C), sigmoid baked in for cls/obj — export_onnx's contract.

TensorFlow is imported lazily; everything here is host-side tooling.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import ModelConfig
from ..models.fused import fold_conv_bn
from ..models.layers import ConvDPUnit
from .cpp_export import _np


def _hwio(w_oihw: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(_np(w_oihw).transpose(2, 3, 1, 0))


def _conv(tf, x, w_oihw, b, *, stride: int = 1, pad: int = 0):
    """Plain conv, explicit symmetric padding."""
    if pad:
        x = tf.pad(x, [[0, 0], [pad, pad], [pad, pad], [0, 0]])
    y = tf.nn.conv2d(x, _hwio(w_oihw), strides=stride, padding="VALID")
    return y + _np(b)


def _dwconv(tf, x, w_oihw, b, *, pad: int = 1):
    """Depthwise 3x3: the OIHW weight is (C, 1, kh, kw); TF wants
    (kh, kw, C, 1)."""
    w = np.ascontiguousarray(_np(w_oihw).transpose(2, 3, 0, 1))
    if pad:
        x = tf.pad(x, [[0, 0], [pad, pad], [pad, pad], [0, 0]])
    y = tf.nn.depthwise_conv2d(x, w, strides=[1, 1, 1, 1], padding="VALID")
    return y + _np(b)


def _convdp(tf, x, unit: ConvDPUnit):
    """ConvDPUnit: 1x1 pw -> 3x3 dw (+ folded BN + ReLU when present)."""
    x = _conv(tf, x, unit.conv1.weight, unit.conv1.bias)
    if unit.bn is not None:
        w2, b2 = fold_conv_bn(unit.conv2.weight, unit.conv2.bias, unit.bn)
        return tf.nn.relu(_dwconv(tf, x, w2, b2))
    return _dwconv(tf, x, unit.conv2.weight, unit.conv2.bias)


@torch.no_grad()
def _forward_tf(tf, model: nn.Module, cfg: ModelConfig, x):
    """x: (B, H, W, 3) NHWC float32 raw-BGR. Returns dict of 12 outputs."""
    bb = model.backbone
    m0 = bb.model0
    w, b = fold_conv_bn(m0.conv1.weight, m0.conv1.bias, m0.bn1)
    x = tf.nn.relu(_conv(tf, x, w, b, stride=2, pad=1))
    x = _convdp(tf, x, m0.conv2)

    feats = []
    for i in range(len(cfg.stage_channels)):
        if i > 0:
            m = getattr(bb, f"model{i}")
            x = _convdp(tf, x, m.conv1)
            x = _convdp(tf, x, m.conv2)
        if i in cfg.out_idx:
            feats.append(x)
        if i in cfg.downsample_idx:
            x = tf.nn.max_pool2d(x, 2, 2, "VALID")

    lateral = model.neck.lateral_convs
    for i in range(len(feats) - 1, 0, -1):
        feats[i] = _convdp(tf, feats[i], lateral[i])
        up = tf.repeat(tf.repeat(feats[i], 2, axis=1), 2, axis=2)
        feats[i - 1] = feats[i - 1] + up
    feats[0] = _convdp(tf, feats[0], lateral[0])

    head = model.bbox_head
    outs = {}
    for lvl, f in enumerate(feats):
        if head.multi_level_share_convs is not None:
            for unit in head.multi_level_share_convs[lvl]:
                f = _convdp(tf, f, unit)
        stride = cfg.strides[lvl]
        for key, ch, sig in (("cls", cfg.num_classes, True),
                             ("obj", 1, True), ("bbox", 4, False),
                             ("kps", cfg.kps_num * 2, False)):
            y = _convdp(tf, f, getattr(head, f"multi_level_{key}")[lvl])
            y = tf.reshape(y, (tf.shape(y)[0], -1, ch))
            if sig:
                y = tf.sigmoid(y)
            outs[f"{key}_{stride}"] = y
    return outs


def export_tflite(model: nn.Module, cfg: ModelConfig, *,
                  input_shape: Tuple[int, int] = (256, 320),
                  quantize: str = "none",
                  rep_images=None) -> bytes:
    """Build the .tflite flatbuffer bytes. input_shape is (H, W).

    quantize:
      "none"    — float32 weights/activations (reference parity; the
                  reference's TinyNN path is float-only).
      "dynamic" — dynamic-range PTQ: int8 weights, float activations.
      "fp16"    — float16 weights, float32 compute.
      "int8"    — full-integer PTQ: int8 weights AND activations,
                  calibrated on ``rep_images`` — an iterable of
                  (1, 3, H, W) float32 raw-BGR arrays (>= ~20
                  recommended). I/O stays float32 so the deployment
                  contract is unchanged.
    """
    import tempfile

    import tensorflow as tf

    h, w = input_shape

    @tf.function(input_signature=[
        tf.TensorSpec([1, 3, h, w], tf.float32, name="input")])
    def fwd(inp):
        x = tf.transpose(inp, (0, 2, 3, 1))  # NCHW contract -> NHWC body
        return _forward_tf(tf, model, cfg, x)

    # through a SavedModel, so the TFLite file carries a SignatureDef
    # (from_concrete_functions drops it, leaving nameless tensor I/O)
    module = tf.Module()
    module.fwd = fwd
    with tempfile.TemporaryDirectory() as d:
        tf.saved_model.save(module, d,
                            signatures=fwd.get_concrete_function())
        converter = tf.lite.TFLiteConverter.from_saved_model(d)
        if quantize == "dynamic":
            converter.optimizations = [tf.lite.Optimize.DEFAULT]
        elif quantize == "fp16":
            converter.optimizations = [tf.lite.Optimize.DEFAULT]
            converter.target_spec.supported_types = [tf.float16]
        elif quantize == "int8":
            if rep_images is None:
                raise ValueError("int8 quantization needs rep_images")

            def _rep():
                for img in rep_images:
                    yield [np.asarray(img, np.float32).reshape(1, 3, h, w)]

            converter.optimizations = [tf.lite.Optimize.DEFAULT]
            converter.representative_dataset = _rep
        elif quantize != "none":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        return converter.convert()


def run_tflite(blob: bytes, x: np.ndarray) -> dict:
    """Execute a .tflite blob on (1, 3, H, W) float32 input; returns the
    named output dict via the signature runner."""
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_content=blob)
    runner = interp.get_signature_runner()
    out = runner(input=np.asarray(x, np.float32))
    return {k: np.asarray(v) for k, v in out.items()}
