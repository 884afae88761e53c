"""Cross-engine inference harness: per-stage timing, multi-family numpy
decoders, and WIDER-protocol AP evaluation — counterpart of
``tools/compare_inference.py``, with the same options and printed lines.

Engines:
  torch:<config>:<checkpoint>  the port's Detector (bf16, device decode
                               and device NMS) on ``device``
  onnx:<path>                  YuNet-contract ONNX through onnxruntime when
                               it is installed, else the port's torch ONNX
                               executor on ``device``
  scrfd:<path>                 SCRFD ONNX (distance2bbox/kps decode)
  retinaface:<path>            RetinaFace ONNX (prior-box + variances)
  yolo5face:<path>             YOLO5Face ONNX (xywh + landmark rows)
  tflite:<path>                YuNet-contract .tflite (yunet2tflite's file)
                               through tf.lite.Interpreter

The torch executor covers the YuNet contract only, so scrfd:, retinaface:
and yolo5face: need onnxruntime and fail without it. tflite: needs
TensorFlow. Neither is on the card host; onnx: and torch: run there.

Modes follow the reference's resize_img: "W,H" letterbox, "VGA",
"ORIGIN", "AUTO" (pad to /32).

  # FPS table on one image (.npy HWC uint8 BGR, or any cv2 format)
  python -m yunet_tpu_torch.tools.compare_inference \\
      --models torch:yunet_n:w.npz onnx:yunet_n_640.onnx --image img.npy
  # AP-level export-drift gate: the full WIDER protocol through an engine
  python -m yunet_tpu_torch.tools.compare_inference --models onnx:m.onnx \\
      --eval --ann labelv2.txt --cache-dir val_cache --gt-dir gt --mode AUTO

Every stage a timer closes ends in a host readback (the engines return
numpy arrays), so the stage times and the FPS include the card's work.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from .. import native
from ..ops.resize import resize


class Timer:
    def __init__(self):
        self.total = 0.0
        self.n = 0

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.total += time.perf_counter() - self._t
        self.n += 1

    @property
    def fps(self):
        return self.n / self.total if self.total else 0.0

    @property
    def avg(self):
        return self.total / self.n if self.n else 0.0


class TimeEngine:
    """Named per-stage timers: preprocess / forward_run / forward_calc /
    postprocess."""

    def __init__(self):
        self.timers = {}

    def __call__(self, key) -> Timer:
        return self.timers.setdefault(key, Timer())

    def total_second(self):
        return sum(t.total for t in self.timers.values())

    def report(self, epochs):
        lines = []
        for k, t in self.timers.items():
            lines.append(f"  {k:<14} {t.total / max(epochs, 1):.5f} s")
        tot = self.total_second() / max(epochs, 1)
        lines.append(f"  {'total':<14} {tot:.5f} s "
                     f"(FPS {1.0 / tot if tot else 0.0:.1f})")
        return "\n".join(lines)

    def reset(self):
        self.timers = {}


def resize_img(img, mode):
    """The reference's preprocessing modes; ``ops/resize.py:resize`` gives
    cv2.resize's bytes on uint8."""
    if mode == "ORIGIN":
        return img, 1.0
    if mode == "AUTO":
        ah = ((img.shape[0] - 1) & (-32)) + 32
        aw = ((img.shape[1] - 1) & (-32)) + 32
        out = np.zeros((ah, aw, 3), np.uint8)
        out[:img.shape[0], :img.shape[1]] = img
        return out, 1.0
    size = (640, 480) if mode == "VGA" else tuple(
        int(v) for v in mode.split(","))
    if len(size) != 2:
        raise ValueError(f"bad mode {mode!r}: want 'W,H'")
    x, y = max(size), min(size)
    size = (x, y) if img.shape[1] > img.shape[0] else (y, x)
    im_ratio = img.shape[0] / img.shape[1]
    model_ratio = size[1] / size[0]
    if im_ratio > model_ratio:
        nh, nw = size[1], int(size[1] / im_ratio)
    else:
        nw, nh = size[0], int(size[0] * im_ratio)
    scale = nh / img.shape[0]
    out = np.zeros((size[1], size[0], 3), np.uint8)
    if (nh, nw) == img.shape[:2]:
        out[:nh, :nw] = img
    else:
        # np.require copies a read-only (memory-mapped) image that
        # torch.from_numpy would warn about; resize never writes it
        out[:nh, :nw] = resize(torch.from_numpy(np.require(
            img, requirements=["C", "W"])), (nw, nh)).numpy()
    return out, scale


def _nms(dets, thr):
    if len(dets) == 0:
        return np.zeros((0,), np.int64)
    return native.nms(dets[:, :4], dets[:, 4], thr)


# ---------------------------------------------------------------------------
# numpy decoders — one per model family, each an independent re-expression
# of that family's output contract
# ---------------------------------------------------------------------------

def numpy_decode_yunet(outputs, input_hw, score_thr=0.02, nms_thr=0.45):
    """12-output YuNet ONNX contract ({cls,obj,bbox,kps}_{8,16,32},
    sigmoid already applied in-graph)."""
    h, w = input_hw
    dets_all, kps_all = [], []
    for stride in (8, 16, 32):
        cls = outputs[f"cls_{stride}"][0]     # (HW, 1)
        obj = outputs[f"obj_{stride}"][0]     # (HW, 1)
        bbox = outputs[f"bbox_{stride}"][0]   # (HW, 4)
        kps = outputs[f"kps_{stride}"][0]     # (HW, 10)
        fh, fw = h // stride, w // stride
        gx, gy = np.meshgrid(np.arange(fw), np.arange(fh))
        px = (gx.reshape(-1) * stride).astype(np.float32)
        py = (gy.reshape(-1) * stride).astype(np.float32)
        score = cls[:, 0] * obj[:, 0]
        cx = bbox[:, 0] * stride + px
        cy = bbox[:, 1] * stride + py
        bw = np.exp(bbox[:, 2]) * stride
        bh = np.exp(bbox[:, 3]) * stride
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                          cy + bh / 2], -1)
        kp = kps.reshape(-1, 5, 2) * stride + np.stack([px, py],
                                                       -1)[:, None, :]
        keepm = score >= score_thr
        dets_all.append(np.concatenate(
            [boxes[keepm], score[keepm, None]], -1))
        kps_all.append(kp[keepm].reshape(-1, 10))
    dets = np.concatenate(dets_all, 0)
    kps = np.concatenate(kps_all, 0)
    keep = native.nms(dets[:, :4], dets[:, 4], nms_thr)
    return dets[keep], kps[keep]


def distance2bbox(points, distance):
    """ltrb distances from an anchor point -> xyxy (SCRFD contract)."""
    return np.stack([points[:, 0] - distance[:, 0],
                     points[:, 1] - distance[:, 1],
                     points[:, 0] + distance[:, 2],
                     points[:, 1] + distance[:, 3]], -1)


def distance2kps(points, distance):
    """per-landmark xy offsets from an anchor point (SCRFD contract)."""
    out = np.empty_like(distance)
    out[:, 0::2] = points[:, 0:1] + distance[:, 0::2]
    out[:, 1::2] = points[:, 1:2] + distance[:, 1::2]
    return out


def numpy_decode_scrfd(outs, input_hw, score_thr=0.02, nms_thr=0.45,
                       strides=(8, 16, 32), num_anchors=2, use_kps=True):
    """SCRFD head: per-stride [score, bbox(ltrb*stride), kps] lists with
    ``num_anchors`` anchors per cell. ``outs`` is the ordered output list
    [scores*3, bboxes*3, kps*3]."""
    h, w = input_hw
    fmc = len(strides)
    dets_all, kps_all = [], []
    for i, stride in enumerate(strides):
        scores = np.asarray(outs[i]).reshape(-1)
        bbox = np.asarray(outs[i + fmc]).reshape(-1, 4) * stride
        fh, fw = h // stride, w // stride
        gx, gy = np.meshgrid(np.arange(fw), np.arange(fh))
        centers = np.stack([gx.reshape(-1), gy.reshape(-1)],
                           -1).astype(np.float32) * stride
        if num_anchors > 1:
            centers = np.repeat(centers, num_anchors, axis=0)
        keepm = scores >= score_thr
        boxes = distance2bbox(centers, bbox)
        dets_all.append(np.concatenate(
            [boxes[keepm], scores[keepm, None]], -1))
        if use_kps:
            kp = np.asarray(outs[i + 2 * fmc]).reshape(
                -1, 10) * stride
            kps_all.append(distance2kps(centers, kp)[keepm])
    dets = np.concatenate(dets_all, 0)
    kps = (np.concatenate(kps_all, 0) if kps_all
           else np.zeros((len(dets), 10), np.float32))
    keep = _nms(dets, nms_thr)
    return dets[keep], kps[keep]


def retinaface_priors(input_hw, min_sizes=((16, 32), (64, 128), (256, 512)),
                      steps=(8, 16, 32)):
    """Normalized [cx, cy, sw, sh] prior boxes."""
    h, w = input_hw
    priors = []
    for k, step in enumerate(steps):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i in range(fh):
            for j in range(fw):
                for m in min_sizes[k]:
                    priors.append([(j + 0.5) * step / w,
                                   (i + 0.5) * step / h,
                                   m / w, m / h])
    return np.asarray(priors, np.float32)


def numpy_decode_retinaface(outs, input_hw, score_thr=0.02, nms_thr=0.45,
                            variances=(0.1, 0.2)):
    """RetinaFace: (loc, conf, landms) against prior boxes with SSD
    variances. ``outs`` = [loc, conf, landms], each (1, N, ·)."""
    h, w = input_hw
    loc = np.asarray(outs[0])[0]
    conf = np.asarray(outs[1])[0]
    landms = np.asarray(outs[2])[0]
    priors = retinaface_priors(input_hw)
    cxy = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    boxes *= np.asarray([w, h, w, h], np.float32)
    kp = np.concatenate(
        [priors[:, :2] + landms[:, 2 * i:2 * i + 2] * variances[0]
         * priors[:, 2:] for i in range(5)], -1)
    kp *= np.tile(np.asarray([w, h], np.float32), 5)
    scores = conf[:, 1]
    keepm = scores >= score_thr
    dets = np.concatenate([boxes[keepm], scores[keepm, None]], -1)
    kp = kp[keepm]
    keep = _nms(dets, nms_thr)
    return dets[keep], kp[keep]


def numpy_decode_yolo5face(out, score_thr=0.02, nms_thr=0.45):
    """YOLO5Face: one (1, N, 16) tensor of [cx cy w h obj kp*10 cls]
    rows; conf = obj * cls."""
    rows = np.asarray(out)[0]
    obj = rows[:, 4]
    m = obj >= score_thr
    rows = rows[m]
    conf = rows[:, 4] * rows[:, 15]
    m2 = conf >= score_thr
    rows, conf = rows[m2], conf[m2]
    cx, cy, w, h = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    dets = np.concatenate([boxes, conf[:, None]], -1)
    kps = rows[:, 5:15]
    keep = _nms(dets, nms_thr)
    return dets[keep], kps[keep]


def blob_from_image(img, scale, mean, swap_rb=True):
    """``cv2.dnn.blobFromImage(img, scale, (w, h), mean, swapRB)`` at the
    image's own size: (1, 3, H, W) float32 of (img - mean) * scale, the
    channels reversed first with swap_rb."""
    x = img[..., ::-1] if swap_rb else img
    x = (x.astype(np.float32) - np.asarray(mean, np.float32)) \
        * np.float32(scale)
    return np.ascontiguousarray(np.transpose(x, (2, 0, 1))[None])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

class BaseEngine:
    """detect(img) -> (dets (n,5) xyxy+score, kps (n,10)); stages timed
    into ``self.times``."""

    def __init__(self):
        self.times = TimeEngine()

    def detect(self, img_bgr, mode="320,320"):
        raise NotImplementedError


class _OnnxRunner:
    """onnxruntime if installed, else the port's torch ONNX executor on
    ``device``. The executor runs the YuNet contract only, so an engine of
    another family (yunet_contract=False) without onnxruntime raises."""

    def __init__(self, path, *, device, yunet_contract=True):
        self.ort = None
        try:
            import onnxruntime as ort
        except ImportError:
            if not yunet_contract:
                raise SystemExit(
                    f"{path}: this engine needs onnxruntime, which is not "
                    "installed; the torch ONNX executor runs YuNet-contract "
                    "files only (onnx:)")
            from ..export.onnx_runtime import OnnxExecutor
            self.executor = OnnxExecutor(path, device=device)
            self.shape = self.executor.input_shape
        else:
            self.ort = ort.InferenceSession(path)
            self.input_name = self.ort.get_inputs()[0].name
            self.shape = self.ort.get_inputs()[0].shape

    def run(self, x):
        if self.ort is not None:
            names = [o.name for o in self.ort.get_outputs()]
            return dict(zip(names, self.ort.run(None,
                                                {self.input_name: x})))
        return self.executor(x)       # numpy out: a host readback


class OnnxEngine(BaseEngine):
    def __init__(self, path, score_thr=0.02, nms_thr=0.45, *, device):
        super().__init__()
        self.sess = _OnnxRunner(path, device=device)
        s = self.sess.shape
        self.hw = (s[2], s[3]) if isinstance(s[2], int) else None
        self.score_thr = score_thr
        self.nms_thr = nms_thr

    def detect(self, img_bgr, mode=None):
        with self.times("preprocess"):
            if self.hw is not None:       # static input: letterbox to it
                h, w = self.hw
                det_img, s = resize_img(img_bgr, f"{w},{h}")
            else:
                det_img, s = resize_img(img_bgr, mode or "AUTO")
            sx = sy = s
            h, w = det_img.shape[:2]
            x = np.transpose(det_img.astype(np.float32), (2, 0, 1))[None]
        with self.times("forward_run"):
            outs = self.sess.run(x)
        with self.times("postprocess"):
            dets, kps = numpy_decode_yunet(outs, (h, w), self.score_thr,
                                           self.nms_thr)
            dets[:, 0:4:2] /= sx
            dets[:, 1:4:2] /= sy
            kps[:, 0::2] /= sx
            kps[:, 1::2] /= sy
        return dets, kps


class TfliteEngine(BaseEngine):
    """The exported .tflite file (export/tflite_export.py): NCHW float32
    input, the twelve named (B,HW,C) YuNet-contract outputs with sigmoid
    baked in, decoded through the same numpy path as the ONNX engine, so a
    ``--eval`` run is an AP-level drift gate for the TFLite export too.
    Needs TensorFlow (imported here); the interpreter runs on the host."""

    def __init__(self, path, score_thr=0.02, nms_thr=0.45, *, device=None):
        super().__init__()
        import tensorflow as tf
        self.interp = tf.lite.Interpreter(model_path=path)
        self.runner = self.interp.get_signature_runner()
        s = self.interp.get_input_details()[0]["shape"]   # (1, 3, H, W)
        self.hw = (int(s[2]), int(s[3]))
        self.score_thr = score_thr
        self.nms_thr = nms_thr

    def detect(self, img_bgr, mode=None):
        with self.times("preprocess"):
            h, w = self.hw
            det_img, s = resize_img(img_bgr, f"{w},{h}")
            x = np.transpose(det_img.astype(np.float32), (2, 0, 1))[None]
        with self.times("forward_run"):
            outs = self.runner(input=x)
        with self.times("postprocess"):
            dets, kps = numpy_decode_yunet(outs, (h, w), self.score_thr,
                                           self.nms_thr)
            dets[:, 0:4:2] /= s
            dets[:, 1:4:2] /= s
            kps[:, 0::2] /= s
            kps[:, 1::2] /= s
        return dets, kps


class TorchEngine(BaseEngine):
    """The port's Detector in bf16: ``detect(..., pad_divisor=32,
    use_device_nms=True)``, so the NMS kernel runs on every detect; the
    result comes back as numpy (one readback)."""

    def __init__(self, config, ckpt, score_thr=None, *, device):
        super().__init__()
        import dataclasses

        from ..apis import read_weights
        from ..config import get_config
        from ..eval.detect import Detector
        cfg = get_config(config)
        if score_thr:
            cfg = dataclasses.replace(cfg, test=dataclasses.replace(
                cfg.test, score_thr=score_thr))
        self.cfg = cfg
        self.det = Detector(cfg, read_weights(cfg, ckpt), device=device)

    def _mode(self, mode):
        if mode is None:
            return (320, 320)
        if mode in ("ORIGIN", "AUTO"):
            return "ORIGIN"
        if mode == "VGA":
            return (640, 480)
        w, h = (int(v) for v in mode.split(","))
        return (h, w)

    def detect(self, img_bgr, mode="320,320"):
        with self.times("forward_run"):
            r = self.det.detect(img_bgr, mode=self._mode(mode),
                                pad_divisor=32, use_device_nms=True)
        bb = r["bboxes"]
        kps = r.get("kps")
        if kps is None:
            kps = np.zeros((len(bb), 10), np.float32)
        return bb, kps.reshape(len(bb), -1)


class ScrfdEngine(BaseEngine):
    def __init__(self, path, score_thr=0.02, nms_thr=0.45, *, device):
        super().__init__()
        self.sess = _OnnxRunner(path, device=device, yunet_contract=False)
        self.score_thr = score_thr
        self.nms_thr = nms_thr

    def detect(self, img_bgr, mode="640,640"):
        with self.times("preprocess"):
            det_img, scale = resize_img(img_bgr, mode or "AUTO")
            h, w = det_img.shape[:2]
            x = blob_from_image(det_img, 1.0 / 128, (127.5, 127.5, 127.5))
        with self.times("forward_run"):
            outs = self.sess.run(x)
            outs = list(outs.values()) if isinstance(outs, dict) else outs
        with self.times("postprocess"):
            dets, kps = numpy_decode_scrfd(outs, (h, w), self.score_thr,
                                           self.nms_thr)
            dets[:, :4] /= scale
            kps /= scale
        return dets, kps


class RetinaFaceEngine(BaseEngine):
    def __init__(self, path, score_thr=0.02, nms_thr=0.45, *, device):
        super().__init__()
        self.sess = _OnnxRunner(path, device=device, yunet_contract=False)
        self.score_thr = score_thr
        self.nms_thr = nms_thr

    def detect(self, img_bgr, mode="640,640"):
        with self.times("preprocess"):
            det_img, scale = resize_img(img_bgr, mode or "AUTO")
            h, w = det_img.shape[:2]
            x = det_img.astype(np.float32) - (104, 117, 123)
            x = np.transpose(x, (2, 0, 1))[None]
        with self.times("forward_run"):
            outs = self.sess.run(x)
            outs = list(outs.values()) if isinstance(outs, dict) else outs
        with self.times("postprocess"):
            dets, kps = numpy_decode_retinaface(
                outs, (h, w), self.score_thr, self.nms_thr)
            dets[:, :4] /= scale
            kps /= scale
        return dets, kps


class Yolo5FaceEngine(BaseEngine):
    def __init__(self, path, score_thr=0.02, nms_thr=0.45, *, device):
        super().__init__()
        self.sess = _OnnxRunner(path, device=device, yunet_contract=False)
        self.score_thr = score_thr
        self.nms_thr = nms_thr

    def detect(self, img_bgr, mode="640,640"):
        with self.times("preprocess"):
            det_img, scale = resize_img(img_bgr, mode or "AUTO")
            x = det_img[..., ::-1]                       # BGR -> RGB
            x = np.transpose(x, (2, 0, 1))[None].astype(np.float32) / 255.0
        with self.times("forward_run"):
            outs = self.sess.run(x)
            outs = list(outs.values()) if isinstance(outs, dict) else outs
        with self.times("postprocess"):
            dets, kps = numpy_decode_yolo5face(outs[0], self.score_thr,
                                               self.nms_thr)
            dets[:, :4] /= scale
            kps /= scale
        return dets, kps


def build_engine(spec, score_thr=0.02, nms_thr=0.45, *, device):
    kind, _, rest = spec.partition(":")
    if kind == "torch":
        config, _, ckpt = rest.partition(":")
        return TorchEngine(config, ckpt, score_thr=score_thr, device=device)
    if kind == "jax":
        raise SystemExit(f"{spec}: this harness runs the port; use "
                         "torch:<config>:<checkpoint>")
    cls = {"onnx": OnnxEngine, "scrfd": ScrfdEngine,
           "retinaface": RetinaFaceEngine,
           "yolo5face": Yolo5FaceEngine,
           "tflite": TfliteEngine}.get(kind)
    if cls is None:
        raise SystemExit(f"unknown engine spec {spec}")
    return cls(rest, score_thr=score_thr, nms_thr=nms_thr, device=device)


# ---------------------------------------------------------------------------
# harness modes
# ---------------------------------------------------------------------------

def _image_loader(args):
    """rec -> HWC uint8 BGR: from the decoded .npy cache with
    ``args.cache_dir``, else cv2.imread under ``args.img_prefix``."""
    cache_dir = getattr(args, "cache_dir", None)
    if cache_dir is not None:
        from ..data.cache import load_cached

        def load(rec):
            img = load_cached(cache_dir, rec.filename)
            if img is None:
                raise SystemExit(f"missing image {rec.filename}")
            return img
        return load
    import cv2

    def load(rec):
        img = cv2.imread(os.path.join(args.img_prefix, rec.filename))
        if img is None:
            raise SystemExit(f"missing image {rec.filename}")
        return img
    return load


def run_eval(engine, spec, args):
    """The full WIDER protocol through an engine — the AP-level
    export-drift gate."""
    from ..data import parse_labelv2
    from ..eval import wider_evaluation

    records = parse_labelv2(args.ann, test_mode=True)
    if args.limit:
        records = records[:args.limit]
    load = _image_loader(args)
    results = {}
    t0 = time.time()
    for i, rec in enumerate(records):
        img = load(rec)
        dets, _ = engine.detect(img, mode=args.mode)
        xywh = np.concatenate(
            [dets[:, :2], dets[:, 2:4] - dets[:, :2], dets[:, 4:5]], 1)
        event, name = rec.filename.split("/")
        results.setdefault(event, {})[name[:-4]] = xywh.astype(np.float64)
        if (i + 1) % 200 == 0:
            print(f"{i + 1}/{len(records)} images, "
                  f"{(i + 1) / (time.time() - t0):.1f} img/s")
    print(f"eval {spec} in {len(records)} images:")
    print(engine.times.report(len(records)))
    aps = wider_evaluation(results, args.gt_dir)
    print(f"AP easy/medium/hard: {aps[0]:.4f} {aps[1]:.4f} {aps[2]:.4f}")
    return aps


def run_bench(engine, spec, args, img):
    dets, _ = engine.detect(img, mode=args.mode)    # warmup / build
    engine.times.reset()
    t = Timer()
    for _ in range(args.iters):
        with t:
            dets, _ = engine.detect(img, mode=args.mode)
    print(f"{spec:<60} {len(dets):>6} {t.fps:>9.1f}")
    print(engine.times.report(args.iters))
    return t.fps


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Cross-engine inference "
                                "harness: FPS per stage, or WIDER AP")
    p.add_argument("--models", nargs="+", required=True)
    p.add_argument("--image", default=None,
                   help=".npy (HWC uint8 BGR) or an image file (cv2)")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--mode", default=None,
                   help='"W,H" | VGA | ORIGIN | AUTO (default: engine '
                   "native / 320,320)")
    p.add_argument("--score-thr", type=float, default=0.02)
    p.add_argument("--nms-thr", type=float, default=0.45)
    p.add_argument("--eval", action="store_true",
                   help="run the WIDER protocol + AP instead of FPS")
    p.add_argument("--ann", default=None)
    p.add_argument("--img-prefix", default=None)
    p.add_argument("--gt-dir", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--cache-dir", default=None,
                   help="read --eval images from this decoded .npy cache "
                   "(data/cache.py layout) instead of decoding the JPEGs")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """--eval: {spec: [easy, medium, hard]}; else {spec: FPS}.
    ``device``: where the torch engine and the torch ONNX executor run
    (the tests pass the CPU)."""
    from .detect_image import read_image

    args = parse_args(argv)
    if args.eval:
        if not (args.ann and (args.img_prefix or args.cache_dir)
                and args.gt_dir):
            raise SystemExit("--eval needs --ann, --img-prefix or "
                             "--cache-dir, and --gt-dir")
        out = {}
        for spec in args.models:
            eng = build_engine(spec, args.score_thr, args.nms_thr,
                               device=device)
            out[spec] = run_eval(eng, spec, args)
        return out

    if args.image is None:
        raise SystemExit("--image required without --eval")
    img = read_image(args.image)
    print(f"{'model':<60} {'faces':>6} {'FPS':>9}")
    fps = {}
    for spec in args.models:
        eng = build_engine(spec, args.score_thr, args.nms_thr,
                           device=device)
        fps[spec] = run_bench(eng, spec, args, img)
    return fps


if __name__ == "__main__":
    main()
