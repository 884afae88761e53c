"""Inference pipeline: preprocess -> forward -> score/decode -> NMS ->
rescale — counterpart of ``yunet_tpu/eval/detect.py:33-470``.

  * ``resize_img`` modes ORIGIN / AUTO (zero-pad H, W up to a multiple of
    32) and fixed "W,H" canvases with an aspect-preserving resize; cv2 is
    imported only when an image really has to be resized;
  * score fusion sigmoid(cls)*sigmoid(obj) and decode in f32 on the device;
  * NMS either exact on the host (``native.nms``, uncapped — the AP-parity
    path and the default) or on the device (``ops/nms.py``: a top-k cap
    and one packed readback).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..models.detector import YuNet
from ..models.fused import fold_inference_params, fused_forward
from ..models.head import flatten_level_outputs
from ..ops.boxes import bbox_decode, fuse_score, kps_decode
from ..ops.nms import device_nms, device_nms_batched
from ..ops.priors import grid_priors
from .. import native


def canvas_shape(h: int, w: int, mode: Union[str, Tuple[int, int]],
                 divisor: int = 32) -> Tuple[int, int]:
    """(H, W) of the canvas resize_img produces for an (h, w) image:
    images whose canvas_shape matches can share one detect_batch call."""
    if mode in ("ORIGIN", "AUTO"):
        return (-(-h // divisor) * divisor, -(-w // divisor) * divisor)
    if mode == "VGA":
        input_size = (640, 480)
    elif isinstance(mode, str):
        input_size = tuple(int(v) for v in mode.split(","))
    else:
        input_size = tuple(mode)
    x, y = max(input_size), min(input_size)
    # landscape fills the long side; portrait (and square) the short
    return (y, x) if w > h else (x, y)


def resize_img(img: np.ndarray, mode: Union[str, Tuple[int, int]],
               divisor: int = 32) -> Tuple[np.ndarray, float]:
    """Reference tools/detect_image.py:99-132 preprocessing modes. Returns
    (canvas image, det_scale)."""
    if mode in ("ORIGIN", "AUTO"):
        h, w = canvas_shape(img.shape[0], img.shape[1], mode, divisor)
        if (h, w) != img.shape[:2]:
            padded = np.zeros((h, w, 3), dtype=img.dtype)
            padded[:img.shape[0], :img.shape[1]] = img
            img = padded
        return img, 1.0
    ch, cw = canvas_shape(img.shape[0], img.shape[1], mode, divisor)
    input_size = (cw, ch)                    # (W, H)
    im_ratio = img.shape[0] / img.shape[1]
    model_ratio = input_size[1] / input_size[0]
    if im_ratio > model_ratio:
        new_h = input_size[1]
        new_w = int(new_h / im_ratio)
    else:
        new_w = input_size[0]
        new_h = int(new_w * im_ratio)
    det_scale = new_h / img.shape[0]
    if (new_h, new_w) == img.shape[:2]:
        resized = img       # cv2.resize to the same size is the identity
    else:
        import cv2
        resized = cv2.resize(img, (new_w, new_h))
    det_img = np.zeros((input_size[1], input_size[0], 3), dtype=img.dtype)
    det_img[:new_h, :new_w] = resized
    return det_img, det_scale


def _result(sel: np.ndarray, kps_sel: np.ndarray,
            det_scale: float) -> Dict[str, np.ndarray]:
    """(n, 5) detections and (n, 2K) keypoints on the canvas -> the result
    dict in original image coordinates."""
    sel = sel.astype(np.float32)          # a copy: scaled in place below
    kps_sel = kps_sel.astype(np.float32)
    if det_scale != 1.0:
        sel[:, :4] /= det_scale
        kps_sel /= det_scale
    return {"bboxes": sel, "kps": kps_sel,
            "labels": np.zeros((sel.shape[0],), np.int64)}


class Detector:
    """Inference wrapper around a YuNet on one device.

    dtype: torch.bfloat16 runs the conv trunk in bf16 (inputs shipped as
    uint8 and cast on the device), torch.float32 in f32. Score, decode and
    NMS are f32 either way.

    fused: fold BN into the depthwise convs. ``detect`` then runs every
    ConvDPUnit through the fused kernel (fastest at batch 1 on the TPU);
    ``detect_batch`` runs the folded units through the library convs, as
    the JAX serving program does.
    """

    def __init__(self, cfg: Config, model_or_state, *, device,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be bf16 or f32, not {dtype}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        if isinstance(model_or_state, YuNet):
            model = model_or_state.to(self.device)
        else:
            model = YuNet(cfg.model, device=self.device)
            model.load_state_dict(model_or_state)
        self.model = model.eval()
        self.folded = (fold_inference_params(model, cfg.model)
                       if fused else None)
        self._priors: Dict[Tuple[int, int], torch.Tensor] = {}
        # images whose device-NMS pre-NMS cap was saturated in the last
        # detect_batch(use_device_nms=True) call
        self.last_devnms_saturated = 0

    # -- device programs ---------------------------------------------------
    def priors(self, h: int, w: int) -> torch.Tensor:
        if (h, w) not in self._priors:
            self._priors[(h, w)] = torch.from_numpy(grid_priors(
                self.model.featmap_sizes(h, w), self.cfg.model.strides,
                self.cfg.model.prior_offset)).to(self.device)
        return self._priors[(h, w)]

    @torch.inference_mode()
    def raw(self, x: torch.Tensor, *, conv_kernel: bool):
        """x: (B, H, W, 3) uint8 or float raw BGR on the device ->
        scores (B, P), boxes (B, P, 4), kps (B, P, 2K), all f32.
        conv_kernel: run a fused detector's units through the kernel."""
        xc = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.folded is not None:
            flat = flatten_level_outputs(fused_forward(
                self.folded, xc, self.cfg.model, use_kernel=conv_kernel))
        else:
            flat = self.model.forward_flat(xc)
        priors = self.priors(x.shape[1], x.shape[2])
        scores = fuse_score(flat["cls"][..., 0].float(),
                            flat["obj"][..., 0].float())
        boxes = bbox_decode(priors, flat["bbox"].float())
        kps = kps_decode(priors, flat["kps"].float())
        return scores, boxes, kps

    @torch.inference_mode()
    def detect_packed(self, x: torch.Tensor, top_k: int) -> torch.Tensor:
        """Batch-1 program with device NMS: x (1, H, W, 3) -> packed
        (K, 6 + 2K) rows [x1 y1 x2 y2 score keep kps...]
        (yunet_tpu/eval/detect.py:162-185)."""
        scores, boxes, kps = self.raw(x, conv_kernel=True)
        dets, keep, idx = device_nms(
            boxes[0], scores[0], top_k=top_k,
            iou_thr=self.cfg.test.nms_iou_thr,
            score_thr=self.cfg.test.score_thr)
        return torch.cat([dets, keep[:, None].to(dets.dtype),
                          kps[0][idx]], dim=-1)

    @torch.inference_mode()
    def serve_packed(self, x: torch.Tensor, top_k: int) -> torch.Tensor:
        """The batched serving program (the JAX one is bench.py:90-131):
        x (B, H, W, 3) -> packed (B, K, 7 + 2K) rows [x1 y1 x2 y2 score
        keep kps... n_above], n_above being the image's candidate count
        above the score threshold (yunet_tpu/eval/detect.py:376-391)."""
        scores, boxes, kps = self.raw(x, conv_kernel=False)
        dets, keep, idx = device_nms_batched(
            boxes, scores, top_k=top_k, iou_thr=self.cfg.test.nms_iou_thr,
            score_thr=self.cfg.test.score_thr)
        n_above = (scores >= self.cfg.test.score_thr).sum(
            1, dtype=torch.float32)
        meta = n_above[:, None, None].expand(*keep.shape, 1)
        kps_sel = torch.gather(kps, 1, idx[..., None].expand(
            *idx.shape, kps.shape[-1]))
        return torch.cat([dets, keep[..., None].to(dets.dtype), kps_sel,
                          meta], dim=-1)

    def _input(self, imgs) -> torch.Tensor:
        """Stacked canvases -> device tensor: uint8 when the trunk is bf16
        (4x less host->device traffic, cast on the device), f32 else."""
        x = np.stack(imgs)
        if not (self.dtype == torch.bfloat16 and x.dtype == np.uint8):
            x = x.astype(np.float32)
        return torch.from_numpy(x).to(self.device)

    def _check_thr(self, score_thr: float) -> None:
        if score_thr < self.cfg.test.score_thr:
            raise ValueError(
                "device-NMS path cannot lower score_thr below "
                f"cfg.test.score_thr={self.cfg.test.score_thr}; "
                "rebuild the Detector with a lower config threshold")

    # -- public API ----------------------------------------------------------
    def detect(self, img_bgr: np.ndarray,
               mode: Union[str, Tuple[int, int]] = "AUTO", *,
               score_thr: Optional[float] = None,
               use_device_nms: bool = False,
               max_dets: Optional[int] = None,
               pad_divisor: int = 32,
               timings: Optional[dict] = None) -> Dict[str, np.ndarray]:
        """Detect faces in one BGR image.

        Returns dict: bboxes (n, 5) [x1 y1 x2 y2 score] in original image
        coords (score-desc), kps (n, 2K), labels (n,).

        timings: pass a dict to receive the per-call latency budget in
        seconds — {preproc, put, device, post}; ``device`` ends with the
        result on the host.
        """
        t = time.perf_counter
        t0 = t()
        score_thr = (self.cfg.test.score_thr if score_thr is None
                     else score_thr)
        det_img, det_scale = resize_img(img_bgr, mode, pad_divisor)
        t1 = t()
        x = self._input([det_img])
        t2 = t()
        if use_device_nms:
            self._check_thr(score_thr)
            top_k = max_dets or self.cfg.test.device_nms_pre
            packed = self.detect_packed(x, top_k).cpu().numpy()
            sel, kps_sel = _kept_rows(packed, score_thr)
        else:
            scores, boxes, kps = (a[0].cpu().numpy() for a in
                                  self.raw(x, conv_kernel=True))
            sel, kps_sel = self._host_nms(scores, boxes, kps, score_thr,
                                          max_dets)
        t3 = t()
        out = _result(sel, kps_sel, det_scale)
        if timings is not None:
            timings.update(preproc=t1 - t0, put=t2 - t1, device=t3 - t2,
                           post=t() - t3)
        return out

    def detect_batch(self, imgs_bgr, mode: Union[str, Tuple[int, int]], *,
                     score_thr: Optional[float] = None,
                     pad_divisor: int = 32,
                     use_device_nms: bool = False,
                     device_nms_top_k: int = 750):
        """Batched detection on one shared canvas: every image is
        letterboxed (tuple modes) or zero-padded (ORIGIN/AUTO) onto the
        SAME canvas shape and run as one batch.

        use_device_nms=True runs the whole-batch device NMS and reads back
        only the packed top-``device_nms_top_k`` rows per image. Same keep
        set as the host path for images with at most device_nms_top_k
        candidates above cfg.test.score_thr; ``last_devnms_saturated``
        counts the images above that cap. A higher per-call score_thr is
        an exact post-filter, a lower one raises."""
        score_thr = (self.cfg.test.score_thr if score_thr is None
                     else score_thr)
        views, scales = [], []
        for img in imgs_bgr:
            det_img, det_scale = resize_img(img, mode, pad_divisor)
            views.append(det_img)
            scales.append(det_scale)
        if not views:
            return []
        shapes = {v.shape for v in views}
        if len(shapes) != 1:
            raise ValueError(
                f"detect_batch needs one canvas shape, got {shapes}; "
                "group landscape/portrait images separately for "
                "non-square modes, or by padded-bucket shape for "
                "ORIGIN/AUTO")
        x = self._input(views)
        if use_device_nms:
            self._check_thr(score_thr)
            packed = self.serve_packed(x, device_nms_top_k).cpu().numpy()
            self.last_devnms_saturated = int(
                (packed[:, 0, -1] > packed.shape[1]).sum())
            return [_result(*_kept_rows(packed[i, :, :-1], score_thr), sc)
                    for i, sc in enumerate(scales)]
        scores, boxes, kps = (a.cpu().numpy()
                              for a in self.raw(x, conv_kernel=False))
        return [_result(*self._host_nms(scores[i], boxes[i], kps[i],
                                        score_thr), sc)
                for i, sc in enumerate(scales)]

    def _host_nms(self, scores, boxes, kps, score_thr, max_dets=None):
        """Exact, uncapped host NMS on one image's raw outputs ->
        (detections (n, 5), keypoints (n, 2K))."""
        valid = scores >= score_thr
        bv, sv, kv = boxes[valid], scores[valid], kps[valid]
        keep = native.nms(bv, sv, self.cfg.test.nms_iou_thr)
        if max_dets is not None and max_dets > 0:
            keep = keep[:max_dets]
        return np.concatenate([bv[keep], sv[keep, None]], axis=-1), kv[keep]


def _kept_rows(packed: np.ndarray, score_thr: float):
    """Packed device-NMS rows [x1 y1 x2 y2 score keep kps...] of one image
    -> the kept (detections, keypoints). The device program bakes in
    cfg.test.score_thr; a higher per-call threshold is exact as a post-NMS
    filter (below-threshold boxes only suppress each other)."""
    keep = (packed[:, 5] > 0.5) & (packed[:, 4] >= score_thr)
    return packed[keep, :5], packed[keep, 6:]
