"""Inference pipeline: preprocess -> forward -> score/decode -> NMS ->
rescale — counterpart of ``yunet_tpu/eval/detect.py``.

  * ``resize_img`` modes ORIGIN / AUTO (zero-pad H, W up to a multiple of
    32) and fixed "W,H" canvases with an aspect-preserving resize through
    ``ops/resize.py`` (cv2.resize's bytes, without OpenCV);
  * score and decode in f32 on the device (``models.architecture``);
  * NMS either exact on the host (``native.nms``, uncapped — the AP-parity
    path and the default) or on the device (``ops/nms.py``: a top-k cap
    and one packed readback);
  * ``Detector.detect_sweep``: the WIDER sweep over many images of varying
    sizes, grouped by canvas, in ladder-sized batches;
    ``Detector.detect_tta``: multi-scale and flip test-time augmentation;
  * ``Detector.mesh``: several devices driven by one process, with
    ``detect_batch``'s rows split over them.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..models import YuNet, architecture
from ..ops.nms import device_nms, device_nms_batched
from ..ops.resize import resize
from ..utils.profiling import laps, span
from .. import native
from .graphs import Graphs


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
    (canvas image, det_scale). An image that is already its canvas (its
    mode's shape, or a multiple of divisor in ORIGIN/AUTO) is returned
    itself, not a copy: callers read a canvas and never write it."""
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
        if img.shape == (input_size[1], input_size[0], 3):
            return img, det_scale       # the frame is its own canvas
        resized = img       # cv2.resize to the same size is the identity
    else:
        # np.require copies a read-only array (a memory-mapped cache entry)
        # that torch.from_numpy would warn about; resize never writes it
        resized = resize(torch.from_numpy(np.require(img, requirements=[
            "C", "W"])), (new_w, new_h)).numpy()
    det_img = np.zeros((input_size[1], input_size[0], 3), dtype=img.dtype)
    det_img[:new_h, :new_w] = resized
    return det_img, det_scale


def bbox2result(bboxes: np.ndarray, labels: np.ndarray,
                num_classes: int) -> list:
    """Split (n, 5) detections into per-class numpy arrays
    (reference core/bbox/transforms.py bbox2result)."""
    if bboxes.shape[0] == 0:
        return [np.zeros((0, 5), np.float32)
                for _ in range(num_classes)]
    return [bboxes[labels == i] for i in range(num_classes)]


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
    """Inference wrapper around a YuNet, an SCRFD or a RetinaFace on one
    device (``models.architecture(cfg.model)``).

    dtype: torch.bfloat16 runs the conv trunk in bf16 (inputs shipped as
    uint8 and cast on the device), torch.float32 in f32. Score, decode and
    NMS are f32 either way.

    fused: fold BN into the convs. ``detect`` then runs every ConvDPUnit
    through the fused kernel (fastest at batch 1 on the TPU);
    ``detect_batch`` runs the folded units through the library convs, as
    the JAX serving program does. SCRFD has no kernel of its own;
    RetinaFace's ``detect`` runs its convs through ``ops/conv_epi.py``'s
    kernel, ``detect_batch`` through the plain version.

    folded: a pre-folded tree (``export/onnx_import.py:load_onnx_params``)
    in place of a model: the detector then runs fused and holds no model
    (``model_or_state`` is None, ``self.model`` too).

    mesh: None (the default), or a sequence of torch devices set after
    construction (``det.mesh = ["cuda:0", "cuda:1"]``): one process then
    drives them all. ``detect_batch`` splits its rows evenly over the mesh
    when their count is a multiple of its size (other batches, such as the
    sweep's sub-mesh-size ladder chunks, stay on ``self.device``). Each
    shard runs on a replica of the model, or of the folded tree, on its
    device, made at the first sharded call from the weights of that
    moment and kept; setting ``mesh`` again drops the replicas.

    ``self.graphs`` (``eval/graphs.py``) runs ``detect``'s device-NMS
    program, as a CUDA graph where it can; every other path is eager.
    """

    def __init__(self, cfg: Config, model_or_state=None, *, device,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 folded=None):
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be bf16 or f32, not {dtype}")
        if (model_or_state is None) == (folded is None):
            raise ValueError("give a model or state dict, or a folded tree")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.arch = architecture(cfg.model)
        if folded is not None and self.arch is not YuNet:
            raise ValueError(f"a folded tree is YuNet's; give a "
                             f"{self.arch.__name__} model or state dict")
        self.model = None
        self.folded = folded
        if folded is None:
            if isinstance(model_or_state, torch.nn.Module):
                model = model_or_state.to(self.device)
            else:
                model = self.arch(cfg.model, device=self.device)
                model.load_state_dict(model_or_state)
            self.model = model.eval()
            if fused:
                self.folded = model.fold(dtype)
        self._priors: Dict[Tuple[int, int], torch.Tensor] = {}
        # images whose device-NMS pre-NMS cap was saturated in the last
        # detect_batch(use_device_nms=True) call
        self.last_devnms_saturated = 0
        self.mesh = None
        self.graphs = Graphs(self.device, dtype, self.folded is not None)

    @property
    def mesh(self) -> Optional[Tuple[torch.device, ...]]:
        return self._mesh

    @mesh.setter
    def mesh(self, devices: Optional[Sequence]) -> None:
        self._mesh = (None if devices is None
                      else tuple(torch.device(d) for d in devices))
        if self._mesh is not None and not self._mesh:
            raise ValueError("a mesh needs at least one device")
        self._replicas: Dict[int, "Detector"] = {}

    def _replica(self, i: int) -> "Detector":
        """The Detector that runs shard i, on mesh[i]."""
        if i not in self._replicas:
            dev = self._mesh[i]
            if self.model is not None:
                self._replicas[i] = Detector(
                    self.cfg, copy.deepcopy(self.model).to(dev), device=dev,
                    dtype=self.dtype, fused=self.folded is not None)
            else:
                self._replicas[i] = Detector(
                    self.cfg, folded=_tree_to(self.folded, dev), device=dev,
                    dtype=self.dtype)
        return self._replicas[i]

    # -- device programs ---------------------------------------------------
    def priors(self, h: int, w: int) -> torch.Tensor:
        """The family's prior table of an h x w canvas, on the device."""
        if (h, w) not in self._priors:
            self._priors[(h, w)] = torch.from_numpy(self.arch.priors(
                self.cfg.model, h, w)).to(self.device)
        return self._priors[(h, w)]

    @torch.inference_mode()
    def raw(self, x: torch.Tensor, *, conv_kernel: bool):
        """x: (B, H, W, 3) uint8 or float raw BGR on the device ->
        scores (B, P), boxes (B, P, 4), kps (B, P, 2K), all f32.
        conv_kernel: run a fused YuNet detector's units through the
        kernel."""
        with span("yunet.trunk"):
            xc = x.to(self.dtype).permute(0, 3, 1, 2)
            if self.folded is None:
                flat = self.model.forward_flat(xc)
            else:
                flat = self.arch.forward_folded(
                    self.folded, xc, self.cfg.model, use_kernel=conv_kernel)
        with span("yunet.decode"):
            priors = self.priors(x.shape[1], x.shape[2])
            return self.arch.decode(flat, priors, self.cfg.model)

    @torch.inference_mode()
    def detect_packed(self, x: torch.Tensor, top_k: int) -> torch.Tensor:
        """Batch-1 program with device NMS: x (1, H, W, 3) -> packed
        (K, 6 + 2K) rows [x1 y1 x2 y2 score keep kps...]
        (yunet_tpu/eval/detect.py:162-185)."""
        scores, boxes, kps = self.raw(x, conv_kernel=True)
        with span("yunet.nms"):
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
        with span("yunet.nms"):
            dets, keep, idx = device_nms_batched(
                boxes, scores, top_k=top_k,
                iou_thr=self.cfg.test.nms_iou_thr,
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
        with span("yunet.upload"):
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
        seconds — {preproc, put, dispatch, device_readback, post}, read
        at the ends of the stage spans: yunet.letterbox; yunet.upload;
        yunet.trunk, yunet.decode and yunet.nms, or yunet.graph where a
        CUDA graph replays them (``eval/graphs.py``); yunet.readback;
        yunet.host_nms and yunet.result.
        ``dispatch`` ends when the device program has been queued,
        ``device_readback`` when its result is on the host: the device's
        run falls in one of the two, depending on how far the host got
        ahead of it. ``post`` holds the host NMS, if any, and the rescale.
        """
        with span("yunet.detect"):
            lap = laps(timings)
            score_thr = (self.cfg.test.score_thr if score_thr is None
                         else score_thr)
            with span("yunet.letterbox"):
                det_img, det_scale = resize_img(img_bgr, mode, pad_divisor)
            lap("preproc")
            if use_device_nms:
                self._check_thr(score_thr)
                packed = self.graphs.run(
                    det_img, max_dets or self.cfg.test.device_nms_pre, lap,
                    self._input, self.detect_packed)
                lap("device_readback")
                with span("yunet.result"):
                    out = _result(*_kept_rows(
                        packed, score_thr, self.cfg.test.max_per_img),
                        det_scale)
            else:
                x = self._input([det_img])
                lap("put")
                out = self.raw(x, conv_kernel=True)
                lap("dispatch")
                with span("yunet.readback"):
                    scores, boxes, kps = (a[0].cpu().numpy() for a in out)
                lap("device_readback")
                with span("yunet.host_nms"):
                    sel, kps_sel = self._host_nms(scores, boxes, kps,
                                                  score_thr, max_dets)
                with span("yunet.result"):
                    out = _result(sel, kps_sel, det_scale)
            lap("post")
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
        if self._mesh is not None and len(views) % len(self._mesh) == 0:
            # one shard of rows a device, each on its replica: every
            # shard's program is queued before the first readback
            n = len(views) // len(self._mesh)
            shards = [(self._replica(i), views[i * n:(i + 1) * n])
                      for i in range(len(self._mesh))]
        else:
            shards = [(self, views)]
        if use_device_nms:
            self._check_thr(score_thr)
            outs = [det.serve_packed(det._input(v), device_nms_top_k)
                    for det, v in shards]
            packed = np.concatenate([o.cpu().numpy() for o in outs])
            self.last_devnms_saturated = int(
                (packed[:, 0, -1] > packed.shape[1]).sum())
            return [_result(*_kept_rows(packed[i, :, :-1], score_thr,
                                        self.cfg.test.max_per_img), sc)
                    for i, sc in enumerate(scales)]
        outs = [det.raw(det._input(v), conv_kernel=False)
                for det, v in shards]
        scores, boxes, kps = (np.concatenate([o[j].cpu().numpy()
                                              for o in outs])
                              for j in range(3))
        return [_result(*self._host_nms(scores[i], boxes[i], kps[i],
                                        score_thr), sc)
                for i, sc in enumerate(scales)]

    def detect_sweep(self, entries, mode: Union[str, Tuple[int, int]], *,
                     pad_divisor: int = 32, batch_size: int = 32,
                     score_thr: Optional[float] = None,
                     on_result=None, use_device_nms: bool = False,
                     device_nms_top_k: int = 750,
                     prefetch: bool = True):
        """Batched detection sweep over many images of varying sizes —
        the engine behind tools/test_widerface.py
        (``yunet_tpu/eval/detect.py:472-602``).

        entries: sequence of (load_fn, (height, width)) — load_fn() is
        called lazily per chunk and returns a numpy image; the size hint
        (e.g. labelv2 header dims) drives the grouping. Images group by
        their canvas_shape (the rule resize_img applies), chunks split
        down a {1, 2, 4, ..., batch_size} ladder (17 -> 16 + 1: no padding
        with copies), so a canvas sees at most a few batch sizes, the
        same batches as the JAX sweep, and any image whose LOADED size
        disagrees with its hint (EXIF rotation, stale header) runs solo
        through detect() instead of aborting the sweep.

        Returns results in input order; on_result(index, result) fires as
        each completes. use_device_nms/device_nms_top_k pass through to
        detect_batch; a solo image runs detect() with the same NMS backend
        and max_dets=device_nms_top_k. ``last_sweep_stats`` holds {images,
        misfit_solo, batches, devnms_saturated}.

        prefetch=True loads the NEXT chunk's images on a lookahead thread
        while the current chunk runs; that thread only calls the load_fns
        and canvas_shape (numpy), every torch call stays on this thread.
        """
        groups: dict = {}
        for idx, (load_fn, (h, w)) in enumerate(entries):
            key = canvas_shape(int(h), int(w), mode, pad_divisor)
            groups.setdefault(key, []).append((idx, load_fn))

        ladder = [batch_size]
        while ladder[-1] > 1:
            ladder.append(ladder[-1] // 2)

        results: dict = {}
        stats = {"images": len(entries), "misfit_solo": 0, "batches": 0,
                 "devnms_saturated": 0}

        def emit(idx, res):
            results[idx] = res
            if on_result is not None:
                on_result(idx, res)

        tasks = [(key, members[start:start + batch_size])
                 for key, members in groups.items()
                 for start in range(0, len(members), batch_size)]

        def load_chunk(task):
            key, chunk = task
            loaded, misfits = [], []
            for idx, load_fn in chunk:
                img = load_fn()
                actual = canvas_shape(img.shape[0], img.shape[1],
                                      mode, pad_divisor)
                (loaded if actual == key else misfits).append((idx, img))
            return loaded, misfits

        def process(loaded, misfits):
            for idx, img in misfits:      # the hint was wrong: run solo
                stats["misfit_solo"] += 1
                emit(idx, self.detect(img, mode=mode, score_thr=score_thr,
                                      pad_divisor=pad_divisor,
                                      use_device_nms=use_device_nms,
                                      max_dets=(device_nms_top_k
                                                if use_device_nms
                                                else None)))
            pos = 0
            while pos < len(loaded):
                size = next(s for s in ladder if s <= len(loaded) - pos)
                part = loaded[pos:pos + size]
                pos += size
                stats["batches"] += 1
                outs = self.detect_batch(
                    [img for _, img in part], mode,
                    score_thr=score_thr, pad_divisor=pad_divisor,
                    use_device_nms=use_device_nms,
                    device_nms_top_k=device_nms_top_k)
                if use_device_nms:
                    stats["devnms_saturated"] += self.last_devnms_saturated
                for (idx, _), out in zip(part, outs):
                    emit(idx, out)

        if prefetch and len(tasks) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(load_chunk, tasks[0])
                for t in range(len(tasks)):
                    loaded, misfits = fut.result()
                    if t + 1 < len(tasks):
                        fut = ex.submit(load_chunk, tasks[t + 1])
                    process(loaded, misfits)
        else:
            for task in tasks:
                process(*load_chunk(task))
        log = logging.getLogger("yunet_tpu_torch")
        if stats["misfit_solo"]:
            log.warning(
                "detect_sweep: %d/%d images had stale size hints and ran "
                "solo (batch-1)", stats["misfit_solo"], stats["images"])
        if stats["devnms_saturated"]:
            log.warning(
                "detect_sweep: %d/%d images saturated the device-NMS "
                "pre-NMS cap (device_nms_top_k=%d) — their keep sets "
                "may differ from uncapped host NMS; raise the cap or "
                "use host NMS for protocol-exact AP",
                stats["devnms_saturated"], stats["images"],
                device_nms_top_k)
        self.last_sweep_stats = stats
        return [results[i] for i in range(len(results))]

    def detect_tta(self, img_bgr: np.ndarray,
                   scales=((640, 640),), flip: bool = False, *,
                   score_thr: Optional[float] = None
                   ) -> Dict[str, np.ndarray]:
        """Multi-scale (+ horizontal-flip) test-time augmentation: run each
        view through detect (host NMS), map detections back to original
        coordinates, merge with one final host NMS
        (``yunet_tpu/eval/detect.py:604-639``)."""
        all_boxes, all_kps = [], []
        views = [(s, False) for s in scales]
        if flip:
            views += [(s, True) for s in scales]
        w = img_bgr.shape[1]
        for scale, flipped in views:
            view = img_bgr[:, ::-1] if flipped else img_bgr
            r = self.detect(np.ascontiguousarray(view), mode=scale,
                            score_thr=score_thr)
            bb, kp = r["bboxes"], r["kps"]
            if flipped and bb.shape[0]:
                bb = bb.copy()
                x1 = w - bb[:, 2]
                x2 = w - bb[:, 0]
                bb[:, 0], bb[:, 2] = x1, x2
                kp = kp.reshape(-1, kp.shape[1] // 2, 2).copy()
                kp = kp[:, [1, 0, 2, 4, 3], :]     # landmark reorder
                kp[..., 0] = w - kp[..., 0]
                kp = kp.reshape(bb.shape[0], -1)
            all_boxes.append(bb)
            all_kps.append(kp)
        boxes = np.concatenate(all_boxes, 0)
        kps = np.concatenate(all_kps, 0)
        keep = native.nms(boxes[:, :4], boxes[:, 4],
                          self.cfg.test.nms_iou_thr)
        return {"bboxes": boxes[keep], "kps": kps[keep],
                "labels": np.zeros((len(keep),), np.int64)}

    def warmup(self, shapes):
        """One detect of a black image at each (h, w)."""
        for (h, w) in shapes:
            self.detect(np.zeros((h, w, 3), np.uint8), mode="AUTO")

    def _host_nms(self, scores, boxes, kps, score_thr, max_dets=None):
        """Exact host NMS on one image's raw outputs, uncapped before it,
        the top ``cfg.test.max_per_img`` (where positive) and ``max_dets``
        kept after it -> (detections (n, 5), keypoints (n, 2K))."""
        valid = scores >= score_thr
        bv, sv, kv = boxes[valid], scores[valid], kps[valid]
        keep = native.nms(bv, sv, self.cfg.test.nms_iou_thr)
        for cap in (self.cfg.test.max_per_img, max_dets):
            if cap is not None and cap > 0:
                keep = keep[:cap]
        return np.concatenate([bv[keep], sv[keep, None]], axis=-1), kv[keep]


def _tree_to(tree, device):
    """A folded tree (dicts, lists, FoldedUnits of tensors) rebuilt with
    every tensor on ``device``; a tensor already there is shared (the
    detector only reads it)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def _kept_rows(packed: np.ndarray, score_thr: float,
               max_per_img: int = -1):
    """Packed device-NMS rows [x1 y1 x2 y2 score keep kps...] of one image,
    in score order -> the kept (detections, keypoints), the first
    max_per_img of them where it is positive. The device program bakes in
    cfg.test.score_thr; a higher per-call threshold is exact as a post-NMS
    filter (below-threshold boxes only suppress each other)."""
    keep = np.flatnonzero((packed[:, 5] > 0.5) & (packed[:, 4] >= score_thr))
    if max_per_img > 0:
        keep = keep[:max_per_img]
    return packed[keep, :5], packed[keep, 6:]
