"""Inference pipeline: preprocess -> forward -> score/decode -> NMS ->
rescale — counterpart of ``yunet_tpu/eval/detect.py``.

  * ``resize_img`` modes ORIGIN / AUTO (zero-pad H, W up to a multiple of
    32) and fixed "W,H" canvases with an aspect-preserving resize through
    ``ops/resize.py`` (cv2.resize's bytes, without OpenCV);
  * score fusion sigmoid(cls)*sigmoid(obj) and decode in f32 on the device
    (YuNet); for an SCRFD plan (``config.SCRFDConfig``), sigmoid(cls) and
    the distance decode over its anchors;
  * NMS either exact on the host (``native.nms``, uncapped — the AP-parity
    path and the default) or on the device (``ops/nms.py``: a top-k cap
    and one packed readback);
  * on a CUDA device, a fused Detector's ``detect`` with device NMS
    replays its batch-1 program as one CUDA graph per canvas (``_Graph``)
    from the second call of a canvas on, in place of issuing its ~85
    launches one by one;
  * ``Detector.detect_sweep``: the WIDER sweep over many images of varying
    sizes, grouped by canvas, in ladder-sized batches;
    ``Detector.detect_tta``: multi-scale and flip test-time augmentation;
  * ``Detector.mesh``: several devices driven by one process, with
    ``detect_batch``'s rows split over them.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config, SCRFDConfig
from ..models.detector import YuNet
from ..models.fused import fold_inference_params, fused_forward
from ..models.head import flatten_level_outputs
from ..models.scrfd import SCRFD, fold_scrfd, scrfd_forward
from ..ops.boxes import bbox_decode, distance_decode, fuse_score, kps_decode
from ..ops.nms import device_nms, device_nms_batched
from ..ops.priors import grid_priors
from ..ops.resize import resize
from ..utils.profiling import laps, span
from .. import native

# the device type whose Detectors replay detect's program as CUDA graphs
_GRAPH_DEVICE = "cuda"
# the captured programs a Detector keeps, the least recently used evicted
# first: a sweep's solo images of many sizes cannot grow memory unbounded
_GRAPHS_KEPT = 4


# one captured batch-1 device program (``Detector.detect_packed``) and its
# stage: ``run`` replays it, which copies ``stage.x`` into its static input
# ``x`` (1, H, W, 3), runs the program into its static ``packed`` output
# and copies that into ``stage.packed``
_Graph = collections.namedtuple("_Graph", ("run", "x", "packed", "stage"))
# a graph's host side: ``x`` and ``packed``, tensors of the static input's
# and output's shapes and dtypes, page-locked on a CUDA Detector; each
# call's upload writes ``x``, its readback reads ``packed``
_Stage = collections.namedtuple("_Stage", ("x", "packed"))


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
    """Inference wrapper around a YuNet, or an SCRFD, on one device: the
    model is built from the plan's kind (``cfg.model`` a ``ModelConfig``
    or an ``SCRFDConfig``).

    dtype: torch.bfloat16 runs the conv trunk in bf16 (inputs shipped as
    uint8 and cast on the device), torch.float32 in f32. Score, decode and
    NMS are f32 either way.

    fused: fold BN into the depthwise convs. ``detect`` then runs every
    ConvDPUnit through the fused kernel (fastest at batch 1 on the TPU);
    ``detect_batch`` runs the folded units through the library convs, as
    the JAX serving program does. An SCRFD plan folds BN (and its Scales)
    into its dense convs, cast to ``dtype``, which the library convs run
    channels-last on either path (``models/scrfd.py:scrfd_forward``).

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

    CUDA graphs: a fused Detector on a CUDA device runs
    ``detect(use_device_nms=True)``'s device program (``detect_packed``)
    as a CUDA graph, one for each canvas shape, input dtype, trunk dtype
    and top-k. A key's first call runs eagerly (it loads the kernels and
    fills the lazy caches), its second captures the graph and runs it,
    later calls replay it; the same kernels in the same order, so the
    same bits. ``graph_captures`` and ``graph_replays`` count the calls
    that captured a graph and those that replayed one an earlier call
    captured. Every other path (CPU, unfused, host NMS, ``detect_batch``)
    issues its launches eagerly.

    Each graph owns a stage (``_Stage``): page-locked host buffers of its
    static input's and output's shapes, allocated at its capture and
    dropped with it. A graph's call copies the canvas into the stage's
    input in one host pass (an f32 trunk's cast in the same pass); the
    graph itself copies that to the card as its first node and its
    result back into the stage's output as its last; the call then
    synchronizes the stream and reads the stage. So the next write into a
    stage's input comes after the last call's synchronize, with no copy in
    flight over it, and no result aliases a stage (``_kept_rows`` and
    ``_result`` copy what they keep). ``staged_calls`` counts the calls
    whose frame went through a stage: each capture and each replay. The
    eager calls (a key's first) upload and read back as the other paths
    do.

    A capture freezes the kernels that the
    module functions in use at that moment launch (say
    ``models.fused.fused_conv_dp``): a function put in their place later
    does not reach a kept graph, so a call that must run another function
    has to run eagerly (``_graph_key`` returning None) or on a new
    Detector. The kernel wrappers' launch counters count the launches
    their Python issues, eagerly or into a capture; a replay runs no
    wrapper and adds nothing to them.
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
        self.scrfd = isinstance(cfg.model, SCRFDConfig)
        if self.scrfd and folded is not None:
            raise ValueError("a folded tree is YuNet's; give an SCRFD "
                             "model or state dict")
        self.model = None
        self.folded = folded
        if folded is None:
            if isinstance(model_or_state, torch.nn.Module):
                model = model_or_state.to(self.device)
            else:
                model = (SCRFD if self.scrfd else YuNet)(
                    cfg.model, device=self.device)
                model.load_state_dict(model_or_state)
            self.model = model.eval()
            if fused:
                self.folded = (fold_scrfd(model, dtype) if self.scrfd else
                               fold_inference_params(model, cfg.model))
        self._priors: Dict[Tuple[int, int], torch.Tensor] = {}
        # images whose device-NMS pre-NMS cap was saturated in the last
        # detect_batch(use_device_nms=True) call
        self.last_devnms_saturated = 0
        self.mesh = None
        # detect's graph keys run once, eagerly, and the captured graphs
        self._primed: "collections.OrderedDict[tuple, None]" = \
            collections.OrderedDict()
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = \
            collections.OrderedDict()
        self.graph_captures = self.graph_replays = self.staged_calls = 0

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
        if (h, w) not in self._priors:
            # canvases are padded to a multiple of 32: division is exact
            m = self.cfg.model
            self._priors[(h, w)] = torch.from_numpy(grid_priors(
                [(h // s, w // s) for s in m.strides], m.strides,
                m.prior_offset, num_anchors=m.num_anchors if self.scrfd
                else 1)).to(self.device)
        return self._priors[(h, w)]

    @torch.inference_mode()
    def raw(self, x: torch.Tensor, *, conv_kernel: bool):
        """x: (B, H, W, 3) uint8 or float raw BGR on the device ->
        scores (B, P), boxes (B, P, 4), kps (B, P, 2K), all f32.
        conv_kernel: run a fused YuNet detector's units through the
        kernel (an SCRFD trunk has no kernel of its own)."""
        with span("yunet.trunk"):
            xc = x.to(self.dtype).permute(0, 3, 1, 2)
            if self.folded is None:
                flat = self.model.forward_flat(xc)
            elif self.scrfd:
                flat = scrfd_forward(self.folded, xc, self.cfg.model)
            else:
                flat = flatten_level_outputs(fused_forward(
                    self.folded, xc, self.cfg.model, use_kernel=conv_kernel))
        with span("yunet.decode"):
            priors = self.priors(x.shape[1], x.shape[2])
            if self.scrfd:
                scores = torch.sigmoid(flat["cls"][..., 0].float())
                boxes = distance_decode(priors, flat["bbox"].float())
            else:
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

    # -- CUDA graphs of detect's device program ------------------------------
    def _graph_key(self, det_img: np.ndarray, top_k: int) -> Optional[tuple]:
        """The key of detect's device-NMS program for this canvas, or None
        where that program is not graphed (not on a CUDA device, or no
        folded tree: units outside the kernel)."""
        if self.device.type != _GRAPH_DEVICE or self.folded is None:
            return None
        return (det_img.shape, det_img.dtype, self.dtype, top_k)

    def _stage(self, key: tuple) -> _Stage:
        """A primed key's stage: host tensors of the shapes and dtypes of
        its eager call's input and output, page-locked on a CUDA device."""
        pin = self.device.type == _GRAPH_DEVICE
        return _Stage(*(torch.empty(shape, dtype=dtype, pin_memory=pin)
                        for shape, dtype in self._primed[key]))

    def _record(self, stage: _Stage, top_k: int):
        """Capture as one CUDA graph, which runs nothing: the copy of the
        stage's input into a new static input, ``detect_packed`` on it and
        the copy of its output into the stage's -> (replay, static input,
        static output)."""
        x = torch.empty_like(stage.x, device=self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x.copy_(stage.x, non_blocking=True)
            packed = self.detect_packed(x, top_k)
            stage.packed.copy_(packed, non_blocking=True)
        return graph.replay, x, packed

    def _capture(self, key: tuple, stage: _Stage, top_k: int) -> _Graph:
        """Capture key's program between the two halves of its stage and
        keep it, the least recently used graph (and its stage) evicted
        past ``_GRAPHS_KEPT``."""
        graph = self._graphs[key] = _Graph(*self._record(stage, top_k),
                                           stage)
        del self._primed[key]
        if len(self._graphs) > _GRAPHS_KEPT:
            self._graphs.popitem(last=False)
        self.graph_captures += 1
        return graph

    def _prime(self, key: tuple, x: torch.Tensor,
               packed: torch.Tensor) -> None:
        """Note key's first, eager call, on input x to output packed: its
        next call captures, with a stage of their shapes and dtypes."""
        self._primed[key] = ((x.shape, x.dtype), (packed.shape, packed.dtype))
        if len(self._primed) > _GRAPHS_KEPT:
            self._primed.popitem(last=False)

    def _staged(self, key: tuple, graph: Optional[_Graph],
                det_img: np.ndarray, top_k: int, lap) -> np.ndarray:
        """A call of key's graph (captured here on key's second call): the
        canvas into the stage, the graph's run, the stage's output ->
        packed rows, a view of the stage that the next call overwrites."""
        stage = self._stage(key) if graph is None else graph.stage
        with span("yunet.upload"):
            np.copyto(stage.x.numpy(), det_img, casting="unsafe")
        lap("put")
        if graph is None:
            graph = self._capture(key, stage, top_k)
        else:
            self._graphs.move_to_end(key)
            self.graph_replays += 1
        with span("yunet.graph"):
            graph.run()
        self.staged_calls += 1
        lap("dispatch")
        with span("yunet.readback"):
            if self.device.type == _GRAPH_DEVICE:
                torch.cuda.current_stream(self.device).synchronize()
            return stage.packed.numpy()

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
        CUDA graph replays them (the class doc); yunet.readback;
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
                top_k = max_dets or self.cfg.test.device_nms_pre
                key = self._graph_key(det_img, top_k)
                graph = self._graphs.get(key)
                if graph is None and key not in self._primed:
                    x = self._input([det_img])       # eager: no graph yet
                    lap("put")
                    packed = self.detect_packed(x, top_k)
                    if key is not None:
                        self._prime(key, x, packed)
                    lap("dispatch")
                    with span("yunet.readback"):
                        packed = packed.cpu().numpy()    # ONE readback
                else:
                    packed = self._staged(key, graph, det_img, top_k, lap)
                lap("device_readback")
                with span("yunet.result"):
                    out = _result(*_kept_rows(packed, score_thr), det_scale)
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
            return [_result(*_kept_rows(packed[i, :, :-1], score_thr), sc)
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
        """Exact, uncapped host NMS on one image's raw outputs ->
        (detections (n, 5), keypoints (n, 2K))."""
        valid = scores >= score_thr
        bv, sv, kv = boxes[valid], scores[valid], kps[valid]
        keep = native.nms(bv, sv, self.cfg.test.nms_iou_thr)
        if max_dets is not None and max_dets > 0:
            keep = keep[:max_dets]
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


def _kept_rows(packed: np.ndarray, score_thr: float):
    """Packed device-NMS rows [x1 y1 x2 y2 score keep kps...] of one image
    -> the kept (detections, keypoints). The device program bakes in
    cfg.test.score_thr; a higher per-call threshold is exact as a post-NMS
    filter (below-threshold boxes only suppress each other)."""
    keep = (packed[:, 5] > 0.5) & (packed[:, 4] >= score_thr)
    return packed[keep, :5], packed[keep, 6:]
