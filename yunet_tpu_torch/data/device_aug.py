"""Card-staged dataset with on-card augmentation — the counterpart of
``yunet_tpu/data/device_aug.py``, one card.

The decoded dataset is staged into card memory ONCE, and a step's input
pipeline is:

  host : crop geometry (RandomSquareCrop placement retries against the
         annotation boxes only) and the GT transforms, numpy in a
         producer thread; a ~10 KB payload a sample
  card : gather the source images from the bank and crop + resize +
         flip them as two batched interpolation matmuls
         (out = My @ img @ Mx^T), the region outside the image blending
         to gray 128 like the host pipeline's padded canvas

Staging resizes each image so its short side is ``bank_size`` (the long
side capped by the canvas) with ``ops/resize.py:resize_area``, byte-equal
to JAX's ``cv2.resize(..., INTER_AREA)``, so the port's bank is JAX's.
Card memory: N x canvas^2 x 3 bytes (real WIDER train, 12,880 images at
1152^2, is ~51 GB). A bank sharded over several cards waits for data
parallelism (ROADMAP M9): ``device_shards`` here only indexes the host
side as JAX does.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dataset import SampleSpec, pack_batch
from .labelv2 import NK, Record, parse_labelv2
from .loader import _Failed
from .transforms import KPS_FLIP_ORDER, _centers_in_patch

AUG_KEYS = ("aug_idx", "aug_y0", "aug_x0", "aug_side", "aug_flip")
# close() waits this long for the batch under way (a batch takes ms)
_CLOSE_WAIT_S = 30.0


class ImageBank:
    """Decode the dataset once into a fixed-canvas uint8 array.

    images[i]: short side resized to ``bank_size`` (or long side capped at
    ``canvas``), pasted top-left into a (canvas, canvas, 3) gray-128
    field. ``dims[i] = (h, w)`` is the valid region; ``ratios[i]`` maps
    original -> bank coordinates. Pixels come from the decoded ``.npy``
    cache (``data/cache.py``) when ``decoded_cache`` is given and holds the
    image, else from ``cv2.imread`` (imported only then)."""

    def __init__(self, records: List[Record], img_prefix: str, *,
                 bank_size: int = 640, canvas: int = 1152,
                 shard_index: int = 0, shard_count: int = 1,
                 decoded_cache: Optional[str] = None):
        from ..ops.resize import resize_area

        self.bank_size = bank_size
        self.canvas = canvas
        self.shard_index = shard_index
        self.shard_count = shard_count
        # contiguous shard of the record list (shard-disjoint sampling)
        self.records = records[shard_index::shard_count]
        n = len(self.records)
        self.images = np.full((n, canvas, canvas, 3), 128, np.uint8)
        self.dims = np.zeros((n, 2), np.int32)
        self.ratios = np.zeros((n,), np.float32)
        for i, rec in enumerate(self.records):
            img = _read(img_prefix, rec.filename, decoded_cache)
            h, w = img.shape[:2]
            r = bank_size / min(h, w)
            if round(max(h, w) * r) > canvas:
                r = canvas / max(h, w)
            bh, bw = max(int(round(h * r)), 1), max(int(round(w * r)), 1)
            if (bh, bw) != (h, w):
                # a copy: a cached image is a read-only memory map
                img = resize_area(torch.from_numpy(np.array(img)),
                                  (bw, bh)).numpy()
            self.images[i, :bh, :bw] = img
            self.dims[i] = (bh, bw)
            self.ratios[i] = r

    def __len__(self) -> int:
        return len(self.records)

    def _check_capacity(self, device, _stats=None) -> None:
        """Fail at staging time, with arithmetic, if the bank cannot fit
        in 80% of the card's free memory (the rest is headroom for the
        parameters, activations and the allocator). ``_stats``: JAX's
        ``memory_stats()`` keys (``bytes_limit``, ``bytes_in_use``) in
        place of the card's; without a limit (the CPU) there is nothing
        to check."""
        device = torch.device(device)
        if _stats is not None:
            stats = _stats
        elif device.type == "cuda":
            free, total = torch.cuda.mem_get_info(device)
            stats = {"bytes_limit": total, "bytes_in_use": total - free}
        else:
            stats = {}
        limit = stats.get("bytes_limit")
        if not limit:
            return
        need = self.images.nbytes
        free = limit - stats.get("bytes_in_use", 0)
        budget = int(free * 0.8)
        if need <= budget:
            return
        raise RuntimeError(
            f"image bank needs {need / 1e9:.2f} GB per device "
            f"({len(self.images)} images x {self.canvas}^2 x 3 B) but only "
            f"{free / 1e9:.2f} GB of {limit / 1e9:.2f} GB device memory is "
            f"free (budget {budget / 1e9:.2f} GB with scratch headroom). "
            "Options: (a) data.bank_sharded=true shards the bank over "
            "several cards with shard-local sampling (needs data-parallel "
            "training, not ported yet: ROADMAP M9); (b) reduce "
            "data.bank_canvas / data.bank_size; (c) data.device_aug=false "
            "uses the host pipeline (no device memory cost, needs host "
            "decode and copy bandwidth).")

    def to_device(self, device, chunk_mb: int = 96) -> torch.Tensor:
        """The bank as one uint8 tensor on ``device``. On a card: the
        capacity check, then chunks of ``chunk_mb`` copied through one
        pinned buffer into a preallocated tensor (peak: the bank and one
        chunk). On the CPU: the host array itself, uncopied."""
        device = torch.device(device)
        self._check_capacity(device)
        if device.type != "cuda":
            return torch.from_numpy(self.images).to(device)
        bank = torch.empty(self.images.shape, dtype=torch.uint8,
                           device=device)
        per_img = self.images[0].nbytes if len(self.images) else 1
        step = max(chunk_mb * (1 << 20) // per_img, 1)
        pinned = torch.empty((min(step, len(self.images)),)
                             + self.images.shape[1:],
                             dtype=torch.uint8).pin_memory()
        for i in range(0, len(self.images), step):
            chunk = torch.from_numpy(self.images[i:i + step])
            pinned[:len(chunk)].copy_(chunk)
            bank[i:i + len(chunk)].copy_(pinned[:len(chunk)],
                                          non_blocking=True)
            # the pinned buffer is refilled next: wait for this copy
            torch.cuda.current_stream(device).synchronize()
        return bank


def _read(img_prefix: str, filename: str,
          decoded_cache: Optional[str]) -> np.ndarray:
    if decoded_cache is not None:
        from .cache import load_cached
        img = load_cached(decoded_cache, filename)
        if img is not None:
            return img
    import cv2

    path = os.path.join(img_prefix, filename)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def sample_crop_geometry(bank_h: int, bank_w: int, boxes: np.ndarray,
                         crop_choice: Sequence[float],
                         rng: np.random.RandomState, *,
                         scale: Optional[float] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """RandomSquareCrop placement (reference transforms.py:1047-1098)
    against the boxes only — no pixels touched. Returns (patch, keep_mask)
    in bank coordinates."""
    short_side = min(bank_h, bank_w)
    max_scale = max(crop_choice)
    if scale is None:
        scale = float(rng.choice(crop_choice))
    first = True
    while True:
        if not first and max_scale <= 1.0:
            scale = scale * 1.2
        elif not first:
            scale = float(rng.choice(crop_choice))
        first = False
        for _ in range(250):
            cw = int(scale * short_side)
            left = 0 if bank_w == cw else (
                rng.randint(0, bank_w - cw + 1) if bank_w > cw
                else rng.randint(bank_w - cw, 1))
            top = 0 if bank_h == cw else (
                rng.randint(0, bank_h - cw + 1) if bank_h > cw
                else rng.randint(bank_h - cw, 1))
            patch = np.asarray([left, top, left + cw, top + cw], np.int64)
            mask = _centers_in_patch(boxes, patch)
            if mask.any():
                return patch, mask


def make_aug_sample(bank: ImageBank, local_idx: int,
                    rng: np.random.RandomState, spec: SampleSpec,
                    wire_gts: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
    """One sample's geometry + transformed GTs (host side): the crop,
    resize and flip target math of WiderFaceDataset.get_train_sample with
    the pixel work left to device_resample. ``wire_gts`` caps the padded
    GT slots sent (the step re-pads to cfg.data.max_gts on the card)."""
    rec = bank.records[local_idx]
    bh, bw = bank.dims[local_idx]
    r = bank.ratios[local_idx]
    boxes = rec.bboxes * r
    kps = rec.kps.copy()
    kps[:, :, 0] *= r
    kps[:, :, 1] *= r

    patch, mask = sample_crop_geometry(
        int(bh), int(bw), boxes, spec.crop_choice, rng)
    p = patch.astype(np.float32)
    boxes = boxes[mask]
    boxes = np.concatenate([np.maximum(boxes[:, :2], p[:2]),
                            np.minimum(boxes[:, 2:], p[2:])], 1)
    boxes -= np.tile(p[:2], 2)
    kps = kps[mask]
    kps[:, :, 0] = np.clip(kps[:, :, 0], p[0], p[2]) - p[0]
    kps[:, :, 1] = np.clip(kps[:, :, 1], p[1], p[3]) - p[1]

    out = float(spec.img_size)
    side = float(patch[2] - patch[0])
    f = out / side
    boxes = boxes * f
    kps[:, :, :2] *= f

    flip = bool(rng.uniform() < spec.flip_ratio)
    if flip:
        b = boxes.copy()
        b[:, 0] = out - boxes[:, 2]
        b[:, 2] = out - boxes[:, 0]
        boxes = b
        kps = kps[:, KPS_FLIP_ORDER, :].copy()
        kps[:, :, 0] = out - kps[:, :, 0]

    g = spec.max_gts if wire_gts is None else min(wire_gts, spec.max_gts)
    n = boxes.shape[0]
    if n > g:
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = np.argsort(-area, kind="stable")[:g]
        boxes, kps = boxes[keep], kps[keep]
        overflow = n - g
        n = g
    else:
        overflow = 0
    out_boxes = np.zeros((g, 4), np.float32)
    out_kps = np.zeros((g, NK, 3), np.float32)
    out_boxes[:n] = boxes
    out_kps[:n] = kps
    return {
        "aug_idx": np.int32(local_idx),
        "aug_y0": np.float32(patch[1]),
        "aug_x0": np.float32(patch[0]),
        "aug_side": np.float32(side),
        "aug_flip": np.bool_(flip),
        "gt_bboxes": out_boxes,
        "gt_labels": np.zeros((g,), np.int32),
        "gt_kps": out_kps,
        "gt_valid": (np.arange(g) < n),
        "num_overflow": np.int32(overflow),
    }


@contextlib.contextmanager
def _f32_matmul():
    """Full-precision f32 GEMMs (no TF32) for the block's duration."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _rounded(x: torch.Tensor, mat_dtype: torch.dtype) -> torch.Tensor:
    """x rounded to mat_dtype, as f32: the GEMMs run in f32 on operands
    already rounded, so a bf16 product is exact and a sum of the tent's
    two non-zero products is rounded once, whatever order or fused
    multiply-add the GEMM uses."""
    return x.to(mat_dtype).float()


def row_tiling(out_size: int, h: int, max_scale: Optional[float],
               tile: Optional[int] = None) -> Tuple[Optional[int], int]:
    """(tile, strip) of device_resample's row-tiled y-stage on a canvas of
    ``h`` rows, strip 0 where it runs dense: without ``max_scale``, when
    ``tile`` does not divide ``out_size``, or when the strip would not be
    shorter than the canvas. The default tile is the largest divisor of
    out_size up to 320 (JAX's choice)."""
    if max_scale is None:
        return tile, 0
    if tile is None:
        tile = next(t for t in range(min(320, out_size), 0, -1)
                    if out_size % t == 0)
    if out_size % tile:
        return tile, 0
    strip = int((tile - 1) * max_scale) + 3   # floor(max)+1-floor(min)+1
    strip = -(-strip // 8) * 8
    return tile, strip if strip < h else 0


def device_resample(bank: torch.Tensor, idx: torch.Tensor, y0: torch.Tensor,
                    x0: torch.Tensor, side: torch.Tensor, flip: torch.Tensor,
                    *, out_size: int, dtype: Optional[torch.dtype] = None,
                    max_scale: Optional[float] = None,
                    tile: Optional[int] = None) -> torch.Tensor:
    """Batched crop + bilinear resize + flip from the bank, on the bank's
    device: two interpolation matmuls a sample.

    out[b,i,j,c] = sum_{k,l} My[b,i,k] Mx[b,j,l] bank[idx[b],k,l,c]
                   + 128 * (1 - cy[b,i] * cx[b,j])

    bank (N, H, W, 3) uint8; idx (B,) int; y0, x0, side (B,) f32; flip
    (B,) bool. The tent weights follow cv2.resize's convention (src =
    (dst + 0.5) * side / out - 0.5); taps outside the canvas contribute
    nothing and the uncovered fraction blends to gray 128. Returns (B,
    out, out, 3), f32 (or ``dtype``) in 0..255.

    JAX's numerics: the weights and pixels are rounded to ``dtype`` (f32
    by default), the products summed in f32, the y-stage rounded to
    ``dtype``, the x-stage kept in f32 with the gray blend added in f32,
    and the result cast last. In bf16 the result equals JAX's bit for bit
    (a bf16 product is exact in f32 and a tent row has two non-zero taps);
    in f32 a product's rounding and fused multiply-adds leave ulps.

    ``max_scale``: a bound on side / out_size. When given, the y-stage
    runs ROW-TILED: ``tile`` consecutive output rows touch at most
    (tile - 1) * max_scale + 2 consecutive source rows, so each (sample,
    tile) reads that strip of the bank and contracts over it instead of
    the canvas height. The taps it drops are exact zeros: bf16 is equal
    to the dense route."""
    mat_dtype = dtype if dtype is not None else torch.float32
    dev = bank.device
    h, w = bank.shape[1], bank.shape[2]
    idx = idx.to(dev, torch.int64)
    y0, x0, side = (v.to(dev, torch.float32) for v in (y0, x0, side))
    flip = flip.to(dev, torch.bool)
    # a tensor divisor: CUDA divides by a Python number as a product with
    # its reciprocal, an ulp off the CPU's (and JAX's) true division
    scale = (side / torch.full_like(side, float(out_size)))[:, None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    src_y = y0[:, None] + (o + 0.5) * scale - 0.5          # (B, out)
    ox = torch.where(flip[:, None], out_size - 1 - o, o)
    src_x = x0[:, None] + (ox + 0.5) * scale - 0.5

    tile, strip = row_tiling(out_size, h, max_scale, tile)
    with _f32_matmul():
        if strip:
            n_tiles = out_size // tile
            src_y_t = src_y.reshape(-1, n_tiles, tile)     # (B, T, tile)
            # src_y increases along a tile, so its first element is the
            # tile's least; the clamp keeps the strip inside the canvas
            # (taps it excludes lie outside [0, h), absent when dense too)
            start = torch.clamp(torch.floor(src_y_t[:, :, 0]).to(
                torch.int64), 0, h - strip)                # (B, T)
            ar = torch.arange(strip, device=dev)
            rows = start[:, :, None].float() + ar.float()  # (B, T, strip)
            my = torch.clamp_min(1.0 - torch.abs(
                src_y_t[..., None] - rows[:, :, None, :]), 0.0)
            cy = my.sum(-1).reshape(-1, out_size)          # f32 coverage
            strips = bank[idx[:, None, None],
                          start[:, :, None] + ar]          # (B,T,strip,w,3)
            bt = strips.shape[0] * n_tiles
            tmp = torch.bmm(_rounded(my, mat_dtype).reshape(bt, tile, strip),
                            _rounded(strips, mat_dtype).reshape(
                                bt, strip, w * 3))
            tmp = tmp.reshape(-1, out_size, w, 3)
        else:
            imgs = bank[idx]                               # (B, H, W, 3)
            ky = torch.arange(h, dtype=torch.float32, device=dev)
            my = torch.clamp_min(
                1.0 - torch.abs(src_y[:, :, None] - ky), 0.0)
            cy = my.sum(-1)                                # f32 coverage
            tmp = torch.bmm(_rounded(my, mat_dtype),
                            _rounded(imgs, mat_dtype).reshape(-1, h, w * 3))
            tmp = tmp.reshape(-1, out_size, w, 3)

        kx = torch.arange(w, dtype=torch.float32, device=dev)
        mx = torch.clamp_min(1.0 - torch.abs(src_x[:, :, None] - kx), 0.0)
        cx = mx.sum(-1)
        # out[b, i, j, c] = sum_w mx[b, j, w] tmp[b, w, (i, c)]
        b = tmp.shape[0]
        t = _rounded(tmp, mat_dtype).permute(0, 2, 1, 3).reshape(
            b, w, out_size * 3)
        out = torch.bmm(_rounded(mx, mat_dtype), t)        # (B, j, (i, c))
    # (B, j, i, c) -> (B, i, j, c), contiguous: the trunk reads NHWC
    out = out.reshape(b, out_size, out_size, 3).permute(0, 2, 1,
                                                        3).contiguous()
    out = out + 128.0 * (1.0 - cy[:, :, None] * cx[:, None, :])[..., None]
    return out if dtype is None else out.to(dtype)


class DeviceAugLoader:
    """TrainLoader-shaped iterator of geometry + GT batches (no pixels),
    with TrainLoader's epoch shuffle, per-sample seeds and ``start_step``
    resume; the host work is light, so one producer thread makes the
    batches. An exception in the producer is raised by the iterator.

    device_shards > 1: this host's records split into ``device_shards``
    equal sub-shards, batch slot j sampling from sub-shard
    j // (batch / device_shards) with a SUB-SHARD-LOCAL index, as JAX
    indexes a bank sharded over its cards (the training step takes one
    card's bank until ROADMAP M9)."""

    def __init__(self, ann_file: str, img_prefix: str, *,
                 batch_size: int, spec: SampleSpec, seed: int = 0,
                 min_size: Optional[float] = None,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, start_step: int = 0,
                 bank_size: int = 640, bank_canvas: int = 1152,
                 device_shards: int = 1,
                 decoded_cache: Optional[str] = None):
        records = parse_labelv2(ann_file, min_size=min_size)
        if process_count > 1:
            # shard sizes must be uniform across hosts: truncate first
            per = len(records) // (process_count * max(device_shards, 1))
            if per == 0:
                raise ValueError("fewer images than process*device shards")
            records = records[:per * process_count * max(device_shards, 1)]
        self.bank = ImageBank(records, img_prefix, bank_size=bank_size,
                              canvas=bank_canvas,
                              shard_index=process_index,
                              shard_count=process_count,
                              decoded_cache=decoded_cache)
        self.device_shards = device_shards
        n = len(self.bank)
        if device_shards > 1:
            if batch_size % device_shards:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"device_shards {device_shards}")
            # equal sub-shards: truncate the tail
            per = n // device_shards
            if per == 0:
                raise ValueError("fewer images than device shards")
            keep = per * device_shards
            self.bank.records = self.bank.records[:keep]
            self.bank.images = self.bank.images[:keep]
            self.bank.dims = self.bank.dims[:keep]
            self.bank.ratios = self.bank.ratios[:keep]
            self.shard_len = per
        else:
            self.shard_len = n
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.spec = spec
        # wire payload: pad GTs only to what this shard can produce
        # (rounded up); the step re-pads to spec.max_gts
        max_faces = max((len(r.bboxes) for r in self.bank.records),
                        default=1)
        self.wire_gts = min(spec.max_gts, max(8, -(-max_faces // 8) * 8))
        self._start_step = start_step
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    @property
    def steps_per_epoch(self) -> int:
        if self.device_shards > 1:
            sub = self.batch_size // self.device_shards
            return max(self.shard_len // sub, 1)
        return max(len(self.bank) // self.batch_size, 1)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """(steps, batch) of GLOBAL record indices for this epoch; with
        sub-shards, slot j draws from sub-shard j // (batch /
        device_shards), each sub-shard permuted on its own."""
        rng = np.random.RandomState(self.seed + epoch)
        if self.device_shards > 1:
            sub = self.batch_size // self.device_shards
            steps = self.steps_per_epoch
            cols = []
            for s in range(self.device_shards):
                perm = rng.permutation(self.shard_len)[:steps * sub]
                cols.append(perm.reshape(steps, sub) + s * self.shard_len)
            return np.concatenate(cols, axis=1)
        idx = rng.permutation(len(self.bank))
        usable = (len(idx) // self.batch_size) * self.batch_size
        return idx[:usable].reshape(-1, self.batch_size)

    def _put(self, item) -> bool:
        """Queue item unless stopped; False once stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            self._produce()
        except Exception as e:  # handed to the consumer, which raises it
            self._put(_Failed(e))

    def _produce(self):
        epoch = self._start_step // self.steps_per_epoch
        skip = self._start_step % self.steps_per_epoch
        step_global = self._start_step
        while not self._stop.is_set():
            batches = self._epoch_indices(epoch)
            if skip:
                batches = batches[skip:]
                skip = 0
            for batch_idx in batches:
                off = self.process_index * self.batch_size
                samples = []
                for j, i in enumerate(batch_idx):
                    # mod 2^32: numpy seeds are bounded, and the stride
                    # overflows past step ~4294
                    rng = np.random.RandomState(
                        (self.seed + 1000003 * step_global + off + j)
                        % (2 ** 32))
                    s = make_aug_sample(
                        self.bank, int(i), rng, self.spec,
                        wire_gts=self.wire_gts)
                    if self.device_shards > 1:
                        s["aug_idx"] = np.int32(int(i) % self.shard_len)
                    samples.append(s)
                step_global += 1
                if not self._put(pack_batch(samples)):
                    return
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            item = self._queue.get()
            if isinstance(item, _Failed):
                raise item.exc
            yield item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=_CLOSE_WAIT_S)
