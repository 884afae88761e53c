"""Multi-process training input pipeline with device prefetch — a copy of
``yunet_tpu/data/loader.py`` (reference torch DataLoader +
DistributedGroupSampler, datasets/builder.py:94-206,
samplers/group_sampler.py):

  * a forked worker pool crops, resizes and flips images (processes
    sidestep the GIL);
  * per-epoch deterministic shuffling from a seed, with per-sample
    RandomState streams, so batches do not depend on worker scheduling;
  * each process pulls only its own shard of the global batch;
  * ``device_prefetch`` stages batches onto the card on a side CUDA stream
    while the step runs.

The workers touch numpy and CPU torch only: the pool may fork a parent
that has already initialised CUDA (a CUDA call in a child raises), and
torch's OpenMP pool is not fork-safe, so each worker runs torch on one
thread. Aspect-ratio grouping is dropped as in JAX: every sample is
cropped square and resized to one size.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .dataset import SampleSpec, WiderFaceDataset, pack_batch

_worker_dataset: Optional[WiderFaceDataset] = None
# close() waits this long for the batch under way (a batch takes seconds)
_CLOSE_WAIT_S = 120.0


def _worker_init(ann_file, img_prefix, spec, min_size,
                 decoded_cache=None, reduced_decode=False):
    global _worker_dataset
    torch.set_num_threads(1)  # one process = one stream of resize work
    _worker_dataset = WiderFaceDataset(
        ann_file, img_prefix, spec, min_size=min_size,
        decoded_cache=decoded_cache, reduced_decode=reduced_decode)


def _sample(dataset, args):
    idx, seed = args
    return dataset.get_train_sample(idx, np.random.RandomState(seed))


def _worker_sample(args):
    return _sample(_worker_dataset, args)


class _Failed:
    """A producer's exception, handed to the consumer to raise."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class TrainLoader:
    """Infinite epoch-shuffled loader yielding fixed-shape host batches.

    An exception in a worker or the producer (a missing image, say) is
    raised by the iterator rather than leaving it waiting."""

    def __init__(self, ann_file: str, img_prefix: str, *,
                 batch_size: int, spec: SampleSpec,
                 num_workers: int = 4, seed: int = 0,
                 min_size: Optional[float] = None,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, start_step: int = 0,
                 decoded_cache: Optional[str] = None,
                 reduced_decode: bool = False):
        self.dataset = WiderFaceDataset(
            ann_file, img_prefix, spec, min_size=min_size,
            decoded_cache=decoded_cache, reduced_decode=reduced_decode)
        self.batch_size = batch_size          # per-process batch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.spec = spec
        self._pool = None
        if num_workers > 0:
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(
                num_workers, initializer=_worker_init,
                initargs=(ann_file, img_prefix, spec, min_size,
                          decoded_cache, reduced_decode))
        self._start_step = start_step
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    @property
    def steps_per_epoch(self) -> int:
        global_batch = self.batch_size * self.process_count
        return max(len(self.dataset) // global_batch, 1)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + epoch)
        idx = rng.permutation(len(self.dataset))
        global_batch = self.batch_size * self.process_count
        usable = (len(idx) // global_batch) * global_batch
        idx = idx[:usable].reshape(-1, self.process_count, self.batch_size)
        return idx[:, self.process_index, :]  # (steps, per-process batch)

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
        # resume mid-training at the right epoch/step (the DataLoader
        # counterpart of DistSamplerSeedHook's epoch-seeded reshuffle)
        epoch = self._start_step // self.steps_per_epoch
        skip = self._start_step % self.steps_per_epoch
        step_global = self._start_step
        while not self._stop.is_set():
            batches = self._epoch_indices(epoch)
            if skip:
                batches = batches[skip:]
                skip = 0
            for batch_idx in batches:
                if self._stop.is_set():
                    return
                # seed by GLOBAL batch position (process shard offset +
                # local slot) so processes draw independent augmentation
                # streams; mod 2^32: numpy seeds are bounded and the
                # stride overflows past step ~4294
                off = self.process_index * self.batch_size
                seeds = [(int(i),
                          (self.seed + 1000003 * step_global + off + j)
                          % (2 ** 32))
                         for j, i in enumerate(batch_idx)]
                if self._pool is not None:
                    samples = self._pool.map(_worker_sample, seeds)
                else:
                    samples = [_sample(self.dataset, s) for s in seeds]
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
        # let the producer finish the batch under way first: terminating
        # a pool while its workers send back results can deadlock, and
        # sampling in this process must not run on after close (a pool
        # forked later must not copy a thread inside torch's OpenMP region)
        self._thread.join(timeout=_CLOSE_WAIT_S)
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()


def device_prefetch(iterator, *, device, depth: int = 2):
    """Stage host batches (dicts of numpy arrays) onto ``device`` ahead of
    consumption; yields dicts of tensors on ``device``.

    A staging thread turns each batch into tensors. For a CUDA device it
    pins them and copies them with ``non_blocking=True`` on a side stream
    of its own, so the copy overlaps the step; the consumer's current
    stream then waits for that copy before the batch is handed out, and
    each tensor is marked used by that stream (``record_stream``) so its
    memory is not reused while the step still reads it. On the CPU it
    only makes the tensors. An exception in the iterator or the copy is
    raised by the consumer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device=device) if cuda else None

    def _stage(batch):
        tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in
                   batch.items()}
        if not cuda:
            return tensors, None
        with torch.cuda.stream(side):
            staged = {k: t.pin_memory().to(device, non_blocking=True)
                      for k, t in tensors.items()}
            done = torch.cuda.Event()
            done.record(side)
        return staged, done

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _run():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                _put(_stage(batch))
            _put(_END)
        except Exception as e:  # handed to the consumer, which raises it
            _put(_Failed(e))

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    try:
        while True:
            out = q.get()
            if out is _END:
                return
            if isinstance(out, _Failed):
                raise out.exc
            staged, done = out
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for v in staged.values():
                    v.record_stream(stream)
            yield staged
    finally:
        stop.set()
