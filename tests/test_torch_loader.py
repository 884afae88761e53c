"""The port's TrainLoader against yunet_tpu's on the same split and seed
(equal batches, with and without worker processes, over two epochs, and
after a resume at start_step), shard disjointness across processes, and
device_prefetch on the CPU (order kept, tensors equal to the host
batches, a producer's exception raised by the consumer)."""

import numpy as np
import pytest
import torch

from test_torch_data import make_train_split
from yunet_tpu.data import loader as jld
from yunet_tpu.data.dataset import SampleSpec as JaxSpec
from yunet_tpu_torch.data import loader as tld
from yunet_tpu_torch.data.dataset import SampleSpec

BATCH, STEPS_PER_EPOCH = 2, 4     # 8 images


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return make_train_split(str(tmp_path_factory.mktemp("loader_split")))


def _batches(mod, spec, split, n, **kw):
    ann, prefix, cache = split
    loader = mod.TrainLoader(ann, prefix, batch_size=BATCH, spec=spec,
                             decoded_cache=cache, seed=5, **kw)
    try:
        assert loader.steps_per_epoch == STEPS_PER_EPOCH
        it = iter(loader)
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_equals_jax(split, workers):
    """Two epochs (8 batches) equal to JAX's TrainLoader's, the JAX one in
    one process."""
    spec = dict(img_size=96, max_gts=16)
    got = _batches(tld, SampleSpec(**spec), split, 2 * STEPS_PER_EPOCH,
                   num_workers=workers)
    want = _batches(jld, JaxSpec(**spec), split, 2 * STEPS_PER_EPOCH,
                    num_workers=0)
    _same(got, want)
    # epochs reshuffle: the second epoch is not the first again
    assert not all(np.array_equal(a["image"], b["image"])
                   for a, b in zip(got[:4], got[4:]))


@pytest.mark.parametrize("start", [3, 6])
def test_start_step_resumes_the_stream(split, start):
    spec = SampleSpec(img_size=96, max_gts=16)
    full = _batches(tld, spec, split, start + 2, num_workers=0)
    resumed = _batches(tld, spec, split, 2, num_workers=0, start_step=start)
    _same(resumed, full[start:])
    _same(resumed, _batches(jld, JaxSpec(img_size=96, max_gts=16), split, 2,
                            num_workers=0, start_step=start))


def test_processes_get_disjoint_shards(split):
    ann, prefix, cache = split
    spec = SampleSpec(img_size=96, max_gts=16)
    shards = []
    for pidx in range(2):
        loader = tld.TrainLoader(ann, prefix, batch_size=BATCH, spec=spec,
                                 num_workers=0, seed=5, decoded_cache=cache,
                                 process_index=pidx, process_count=2)
        jloader = jld.TrainLoader(ann, prefix, batch_size=BATCH,
                                  spec=JaxSpec(img_size=96, max_gts=16),
                                  num_workers=0, seed=5, decoded_cache=cache,
                                  process_index=pidx, process_count=2)
        try:
            assert loader.steps_per_epoch == 2
            for epoch in (0, 1):
                np.testing.assert_array_equal(loader._epoch_indices(epoch),
                                              jloader._epoch_indices(epoch))
            shards.append(loader._epoch_indices(0))
            _same([next(iter(loader))], [next(iter(jloader))])
        finally:
            loader.close()
            jloader.close()
    a, b = (set(s.ravel().tolist()) for s in shards)
    assert not a & b and len(a | b) == 8


def test_worker_exception_reaches_the_consumer(split, tmp_path):
    """A sample that cannot load raises in the consumer instead of leaving
    it waiting on an empty queue."""
    ann, _, _ = split
    loader = tld.TrainLoader(ann, str(tmp_path / "no_images"),
                             batch_size=BATCH, num_workers=0,
                             spec=SampleSpec(img_size=96, max_gts=16))
    try:
        with pytest.raises(FileNotFoundError):
            next(iter(loader))
    finally:
        loader.close()


def test_device_prefetch_on_cpu_keeps_order():
    rng = np.random.RandomState(0)
    host = [{"image": rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
             "gt_valid": rng.uniform(size=(2, 4)) < 0.5,
             "num_overflow": np.arange(2, dtype=np.int32) + i}
            for i in range(7)]
    got = list(tld.device_prefetch(iter(host), device="cpu", depth=2))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert sorted(g) == sorted(h)
        for k, v in h.items():
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), v)


def test_device_prefetch_raises_the_producers_exception():
    def batches():
        yield {"x": np.zeros(3, np.float32)}
        raise RuntimeError("producer failed")
    it = tld.device_prefetch(batches(), device="cpu")
    assert next(it)["x"].shape == (3,)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
