"""Detector.mesh on the port (one process driving several devices,
detect_batch's rows split over them), on the CPU, r04 EMA params:

  * over [cpu] * 2 and [cpu] * 4, with device and host NMS, f32 and bf16,
    unfused and fused: equal detection counts and JAX's sharded tolerances
    (tests/test_detect.py: rtol 1e-5, atol 1e-4 on boxes, 1e-3 on kps)
    against the unsharded call;
  * against yunet_tpu's Detector.mesh on its 8 virtual CPU devices (f32,
    device NMS): the detection counts equal and the rows within the port's
    f32 tolerance of tests/test_torch_detect.py (rtol 1e-4, atol 1e-3);
  * a detector holding only a folded tree shards it the same way;
  * a batch that is not a multiple of the mesh size runs on self.device,
    the sweep reaches the sharded path through detect_batch, the
    saturation count sums over the shards, the replicas are cached and
    dropped when mesh is set again.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.eval.detect import Detector as JaxDetector
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.eval.detect import Detector
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype(np.uint8)


IMGS = [_img(64, 96, seed=50 + i) for i in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: these tests share the CPU with the other test
    workers, some of whose subprocesses have deadlines."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def r04():
    params, state = load_flat_npz(FIXTURE, jax_yunet_n().model)
    return params, state, state_dict_from_jax(params, state)


def _close(got, want, *, rtol, box_atol, kps_atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["bboxes"].shape == w["bboxes"].shape
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=rtol,
                                   atol=box_atol)
        np.testing.assert_allclose(g["kps"], w["kps"], rtol=rtol,
                                   atol=kps_atol)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("use_device_nms", [True, False])
@pytest.mark.parametrize("dtype,fused", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.float32, True)])
def test_sharded_matches_unsharded(r04, n_dev, use_device_nms, dtype,
                                   fused):
    det = Detector(yunet_n(), r04[2], device="cpu", dtype=dtype, fused=fused)
    want = det.detect_batch(IMGS, mode=(96, 64), score_thr=0.02,
                            use_device_nms=use_device_nms)
    det.mesh = ["cpu"] * n_dev
    got = det.detect_batch(IMGS, mode=(96, 64), score_thr=0.02,
                           use_device_nms=use_device_nms)
    assert len(det._replicas) == n_dev
    assert sum(len(r["bboxes"]) for r in got) > 0
    _close(got, want, rtol=1e-5, box_atol=1e-4, kps_atol=1e-3)


def test_sharded_matches_jax_mesh(r04):
    params, state, sd = r04
    jdet = JaxDetector(jax_yunet_n(), params, state, bf16=False)
    jdet.mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    want = jdet.detect_batch(IMGS, mode=(96, 64), score_thr=0.02,
                             use_device_nms=True)
    for n_dev in (2, 4):
        det = Detector(yunet_n(), sd, device="cpu", dtype=torch.float32)
        det.mesh = [torch.device("cpu")] * n_dev
        got = det.detect_batch(IMGS, mode=(96, 64), score_thr=0.02,
                               use_device_nms=True)
        _close(got, want, rtol=1e-4, box_atol=1e-3, kps_atol=1e-3)
        assert det.last_devnms_saturated == jdet.last_devnms_saturated


def test_sharded_folded_tree(r04):
    """A detector that holds only a folded tree (as from an ONNX import)
    shards it too: a replica of the tree on each device."""
    from yunet_tpu_torch.models.detector import YuNet
    from yunet_tpu_torch.models.fused import fold_inference_params
    model = YuNet(yunet_n().model, device="cpu")
    model.load_state_dict(r04[2])
    det = Detector(yunet_n(), folded=fold_inference_params(
        model, yunet_n().model), device="cpu", dtype=torch.float32)
    want = det.detect_batch(IMGS, mode=(96, 64), use_device_nms=True)
    det.mesh = ["cpu"] * 2
    got = det.detect_batch(IMGS, mode=(96, 64), use_device_nms=True)
    assert len(det._replicas) == 2 and det._replicas[0].model is None
    _close(got, want, rtol=1e-5, box_atol=1e-4, kps_atol=1e-3)


def test_mesh_edges(r04):
    det = Detector(yunet_n(), r04[2], device="cpu", dtype=torch.float32)
    det.mesh = ["cpu"] * 4
    # 3 rows: not a multiple of 4, no replica is made
    det.detect_batch(IMGS[:3], mode=(96, 64), use_device_nms=True)
    assert det._replicas == {}
    # the sweep: 7 images in ladder chunks 4 + 2 + 1, the 4 sharded
    outs = det.detect_sweep([((lambda i=i: i), (64, 96)) for i in IMGS[:7]],
                            (96, 64), batch_size=4, use_device_nms=True)
    assert len(outs) == 7 and len(det._replicas) == 4
    ref = Detector(yunet_n(), r04[2], device="cpu", dtype=torch.float32)
    want = ref.detect_sweep([((lambda i=i: i), (64, 96)) for i in IMGS[:7]],
                            (96, 64), batch_size=4, use_device_nms=True)
    _close(outs, want, rtol=1e-5, box_atol=1e-4, kps_atol=1e-3)
    # a top-k cap of 4 saturates every image: the count sums the shards
    det.detect_batch(IMGS, mode=(96, 64), use_device_nms=True,
                     device_nms_top_k=4)
    assert det.last_devnms_saturated == 8
    det.mesh = ["cpu"] * 2
    assert det._replicas == {}
    det.mesh = None
    with pytest.raises(ValueError):
        det.mesh = []
