"""The serving slice end to end: yunet_tpu_torch Detector == yunet_tpu
Detector(bf16=False) on the r04 EMA params, 64x96 AUTO canvas, f32 on the
CPU — fused or not, host or device NMS, through detect and detect_batch.
Boxes and keypoints agree within 1e-3 (f32 trunks summed in different
orders); the detection counts are equal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.eval.detect import Detector as JaxDetector
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.ops.nms_pallas import pallas_nms_batched
from yunet_tpu_torch.apis import inference_detector, init_detector
from yunet_tpu_torch.eval.detect import Detector, resize_img
from yunet_tpu_torch.ops.nms import device_nms_batched
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def r04():
    params, state = load_flat_npz(FIXTURE, jax_yunet_n().model)
    return params, state, state_dict_from_jax(params, state)


@pytest.fixture(scope="module")
def detectors(r04):
    """{fused: (jax Detector, port Detector)} on the r04 params."""
    params, state, sd = r04
    cfg = jax_yunet_n()
    from yunet_tpu_torch.config import yunet_n
    return {fused: (JaxDetector(cfg, params, state, bf16=False, fused=fused),
                    Detector(yunet_n(), sd, device=torch.device("cpu"),
                             dtype=torch.float32, fused=fused))
            for fused in (False, True)}


def _same(got, want):
    assert got["bboxes"].shape == want["bboxes"].shape
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["kps"], want["kps"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got["labels"], want["labels"])


@pytest.mark.parametrize("use_device_nms", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_detect_matches_jax(detectors, fused, use_device_nms):
    jdet, tdet = detectors[fused]
    img = _img(64, 96, 11)
    want = jdet.detect(img, use_device_nms=use_device_nms)
    got = tdet.detect(img, use_device_nms=use_device_nms)
    assert want["bboxes"].shape[0] > 0
    _same(got, want)


@pytest.mark.parametrize("use_device_nms", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_detect_batch_matches_jax(detectors, fused, use_device_nms):
    jdet, tdet = detectors[fused]
    imgs = [_img(64, 96, 12), _img(50, 70, 13)]      # the 2nd is padded
    want = jdet.detect_batch(imgs, "AUTO", use_device_nms=use_device_nms)
    got = tdet.detect_batch(imgs, "AUTO", use_device_nms=use_device_nms)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, w)
    if use_device_nms:
        assert tdet.last_devnms_saturated == jdet.last_devnms_saturated


def test_detect_rescaled_canvas_matches_jax(detectors):
    """A fixed canvas resizes the image (cv2, as in JAX) and maps the
    detections back to original coordinates."""
    jdet, tdet = detectors[False]
    img = _img(100, 150, 14)
    want = jdet.detect(img, mode=(96, 64), score_thr=0.01)
    got = tdet.detect(img, mode=(96, 64), score_thr=0.01)
    assert want["bboxes"].shape[0] > 0
    _same(got, want)


def test_device_nms_keep_equal_on_jax_raw_outputs():
    """Fed the same raw outputs (JAX random init, ~126 detections an
    image), the port's device NMS and the Pallas kernel keep the same
    boxes."""
    cfg = jax_yunet_n()
    import jax
    params, state = JaxYuNet(cfg.model).init(jax.random.PRNGKey(0))
    jdet = JaxDetector(cfg, params, state, bf16=False)
    raw = jdet._raw_fn(64, 96)
    outs = [raw(jdet.params, jdet.state,
                _img(64, 96, s)[None].astype(np.float32)) for s in (1, 2)]
    scores = np.stack([np.asarray(o[0]) for o in outs])
    boxes = np.stack([np.asarray(o[1]) for o in outs])
    want = pallas_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                              top_k=750, iou_thr=0.45, score_thr=0.02)
    got = device_nms_batched(torch.from_numpy(boxes),
                             torch.from_numpy(scores), top_k=750)
    assert np.asarray(want[1]).sum(1).min() > 50
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_detector_and_inference_detector():
    det = init_detector("yunet_n", FIXTURE, device="cpu",
                        dtype=torch.float32)
    img = _img(64, 96, 11)
    one = inference_detector(det, img)
    two = inference_detector(det, [img, img])
    _same(one, two[1])
    timings = {}
    _same(det.detect(img, timings=timings), one)
    assert set(timings) == {"preproc", "put", "dispatch", "device_readback",
                            "post"}
    assert all(v >= 0 for v in timings.values())
    # bf16 trunk: same detections within bf16 rounding
    det16 = init_detector("yunet_n", FIXTURE, device="cpu")
    assert det16.dtype == torch.bfloat16
    assert abs(det16.detect(img)["bboxes"].shape[0]
               - one["bboxes"].shape[0]) <= 1
    with pytest.raises(ValueError):
        det.detect(img, score_thr=0.001, use_device_nms=True)


@pytest.mark.parametrize("use_device_nms", [False, True])
def test_detect_timings_keys_match_jax(detectors, use_device_nms):
    """detect(timings=...) fills JAX's keys in both NMS branches."""
    jdet, tdet = detectors[False]
    img = _img(64, 96, 11)
    want, got = {}, {}
    jdet.detect(img, use_device_nms=use_device_nms, timings=want)
    tdet.detect(img, use_device_nms=use_device_nms, timings=got)
    assert set(got) == set(want) == {"preproc", "put", "dispatch",
                                     "device_readback", "post"}
    assert all(v >= 0 for v in got.values())


def test_init_detector_from_pth(tmp_path, r04):
    """A checkpoint in the reference layout ({"state_dict": ..., "meta":
    ...}, reference key names) loads by module name and detects as the
    .npz does."""
    _, _, sd = r04
    path = tmp_path / "yunet_n.pth"
    torch.save({"meta": {"epoch": 640}, "state_dict": sd}, str(path))
    img = _img(64, 96, 11)
    got = init_detector("yunet_n", str(path), device="cpu",
                        dtype=torch.float32).detect(img)
    want = init_detector("yunet_n", FIXTURE, device="cpu",
                         dtype=torch.float32).detect(img)
    np.testing.assert_array_equal(got["bboxes"], want["bboxes"])
    with pytest.raises(ValueError):
        init_detector("yunet_n", str(tmp_path / "x.ckpt"), device="cpu")


def test_resize_img_needs_no_cv2_when_sizes_match():
    img = _img(100, 150, 0)
    out, s = resize_img(img, "AUTO")
    assert out.shape == (128, 160, 3) and s == 1.0
    np.testing.assert_array_equal(out[:100, :150], img)
    out, s = resize_img(_img(320, 320, 0), (320, 320))
    assert out.shape == (320, 320, 3) and s == 1.0


def test_host_nms_source_is_the_jax_packages():
    """native.py builds the port's own copy of the host NMS source; the
    copy stays byte-equal to the JAX package's original."""
    from yunet_tpu_torch import native
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.SOURCE.startswith(os.path.join(root, "yunet_tpu_torch"))
    with open(native.SOURCE, "rb") as a, open(os.path.join(
            root, "yunet_tpu", "native", "yunet_ops.cpp"), "rb") as b:
        assert a.read() == b.read()
