"""The WIDER sweep engine: yunet_tpu_torch Detector.detect_sweep ==
yunet_tpu Detector.detect_sweep at f32 (``bf16=False`` against
``dtype=torch.float32``) on the r04 EMA params, fused or not, host or
device NMS, over a set-up with two canvas groups, a remainder (5 images at
batch_size=4 -> 4 + 1) and one stale size hint (a solo detect).
Detections agree within test_torch_detect.py's tolerance (rtol 1e-4, atol
1e-3); ``last_sweep_stats`` is equal. Also detect_tta, warmup and
bbox2result against JAX's."""

import logging
import os

import numpy as np
import pytest
import torch

from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.eval.detect import Detector as JaxDetector
from yunet_tpu.eval.detect import bbox2result as jax_bbox2result
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.eval.detect import Detector, bbox2result
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def detectors():
    """{fused: (jax Detector, port Detector)}, f32, on the r04 params."""
    params, state = load_flat_npz(FIXTURE, jax_yunet_n().model)
    sd = state_dict_from_jax(params, state)
    return {fused: (JaxDetector(jax_yunet_n(), params, state, bf16=False,
                                fused=fused),
                    Detector(yunet_n(), sd, device=torch.device("cpu"),
                             dtype=torch.float32, fused=fused))
            for fused in (False, True)}


def _entries(mode):
    """Seven images: five landscape (one group, 4 + 1 at batch_size=4),
    two portrait (the other group) and, last, a portrait image whose hint
    says landscape (it runs solo). For ORIGIN the groups are the /32
    buckets 64x96 and 96x64."""
    land = [(64, 96), (60, 90), (50, 80), (64, 70), (41, 96)]
    port = [(96, 64), (90, 50)]
    imgs = [_img(h, w, 30 + i) for i, (h, w) in enumerate(land + port)]
    stale = _img(96, 60, 40)
    entries = [((lambda im=im: im), im.shape[:2]) for im in imgs]
    entries.append(((lambda: stale), (60, 96)))
    return entries


def _same(got, want):
    assert got["bboxes"].shape == want["bboxes"].shape
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["kps"], want["kps"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got["labels"], want["labels"])


@pytest.mark.parametrize("fused,mode", [(False, (96, 64)),
                                        (False, "ORIGIN"),
                                        (True, (96, 64))])
@pytest.mark.parametrize("use_device_nms", [False, True])
def test_detect_sweep_matches_jax(detectors, fused, mode, use_device_nms):
    jdet, tdet = detectors[fused]
    kw = dict(batch_size=4, use_device_nms=use_device_nms, score_thr=0.05)
    seen = []
    want = jdet.detect_sweep(_entries(mode), mode, **kw)
    got = tdet.detect_sweep(_entries(mode), mode,
                            on_result=lambda i, r: seen.append(i), **kw)
    assert len(got) == len(want) == 8
    assert sorted(seen) == list(range(8))
    assert sum(r["bboxes"].shape[0] for r in want) > 0
    for g, w in zip(got, want):
        _same(g, w)
    assert tdet.last_sweep_stats == jdet.last_sweep_stats
    assert tdet.last_sweep_stats == {"images": 8, "misfit_solo": 1,
                                     "batches": 3, "devnms_saturated": 0}


def test_detect_sweep_prefetch_and_order(detectors, caplog):
    """prefetch on and off give the same results in input order; the stale
    hint logs the solo warning. caplog's handler is attached to the
    package logger itself: a test run earlier in the same process may have
    set it to propagate=False (utils/logging.py:get_logger), which hides
    its records from the root logger caplog listens on (the fix of
    tests/test_detect.py's order-dependent flake)."""
    _, tdet = detectors[False]
    mode = (96, 64)
    logger = logging.getLogger("yunet_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="yunet_tpu_torch"):
            on = tdet.detect_sweep(_entries(mode), mode, batch_size=4)
    finally:
        logger.removeHandler(caplog.handler)
    off = tdet.detect_sweep(_entries(mode), mode, batch_size=4,
                            prefetch=False)
    solo = tdet.detect(_entries(mode)[-1][0](), mode=mode)
    for a, b in zip(on, off):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for k in solo:
        np.testing.assert_array_equal(on[-1][k], solo[k])
    assert "stale size hints" in caplog.text


def test_detect_sweep_ladder_matches_jax(detectors):
    """17 same-canvas images at batch_size=16 run as 16 + 1 (no padding
    with copies); 7 at batch_size=8 as 4 + 2 + 1."""
    jdet, tdet = detectors[False]
    for n, bs, batches in ((17, 16, 2), (7, 8, 3)):
        ents = [((lambda s=s: _img(32, 32, s)), (32, 32)) for s in range(n)]
        want = jdet.detect_sweep(ents, "AUTO", batch_size=bs)
        got = tdet.detect_sweep(ents, "AUTO", batch_size=bs)
        for g, w in zip(got, want):
            _same(g, w)
        assert tdet.last_sweep_stats == jdet.last_sweep_stats
        assert tdet.last_sweep_stats["batches"] == batches


@pytest.mark.parametrize("fused", [False, True])
def test_detect_tta_matches_jax(detectors, fused):
    jdet, tdet = detectors[fused]
    img = _img(80, 120, 7)
    for scales, flip in ((((96, 64),), True), (((96, 64), (64, 64)), False)):
        want = jdet.detect_tta(img, scales=scales, flip=flip, score_thr=0.05)
        got = tdet.detect_tta(img, scales=scales, flip=flip, score_thr=0.05)
        assert want["bboxes"].shape[0] > 0
        _same(got, want)


def test_warmup_runs_detect(detectors, monkeypatch):
    _, tdet = detectors[True]
    calls = []
    orig = tdet.detect
    monkeypatch.setattr(tdet, "detect", lambda img, **kw: calls.append(
        (img.shape, kw)) or orig(img, **kw))
    tdet.warmup([(64, 96), (32, 32)])
    assert calls == [((64, 96, 3), {"mode": "AUTO"}),
                     ((32, 32, 3), {"mode": "AUTO"})]


def test_bbox2result_matches_jax():
    rng = np.random.RandomState(0)
    bb = rng.uniform(0, 100, (9, 5)).astype(np.float32)
    labels = rng.randint(0, 3, 9)
    for args in ((bb, labels, 3), (bb[:0], labels[:0], 2)):
        got, want = bbox2result(*args), jax_bbox2result(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

