"""The program's spans (``yunet_tpu_torch/utils/profiling.py:span``) on the
CPU: with no profiler a span is one shared no-op; ``laps`` reads the
clock once a stage boundary; under torch.profiler a fused Detector's
detect on the r04 weights writes its stage spans to the chrome trace, in
order, each inside its call's span, with the 29 K4 wrapper spans inside
the trunk and the NMS kernel's span inside ``yunet.nms``, and
detect_batch the stage spans of the code it shares with detect;
``detect(timings=...)`` keeps its keys, each its stages' spans' host
time; every kernel wrapper with a span records it on its plain branch;
``trace_profile.report`` prints the spans' block only for a trace that
holds spans."""

import collections
import gzip
import itertools
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from yunet_tpu_torch.apis import init_detector
from yunet_tpu_torch.utils import profiling
from yunet_tpu_torch.utils.trace_profile import report, span_totals

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")
STAGES = ("yunet.letterbox", "yunet.upload", "yunet.trunk", "yunet.decode",
          "yunet.nms", "yunet.host_nms", "yunet.readback", "yunet.result")
# the spans of each timings key, in the keys' order
KEY_SPANS = {"preproc": ("yunet.letterbox",), "put": ("yunet.upload",),
             "dispatch": ("yunet.trunk", "yunet.decode", "yunet.nms"),
             "device_readback": ("yunet.readback",),
             "post": ("yunet.host_nms", "yunet.result")}


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def det():
    return init_detector("yunet_n", FIXTURE, device="cpu",
                         dtype=torch.float32, fused=True)


def _traced(tmp_path, fn):
    """fn() under ``profiling.trace``; returns its result and the trace's
    yunet.* spans as (name, start us, end us) in start order."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    (path,) = tmp_path.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "cpu_op"
             and e["name"].startswith("yunet.")]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_one_shared_noop():
    assert not autograd_profiler._is_profiler_enabled
    off = profiling.span("yunet.trunk")
    assert off is profiling.span("yunet.k4")
    assert profiling.laps(None)("put") == ""        # no dict: a no-op
    with off:
        with off:                               # nests
            pass
    with pytest.raises(KeyError, match="passes"):
        with off:
            raise KeyError("passes")


def test_span_records_only_under_profiler(tmp_path):
    with profiling.span("yunet.before"):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("yunet.outer"):
            with profiling.span("yunet.inner"):
                torch.ones(4).sum()
    with profiling.span("yunet.after"):
        pass
    assert span_totals(str(tmp_path))[1] == {"yunet.outer": 1,
                                             "yunet.inner": 1}


@pytest.mark.parametrize("calls", [1, 2])
def test_stage_adds_host_seconds(monkeypatch, calls):
    """Each lap sets its key to the seconds since the previous lap: one
    clock read a boundary, shared by the stages on either side."""
    reads = itertools.count()
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: 10.0 + 0.25 * next(reads) ** 2)
    timings = {"put": 1.0}
    lap = profiling.laps(timings)
    keys = ("put", "dispatch")[:calls]
    for key in keys:
        lap(key)
    assert next(reads) == calls + 1
    assert timings == dict(zip(keys, (0.25, 0.75)))    # "put" overwritten


@pytest.mark.parametrize("use_device_nms", [False, True])
def test_detect_stage_spans(det, tmp_path, use_device_nms):
    timings = {}
    _, spans = _traced(tmp_path, lambda: det.detect(
        _img(64, 96, 11), use_device_nms=use_device_nms, timings=timings))
    (call,) = [s for s in spans if s[0] == "yunet.detect"]
    assert all(_inside(s, call) for s in spans)
    stages = [s for s in spans if s[0] in STAGES]
    want = ["yunet.letterbox", "yunet.upload", "yunet.trunk", "yunet.decode"]
    want += (["yunet.nms", "yunet.readback"] if use_device_nms else
             ["yunet.readback", "yunet.host_nms"])
    assert [s[0] for s in stages] == want + ["yunet.result"]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    (trunk,) = [s for s in stages if s[0] == "yunet.trunk"]
    k4 = [s for s in spans if s[0] == "yunet.k4"]
    assert len(k4) == 29 and all(_inside(s, trunk) for s in k4)
    kernel = [s for s in spans if s[0] == "yunet.nms_kernel"]
    if use_device_nms:
        (nms,) = [s for s in stages if s[0] == "yunet.nms"]
        assert len(kernel) == 1 and _inside(kernel[0], nms)
    else:
        assert kernel == []
    # timings: JAX's five keys, each the host time of its stages' spans
    # (two clocks: the stage's clock reads enclose its spans)
    assert tuple(timings) == tuple(KEY_SPANS)
    for key, names in KEY_SPANS.items():
        us = sum(s[2] - s[1] for s in stages if s[0] in names)
        assert 0 < us <= timings[key] * 1e6 + 50
        assert timings[key] == pytest.approx(us / 1e6, abs=1e-3)


@pytest.mark.parametrize("use_device_nms", [False, True])
def test_detect_batch_stage_spans(det, tmp_path, use_device_nms):
    imgs = [_img(64, 96, 12), _img(50, 70, 13)]
    _, spans = _traced(tmp_path, lambda: det.detect_batch(
        imgs, "AUTO", use_device_nms=use_device_nms))
    # the stages it shares with detect (_input, raw, serve_packed); no
    # tool or cell reads a span of detect_batch's own
    assert not [s for s in spans if s[0] == "yunet.detect"]
    want = ["yunet.upload", "yunet.trunk", "yunet.decode"]
    want += ["yunet.nms"] if use_device_nms else []
    assert [s[0] for s in spans if s[0] in STAGES] == want
    # the batched program runs the folded units on the library convs
    assert not [s for s in spans if s[0] == "yunet.k4"]
    assert len([s for s in spans if s[0] == "yunet.nms_kernel"]) == \
        int(use_device_nms)


def test_detect_timings_without_profiler(det):
    """Spans off: the same five keys, each a share of the call's wall."""
    timings = {"preproc": 99.0, "stale": 1.0}
    t0 = time.perf_counter()
    det.detect(_img(64, 96, 11), use_device_nms=True, timings=timings)
    wall = time.perf_counter() - t0
    assert set(timings) == set(KEY_SPANS) | {"stale"}
    assert all(timings[k] > 0 for k in KEY_SPANS)
    assert sum(timings[k] for k in KEY_SPANS) <= wall


def _unit(cin, cout, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(cin, cout, generator=g) / cin ** 0.5,
            torch.randn(cout, generator=g), torch.randn(9, cout, generator=g),
            torch.randn(cout, generator=g))


def _call_k4():
    from yunet_tpu_torch.ops.convdp import fused_conv_dp
    w1, b1, wd, bd = _unit(4, 8)
    fused_conv_dp(torch.randn(1, 6, 5, 4), w1, b1, wd.reshape(3, 3, 1, 8),
                  bd)


def _call_nms_kernel():
    from yunet_tpu_torch.ops.nms import greedy_nms_keep
    xy = torch.rand(2, 7, 2) * 10
    greedy_nms_keep(torch.cat([xy, xy + 3], -1),
                    torch.tensor([7, 4], dtype=torch.int32), 0.45)


def _call_k1():
    from yunet_tpu_torch.ops.simota import streamed_simota
    b, p, g = 1, 12, 2
    pri = torch.rand(p, 2) * 32
    priors = torch.cat([pri, torch.full((p, 2), 8.0)], -1)
    decoded = torch.cat([pri - 4, pri + 4], -1)[None]
    gt = torch.tensor([[[2.0, 2.0, 20.0, 20.0], [10.0, 10.0, 30.0, 30.0]]])
    streamed_simota(torch.rand(b, p), priors, decoded, gt,
                    torch.ones(b, g), torch.ones(b, g, dtype=torch.bool),
                    k=4)


@pytest.mark.parametrize("name,call", [
    ("yunet.k4", _call_k4), ("yunet.nms_kernel", _call_nms_kernel),
    ("yunet.k1", _call_k1)])
def test_kernel_wrapper_span(tmp_path, name, call):
    _, spans = _traced(tmp_path, call)
    assert [s[0] for s in spans] == [name]


@pytest.mark.parametrize("with_spans", [False, True])
def test_report_spans_block(det, tmp_path, capsys, with_spans):
    img = _img(64, 96, 11)
    with profiling.trace(str(tmp_path)):
        if with_spans:
            det.detect(img, use_device_nms=True)
            det.detect(img, use_device_nms=True)
        else:
            torch.ones(8).sum()
    spans = span_totals(str(tmp_path))
    report(collections.Counter({"k": 2.0}), collections.Counter({"k": 2}),
           steps=2, spans=spans)
    out = capsys.readouterr().out.splitlines()
    if not with_spans:
        assert spans == ({}, {}) and "spans (host time):" not in out
        return
    assert spans[1]["yunet.k4"] == 58 and spans[1]["yunet.detect"] == 2
    at = out.index("spans (host time):")
    rows = out[at + 1:]
    assert len(rows) == len(spans[0])
    assert rows[0].endswith(" yunet.detect")     # the call holds the rest
    (k4,) = [r for r in rows if r.endswith(" yunet.k4")]
    assert k4 == (f"{spans[0]['yunet.k4'] / 2 / 1e3:9.3f} ms/step  "
                  f"x{29:<5d} yunet.k4")
