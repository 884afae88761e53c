"""Which detect calls replay a CUDA graph (``Detector._graph_key``,
``_capture``, ``_prime``), on the CPU: the capture and the replay are a
stub here (``_record``), since a CPU has no CUDA graph, and the rule
(``_graph_key``) sees a CUDA device in place of the CPU. A key's first
call runs eagerly, its
second captures and runs the graph, later calls replay it; the canvas,
``max_dets`` and the input dtype are parts of the key; the least recently
used graph goes past ``_GRAPHS_KEPT``; a CPU, unfused or host-NMS detect
and ``detect_batch`` never capture; the wrappers' counters count the
launches a capture issues and nothing for a replay; a failed capture
raises and keeps no graph; the ``timings`` keys and the stage spans
around ``yunet.graph``."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.eval import detect as detect_mod
from yunet_tpu_torch.eval.detect import Detector
from yunet_tpu_torch.models.detector import YuNet
from yunet_tpu_torch.models.fused import fold_inference_params
from yunet_tpu_torch.ops.convdp import fused_conv_dp
from yunet_tpu_torch.ops.nms import greedy_nms_keep
from yunet_tpu_torch.utils import profiling
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")
# what the wrappers count while a yunet_n detect's program is captured
K4, K3 = 29, 2
KEYS = {"preproc", "put", "dispatch", "device_readback", "post"}
COUNTERS = ((fused_conv_dp, "launches"), (fused_conv_dp, "launches_mma"),
            (greedy_nms_keep, "launches"))


def _img(h, w, seed, dtype=np.uint8):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype(dtype)


@pytest.fixture(scope="module")
def model():
    cfg = yunet_n()
    m = YuNet(cfg.model, device=torch.device("cpu"))
    m.load_state_dict(state_dict_from_jax(*load_flat_npz(FIXTURE,
                                                         cfg.model)))
    return m.eval()


def _det(model, kind="fused"):
    cfg = yunet_n()
    if kind == "folded":
        return Detector(cfg, folded=fold_inference_params(model, cfg.model),
                        device="cpu", dtype=torch.float32)
    return Detector(cfg, model, device="cpu", dtype=torch.float32,
                    fused=kind == "fused")


class Stub:
    """``Detector._record`` on the CPU: counts the launches the wrappers
    count while they queue the program into a capture (the CPU's plain
    versions count none), runs it once for the static output, and returns
    a replay that runs it again on the static input, counting nothing, as
    no wrapper runs (``frozen``: a replay that does nothing)."""

    def __init__(self, frozen=False):
        self.records = 0
        self.frozen = frozen

    def __call__(self, det, x, top_k):
        self.records += 1
        fused_conv_dp.launches += K4
        fused_conv_dp.launches_mma += K4
        greedy_nms_keep.launches += K3
        packed = det.detect_packed(x, top_k)

        def replay():
            if not self.frozen:
                with torch.inference_mode():
                    packed.copy_(det.detect_packed(x, top_k))
        return replay, packed


@pytest.fixture
def counters(monkeypatch):
    """The wrappers' launch counters from zero, restored after."""
    for fn, attr in COUNTERS:
        monkeypatch.setattr(fn, attr, 0)
    return lambda: tuple(getattr(fn, attr) for fn, attr in COUNTERS)


def _on_cuda(monkeypatch):
    """``Detector._graph_key`` as it rules for a Detector on a CUDA
    device: the rule itself, shown a CUDA device in place of the CPU."""
    rule = Detector._graph_key

    def key(det, det_img, top_k):
        device, det.device = det.device, torch.device("cuda")
        try:
            return rule(det, det_img, top_k)
        finally:
            det.device = device
    monkeypatch.setattr(Detector, "_graph_key", key)


@pytest.fixture
def stub(monkeypatch):
    """The graph rule on the CPU, with Stub in place of the capture."""
    s = Stub()
    _on_cuda(monkeypatch)
    monkeypatch.setattr(Detector, "_record",
                        lambda det, x, top_k: s(det, x, top_k))
    return s


def _eager(model, img, **kw):
    """The result of the eager program: a new Detector's first call of a
    key."""
    return _det(model).detect(img, use_device_nms=True, **kw)


def _equal(got, want):
    for k in ("bboxes", "kps", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["fused", "folded"])
def test_capture_on_second_call_replay_after(model, stub, kind):
    """Call 1 eager, call 2 captures and runs the graph, calls 3-5 replay:
    each on its own image, whose upload the static input takes."""
    det = _det(model, kind)
    imgs = [_img(64, 96, s) for s in range(5)]
    seen = []
    for i, img in enumerate(imgs):
        got = det.detect(img, use_device_nms=True)
        seen.append((stub.records, det.graph_captures, det.graph_replays))
        _equal(got, _eager(model, img))
    assert seen == [(0, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3)]
    assert len(det._graphs) == 1 and not det._primed
    (graph,) = det._graphs.values()
    assert graph.x.shape == (1, 64, 96, 3)


def test_key_holds_canvas_max_dets_and_input_dtype(model, stub):
    det = _det(model)
    calls = [dict(img=_img(64, 96, 1)),
             dict(img=_img(64, 96, 1), max_dets=50),
             dict(img=_img(96, 64, 1)),
             dict(img=_img(64, 96, 1, np.float32))]
    for kw in calls:                       # each a new key: eager
        kw = dict(kw)
        det.detect(kw.pop("img"), use_device_nms=True, **kw)
    assert stub.records == det.graph_captures == 0
    assert len(det._primed) == 4
    for n, kw in enumerate(calls, 1):      # each key's second call
        kw = dict(kw)
        img = kw.pop("img")
        _equal(det.detect(img, use_device_nms=True, **kw),
               _eager(model, img, **kw))
        assert det.graph_captures == n
    assert det.graph_replays == 0
    assert {k[0][:2] for k in det._graphs} == {(64, 96), (96, 64)}
    assert {k[3] for k in det._graphs} == {50, det.cfg.test.device_nms_pre}
    assert {k[1] for k in det._graphs} == {np.dtype(np.uint8),
                                           np.dtype(np.float32)}


def test_least_recently_used_graph_goes_past_the_cap(model, stub):
    det = _det(model)
    cap = detect_mod._GRAPHS_KEPT
    shapes = [(32 * (i + 1), 64) for i in range(cap + 1)]
    for hw in shapes[:cap]:
        for _ in range(2):
            det.detect(_img(*hw, 3), use_device_nms=True)
    det.detect(_img(*shapes[0], 3), use_device_nms=True)   # replayed: used
    for _ in range(2):                          # the fifth evicts shapes[1]
        det.detect(_img(*shapes[cap], 3), use_device_nms=True)
    assert (det.graph_captures, det.graph_replays) == (cap + 1, 1)
    # least recently used first: shapes[0]'s replay moved it to the end
    assert [k[0][:2] for k in det._graphs] == \
        shapes[2:cap] + [shapes[0], shapes[cap]]
    # the evicted key starts over: eager, then a capture
    det.detect(_img(*shapes[1], 3), use_device_nms=True)
    assert det.graph_captures == cap + 1
    det.detect(_img(*shapes[1], 3), use_device_nms=True)
    assert det.graph_captures == cap + 2 and len(det._graphs) == cap


def test_keys_run_once_are_capped_too(model, stub):
    """One-off canvases (a sweep's solo images) hold at most
    _GRAPHS_KEPT keys and evict no graph."""
    det = _det(model)
    for _ in range(2):
        det.detect(_img(64, 64, 0), use_device_nms=True)
    for i in range(2 * detect_mod._GRAPHS_KEPT):
        det.detect(_img(32, 32 * (i + 3), 0), use_device_nms=True)
    assert len(det._primed) == detect_mod._GRAPHS_KEPT
    assert len(det._graphs) == 1 and det.graph_captures == 1


@pytest.mark.parametrize("case", ["cpu", "unfused", "host_nms",
                                  "detect_batch"])
def test_no_graph_off_the_path(model, monkeypatch, case):
    def refuse(*_):
        raise AssertionError("captured off the graph path")
    monkeypatch.setattr(Detector, "_record", refuse)
    if case != "cpu":                    # the rule's device check passes
        _on_cuda(monkeypatch)
    det = _det(model, "unfused" if case == "unfused" else "fused")
    img = _img(64, 96, 5)
    for _ in range(3):
        if case == "detect_batch":
            det.detect_batch([img], "AUTO", use_device_nms=True)
        else:
            det.detect(img, use_device_nms=case != "host_nms")
    assert (det.graph_captures, det.graph_replays) == (0, 0)
    assert not det._graphs and not det._primed


def test_capture_counts_its_launches_and_a_replay_none(model, stub,
                                                       counters):
    det = _det(model)
    img = _img(64, 96, 7)
    det.detect(img, use_device_nms=True)          # eager: the CPU's plain
    assert counters() == (0, 0, 0)                # versions count nothing
    det.detect(img, use_device_nms=True)          # capture + run
    assert stub.records == 1
    assert counters() == (K4, K4, K3)
    for n in (1, 2):
        det.detect(img, use_device_nms=True)      # replay: no wrapper runs
        assert counters() == (K4, K4, K3)
        assert det.graph_replays == n


def test_failed_capture_raises_and_keeps_no_graph(model, monkeypatch):
    records = []

    def fail(det, x, top_k):
        records.append(x.shape)
        raise RuntimeError("capture refused")
    _on_cuda(monkeypatch)
    monkeypatch.setattr(Detector, "_record", fail)
    det = _det(model)
    img = _img(64, 96, 8)
    det.detect(img, use_device_nms=True)
    for n in (1, 2):                    # the key stays primed: each later
        with pytest.raises(RuntimeError, match="capture refused"):
            det.detect(img, use_device_nms=True)   # call tries again
        assert len(records) == n
    assert det.graph_captures == 0 and not det._graphs


def test_timings_keys_unchanged_on_the_graph_path(model, stub):
    det = _det(model)
    img = _img(64, 96, 9)
    for _ in range(3):                            # eager, capture, replay
        timings = {}
        det.detect(img, use_device_nms=True, timings=timings)
        assert set(timings) == KEYS and all(v >= 0 for v in timings.values())
    assert (det.graph_captures, det.graph_replays) == (1, 1)


def _spans(tmp_path, fn):
    """The yunet.* spans of fn() under profiling.trace, as names in start
    order."""
    with profiling.trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("ph") == "X" and e.get("cat") == "cpu_op"
            and e["name"].startswith("yunet.")]


def test_replay_opens_the_graph_span_and_no_program_span(model, monkeypatch,
                                                         tmp_path):
    """On a replay nothing of the program runs on the host: the call's
    spans are the stages around one yunet.graph."""
    s = Stub(frozen=True)
    _on_cuda(monkeypatch)
    monkeypatch.setattr(Detector, "_record",
                        lambda det, x, top_k: s(det, x, top_k))
    det = _det(model)
    img = _img(64, 96, 10)
    for _ in range(2):
        det.detect(img, use_device_nms=True)
    got = _spans(tmp_path, lambda: det.detect(img, use_device_nms=True))
    assert got == ["yunet.detect", "yunet.letterbox", "yunet.upload",
                   "yunet.graph", "yunet.readback", "yunet.result"]
    _equal(det.detect(img, use_device_nms=True), _eager(model, img))


def test_no_key_runs_eagerly_past_a_kept_graph(model, stub, monkeypatch):
    """With ``_graph_key`` returning None (a caller that swaps a module
    function in) a key that holds a graph runs eagerly: no replay, no
    capture, nothing primed."""
    det = _det(model)
    img = _img(64, 96, 11)
    for _ in range(3):                            # eager, capture, replay
        det.detect(img, use_device_nms=True)
    monkeypatch.setattr(Detector, "_graph_key", lambda *_: None)
    for _ in range(2):
        _equal(det.detect(img, use_device_nms=True), _eager(model, img))
    assert (stub.records, det.graph_captures, det.graph_replays) == (1, 1, 1)
    assert len(det._graphs) == 1 and not det._primed
