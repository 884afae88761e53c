"""Which detect calls replay a CUDA graph (``Detector._graph_key``,
``_capture``, ``_prime``), on the CPU: the capture and the replay are a
stub here (``_record``), since a CPU has no CUDA graph, and the rule
(``_graph_key``) sees a CUDA device in place of the CPU. A key's first
call runs eagerly, its
second captures and runs the graph, later calls replay it; the canvas,
``max_dets`` and the input dtype are parts of the key; the least recently
used graph goes past ``_GRAPHS_KEPT``, its stage with it; a CPU, unfused
or host-NMS detect and ``detect_batch`` never capture; the wrappers'
counters count the launches a capture issues and nothing for a replay; a
failed capture raises and keeps no graph; the ``timings`` keys and the
stage spans around ``yunet.graph``; a graph's call goes through its stage
(``_Stage``: the canvas in, the packed rows out), bit-equal to the eager
program, with nothing of one call left in the stage or the result of
another, and ``staged_calls`` counts those calls alone."""

import gc
import gzip
import json
import os
import weakref

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


def _det(model, kind="fused", dtype=torch.float32):
    cfg = yunet_n()
    if kind == "folded":
        return Detector(cfg, folded=fold_inference_params(model, cfg.model),
                        device="cpu", dtype=dtype)
    return Detector(cfg, model, device="cpu", dtype=dtype,
                    fused=kind == "fused")


class Stub:
    """``Detector._record`` on the CPU: counts the launches the wrappers
    count while they queue the program into a capture (the CPU's plain
    versions count none), runs it once, from the stage's input to the
    stage's output, and returns a replay that runs it again, the copy in
    from the stage, the program on the static input and the copy out to
    the stage, counting nothing, as no wrapper runs (``frozen``: a replay
    that does nothing)."""

    def __init__(self, frozen=False):
        self.records = 0
        self.frozen = frozen

    def __call__(self, det, stage, top_k):
        self.records += 1
        fused_conv_dp.launches += K4
        fused_conv_dp.launches_mma += K4
        greedy_nms_keep.launches += K3
        x = stage.x.clone()
        packed = det.detect_packed(x, top_k)
        stage.packed.copy_(packed)

        def replay():
            if not self.frozen:
                x.copy_(stage.x)
                with torch.inference_mode():
                    packed.copy_(det.detect_packed(x, top_k))
                stage.packed.copy_(packed)
        return replay, x, packed


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
                        lambda det, stage, top_k: s(det, stage, top_k))
    return s


def _eager(model, img, dtype=torch.float32, **kw):
    """The result of the eager program: a new Detector's first call of a
    key."""
    return _det(model, dtype=dtype).detect(img, use_device_nms=True, **kw)


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
    assert graph.x.shape == graph.stage.x.shape == (1, 64, 96, 3)
    assert graph.stage.packed.shape == graph.packed.shape
    assert det.staged_calls == 4


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
    assert (det.graph_captures, det.graph_replays, det.staged_calls) == \
        (0, 0, 0)
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

    def fail(det, stage, top_k):
        records.append(stage.x.shape)
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
    assert det.graph_captures == det.staged_calls == 0 and not det._graphs


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
                        lambda det, stage, top_k: s(det, stage, top_k))
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


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
@pytest.mark.parametrize("trunk,frame", [
    (torch.bfloat16, np.uint8),        # a uint8 stage, cast on the device
    (torch.float32, np.uint8),         # an f32 stage: cast into it
    (torch.float32, np.float32)])
def test_staged_replay_equals_the_eager_program(model, stub, hw, trunk,
                                                frame):
    """Every graph's call (the capture and three replays), each on its
    own read-only frame, gives the eager program's result bit for bit;
    the stage holds the call's canvas, cast as ``_input`` casts it, and
    its output the eager program's rows."""
    det = _det(model, dtype=trunk)
    imgs = [_img(*hw, s, frame) for s in range(20, 25)]
    for img in imgs:
        img.setflags(write=False)
    stage_dtype = torch.uint8 if trunk == torch.bfloat16 else torch.float32
    for i, img in enumerate(imgs):
        got = det.detect(img, use_device_nms=True)
        _equal(got, _eager(model, img, dtype=trunk))
        if i:
            (graph,) = det._graphs.values()
            assert graph.stage.x.dtype == stage_dtype
            np.testing.assert_array_equal(graph.stage.x.numpy()[0],
                                          img.astype(np.float32))
            want = _det(model, dtype=trunk).detect_packed(
                torch.from_numpy(img[None].astype(
                    graph.stage.x.numpy().dtype)), det.cfg.test.device_nms_pre)
            np.testing.assert_array_equal(graph.stage.packed.numpy(),
                                          want.numpy())
    assert (det.graph_captures, det.graph_replays, det.staged_calls) == \
        (1, 3, 4)


def test_smaller_frame_after_a_full_canvas_is_staged_with_its_pad_zeroed(
        model, stub):
    """A frame of the canvas's size is its own canvas; a smaller frame
    after it is letterboxed, and the stage, poisoned with 255, takes the
    letterbox whole, its pad zero."""
    det = _det(model)
    mode = (96, 64)                         # the canvas (64, 96)
    full = _img(64, 96, 30)
    for _ in range(3):                      # eager, capture, replay
        _equal(det.detect(full, mode, use_device_nms=True),
               _eager(model, full, mode=mode))
    (graph,) = det._graphs.values()
    graph.stage.x.fill_(255)
    small = _img(40, 96, 31)
    got = det.detect(small, mode, use_device_nms=True)
    assert det.graph_replays == 2
    canvas, scale = detect_mod.resize_img(small, mode)
    assert canvas.shape == (64, 96, 3) and scale == 1.0
    staged = graph.stage.x.numpy()[0]
    np.testing.assert_array_equal(staged, canvas.astype(np.float32))
    assert not staged[40:].any()
    _equal(got, _eager(model, small, mode=mode))


def test_a_result_outlives_the_next_call(model, stub):
    """Call n's result holds no view of the stage: call n+1 on another
    frame leaves it as it was."""
    det = _det(model)
    imgs = [_img(64, 96, s) for s in (40, 41, 42, 43)]
    for img in imgs[:2]:                    # eager, capture
        det.detect(img, use_device_nms=True)
    (graph,) = det._graphs.values()
    got = det.detect(imgs[2], use_device_nms=True)
    kept = {k: v.copy() for k, v in got.items()}
    det.detect(imgs[3], use_device_nms=True)
    assert det.graph_replays == 2
    for k, v in got.items():
        assert not np.shares_memory(v, graph.stage.packed.numpy())
        np.testing.assert_array_equal(v, kept[k])
    _equal(got, _eager(model, imgs[2]))


def test_an_evicted_graph_drops_its_stage(model, stub):
    det = _det(model)
    shapes = [(32 * (i + 1), 64) for i in range(detect_mod._GRAPHS_KEPT + 1)]
    for _ in range(2):
        det.detect(_img(*shapes[0], 50), use_device_nms=True)
    (graph,) = det._graphs.values()
    held = [weakref.ref(t) for t in graph.stage]
    del graph
    for hw in shapes[1:]:                   # the last evicts shapes[0]
        for _ in range(2):
            det.detect(_img(*hw, 51), use_device_nms=True)
    gc.collect()
    assert [k[0][:2] for k in det._graphs] == shapes[1:]
    assert all(ref() is None for ref in held)


def test_staged_calls_count_the_graphs_calls_alone(model, stub, monkeypatch):
    """A capture and a replay go through the stage; the key's eager first
    call, a host-NMS detect, detect_batch and a call with no key do not."""
    det = _det(model)
    img = _img(64, 96, 60)
    seen = []
    for _ in range(3):                      # eager, capture, replay
        det.detect(img, use_device_nms=True)
        seen.append(det.staged_calls)
    det.detect(img)
    det.detect_batch([img, img], "AUTO", use_device_nms=True)
    det.detect_batch([img], "AUTO")
    seen.append(det.staged_calls)
    monkeypatch.setattr(Detector, "_graph_key", lambda *_: None)
    det.detect(img, use_device_nms=True)
    seen.append(det.staged_calls)
    assert seen == [0, 1, 2, 2, 2]
    assert (det.graph_captures, det.graph_replays) == (1, 1)


@pytest.mark.parametrize("frame", ["flipped", "strided", "float64"])
def test_a_view_or_a_float64_frame_is_staged(model, stub, frame):
    """A view with a negative stride, a view that is not contiguous and a
    float64 frame (cast to the f32 stage in the copy) reach the stage as
    the eager program reads them."""
    det = _det(model)
    base = [_img(64, 192, s) for s in range(70, 74)]
    imgs = {"flipped": [b[:, ::-1][:, :96] for b in base],
            "strided": [b[:, ::2] for b in base],
            "float64": [b[:, :96].astype(np.float64) for b in base]}[frame]
    for img in imgs:
        assert img.shape == (64, 96, 3)
        _equal(det.detect(img, use_device_nms=True), _eager(model, img))
    (graph,) = det._graphs.values()
    np.testing.assert_array_equal(graph.stage.x.numpy()[0],
                                  imgs[-1].astype(np.float32))
    assert det.staged_calls == 3
