"""The readers of the program's spans on a chrome trace written here: two
detect calls, each with its stage spans, K4 and NMS-kernel spans inside
the trunk and NMS stages, kernels and copies on the device lane. Exact
values; None where the trace holds no span (the parent's program); the
stage idle times and the idle outside the calls add up to the slice's
idle; the spans move no device metric."""

import json
import types

import pytest

from portbench import harness
from portbench.metrics import (idle_pct, k4_issue_us, launches,
                               nms_idle_ms, readback_ms, trunk_idle_ms,
                               upload_ms)
from portbench.yardstick import spans
from portbench.yardstick.trace import Trace

STAGES = ("yunet.letterbox", "yunet.upload", "yunet.trunk", "yunet.decode",
          "yunet.nms", "yunet.readback", "yunet.result")
# (name, start, end) in us; the slice is [0, 200]
SPANS = [
    ("yunet.detect", 10, 90), ("yunet.letterbox", 10, 20),
    ("yunet.upload", 20, 30), ("yunet.trunk", 30, 60),
    ("yunet.k4", 32, 40), ("yunet.k4", 42, 50), ("yunet.decode", 60, 65),
    ("yunet.nms", 65, 75), ("yunet.nms_kernel", 66, 70),
    ("yunet.readback", 75, 85), ("yunet.result", 85, 90),
    ("yunet.detect", 110, 180), ("yunet.letterbox", 110, 115),
    ("yunet.upload", 115, 130), ("yunet.trunk", 130, 150),
    ("yunet.k4", 131, 135), ("yunet.k4", 140, 146),
    ("yunet.decode", 150, 155), ("yunet.nms", 155, 160),
    ("yunet.nms_kernel", 156, 158), ("yunet.readback", 160, 178),
    ("yunet.result", 178, 180),
]
# busy [25, 28], [35, 45], [55, 70], [80, 82], [135, 150], [158, 170]
DEVICE = [("Memcpy HtoD", "gpu_memcpy", 25, 28),
          ("convdp_mma_kernel", "kernel", 35, 45),
          ("convdp_mma_kernel", "kernel", 55, 62),
          ("nms_mask_kernel", "kernel", 60, 70),
          ("Memcpy DtoH", "gpu_memcpy", 80, 82),
          ("convdp_mma_kernel", "kernel", 135, 150),
          ("nms_scan_kernel", "kernel", 158, 170)]
IDLE = 200 - (3 + 10 + 15 + 2 + 15 + 12)


def write_trace(path, with_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": harness.SLICE,
           "ts": 0, "dur": 200},
          {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 33,
           "dur": 1}]
    ev += [{"ph": "X", "cat": cat, "name": n, "ts": a, "dur": b - a}
           for n, cat, a, b in DEVICE]
    if with_spans:
        ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": a,
                "dur": b - a} for n, a, b in SPANS]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def traced_drv(tmp_path, with_spans=True):
    p = str(tmp_path / f"t{int(with_spans)}.json")
    write_trace(p, with_spans)
    return types.SimpleNamespace(trace=Trace(p, harness.SLICE),
                                 slice_calls=2, scope="detect")


def test_readers_read_the_spans(tmp_path):
    drv = traced_drv(tmp_path)
    assert drv.trace.busy_us() == 200 - IDLE
    # call 1 uploads 10 us, call 2 15; reads back 10 and 18
    assert upload_ms.read(drv) == pytest.approx(0.0125)
    assert readback_ms.read(drv) == pytest.approx(0.014)
    # trunk 1 [30, 60] idle over [30, 35] and [45, 55]; trunk 2 [130, 135]
    assert trunk_idle_ms.read(drv) == pytest.approx((5 + 10 + 5) / 2 / 1e3)
    # nms 1 [70, 75]; nms 2 [155, 158]
    assert nms_idle_ms.read(drv) == pytest.approx((5 + 3) / 2 / 1e3)
    assert k4_issue_us.read(drv) == pytest.approx(7.0)   # 8, 8, 4, 6


def test_stage_idle_and_unspanned_idle_add_up(tmp_path):
    tr = traced_drv(tmp_path).trace
    gaps = spans.idle(tr)
    assert sum(b - a for a, b in gaps) == IDLE
    by_stage = {n: spans.overlap_us(spans.spans(tr, n), gaps)
                for n in STAGES}
    assert by_stage == {"yunet.letterbox": 15, "yunet.upload": 22,
                        "yunet.trunk": 20, "yunet.decode": 5,
                        "yunet.nms": 8, "yunet.readback": 16,
                        "yunet.result": 7}
    # idle before call 1 [0, 10], between [90, 110], after [180, 200]
    in_calls = spans.overlap_us(spans.spans(tr, spans.CALLS), gaps)
    assert IDLE - in_calls == 50
    assert sum(by_stage.values()) + 50 == IDLE


@pytest.mark.parametrize("reader", [upload_ms, trunk_idle_ms, k4_issue_us,
                                    nms_idle_ms, readback_ms])
def test_reader_without_spans_is_none(tmp_path, reader):
    """The parent's program: no yunet.* span; and no trace at all."""
    assert reader.read(traced_drv(tmp_path, with_spans=False)) is None
    assert reader.read(types.SimpleNamespace(trace=None,
                                             slice_calls=2)) is None


def test_spans_move_no_device_metric(tmp_path):
    with_ = traced_drv(tmp_path)
    without = traced_drv(tmp_path, with_spans=False)
    for m in (idle_pct, launches):
        assert m.read(with_) == m.read(without)
    assert with_.trace.idle_gaps() != without.trace.idle_gaps()
    assert with_.trace.busy_intervals() == without.trace.busy_intervals()


def test_overlap_of_unions():
    assert spans.overlap_us([(0, 10), (5, 20)], [(15, 30), (40, 50)]) == 5
    assert spans.overlap_us([], [(0, 1)]) == 0
    assert spans.merged([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
