"""The reader of graph_pct.detect on a chrome trace written here: four
detect calls, three of which hold a ``yunet.graph`` span (the first call
issued its program launch by launch, under ``yunet.trunk``); a graph span
outside every call counts for none. None where the trace holds no graph
span (the parent's program), no call span, or no trace."""

import json
import types

import pytest

from portbench import harness
from portbench.metrics import graph_pct
from portbench.yardstick.trace import Trace

# (name, start, end) in us; the slice is [0, 200]
CALL = [("yunet.detect", 10, 50), ("yunet.upload", 12, 15),
        ("yunet.trunk", 15, 40), ("yunet.nms", 40, 45)]
REPLAYS = [("yunet.detect", a, a + 30) for a in (60, 100, 140)] + \
    [("yunet.graph", a + 8, a + 9) for a in (60, 100, 140)]
STRAY = [("yunet.graph", 190, 195)]
DEVICE = [("convdp_mma_kernel", "kernel", 16, 30),
          ("convdp_mma_kernel", "kernel", 70, 80)]


def traced_drv(tmp_path, spans):
    ev = [{"ph": "X", "cat": "user_annotation", "name": harness.SLICE,
           "ts": 0, "dur": 200}]
    ev += [{"ph": "X", "cat": cat, "name": n, "ts": a, "dur": b - a}
           for n, cat, a, b in DEVICE]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": a, "dur": b - a}
           for n, a, b in spans]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return types.SimpleNamespace(trace=Trace(str(p), harness.SLICE),
                                 slice_calls=4, scope="detect")


def test_share_of_calls_holding_a_graph(tmp_path):
    drv = traced_drv(tmp_path, CALL + REPLAYS + STRAY)
    assert graph_pct.read(drv) == pytest.approx(75.0)


def test_every_call_replayed(tmp_path):
    assert graph_pct.read(traced_drv(tmp_path, REPLAYS)) == 100.0


@pytest.mark.parametrize("spans", [CALL, STRAY, []])
def test_none_without_graph_or_call_spans(tmp_path, spans):
    """The parent's program (call spans, no graph span), a graph span
    with no call, and a trace with no span."""
    assert graph_pct.read(traced_drv(tmp_path, spans)) is None


def test_none_without_trace():
    assert graph_pct.read(types.SimpleNamespace(trace=None,
                                                slice_calls=4)) is None
