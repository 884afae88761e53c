"""The trace reading and the per-layer readers on a chrome trace written
here: the busy time is the union of the device intervals inside the
slice, idle gaps are named by the host event running in them, and a
reader with nothing to read returns None."""

import json
import types

import pytest

from portbench import harness
from portbench.metrics import (convdp_roofline, device_ms, idle_pct,
                               launches, mfu)
from portbench.yardstick.peaks import convdp_bound_ms
from portbench.yardstick.flops import convdp_units
from portbench.yardstick.trace import Trace

NMS = "void (anonymous namespace)::nms_mask_kernel<4>(float const*)"


def write_trace(path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": harness.SLICE,
         "ts": 1000, "dur": 100},
        # overlapping kernels count once; one starts before the slice
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
         "ts": 990, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": NMS, "ts": 1005, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1040,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "convdp_mma_kernel",
         "ts": 1080, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1010,
         "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 1055, "dur": 30},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_busy_is_the_union_inside_the_slice(tmp_path):
    p = str(tmp_path / "t.json")
    write_trace(p)
    tr = Trace(p, harness.SLICE)
    assert tr.window_us == 100
    # [1000, 1015] + [1040, 1050] + [1080, 1090]
    assert tr.busy_us() == 35
    assert len(tr.kernels()) == 3
    gaps = dict(tr.idle_gaps())
    # 1015-1040 under aten::copy_, 1050-1080 under the sync, 1090-1100
    # under nothing
    assert gaps == pytest.approx({"aten::copy_": 25e-6,
                                  "cudaStreamSynchronize": 30e-6,
                                  "python, no torch op": 10e-6})
    assert tr.kernel_us(["nms_mask_kernel"]) == 10
    assert tr.kernel_us(["no_such_kernel"]) is None
    assert dict(tr.top_ops())["nms_mask_kernel"] == pytest.approx(10e-6)


def test_readers(tmp_path):
    p = str(tmp_path / "t.json")
    write_trace(p)
    cfg = harness.Bench().config("yunet_n")
    drv = types.SimpleNamespace(
        trace=Trace(p, harness.SLICE), slice_calls=2, scope="detect",
        wall=2.0, window_flops=989e12 * 0.02, cfg=cfg,
        traffic={"canvas": [640, 640]})
    assert idle_pct.read(drv) == pytest.approx(65.0)
    assert device_ms.read(drv) == pytest.approx(35 / 1e3 / 2)
    assert launches.read(drv) == 1.5
    assert mfu.read(drv) == pytest.approx(1.0)
    units = [(1, *u) for u in convdp_units(cfg["model"], 640, 640)]
    assert len(units) == 29
    assert convdp_roofline.read(drv) == pytest.approx(
        100 * 2 * convdp_bound_ms(units) / 0.010)
    drv.trace = None
    assert all(m.read(drv) is None for m in
               (idle_pct, device_ms, launches, convdp_roofline))
