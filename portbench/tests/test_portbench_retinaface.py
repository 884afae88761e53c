"""The RetinaFace cell's files: the weight file holds what calibration sets
(BN and the heads' biases, float16, and the conv weights' seed) and no
conv weight, and loads into every tensor of the model; the
retinaface_detect driver runs on the CPU at a small size, in float32 so
that a planted fault is all that differs from the reference: a sound run
is correct and each fault fails a limit, and the control (the reference
in float8) fails one too. The two new per-layer readers read the union of
the conv kernels' intervals in a trace written here, and None without
them; the parent program (without the RetinaFace plan) fails at once."""

import json
import os
import types

import numpy as np
import pytest

from portbench import harness
from portbench.metrics import rf_conv_ms, rf_conv_roofline
from portbench.reference import retinaface as ref
from portbench.run import run_cell
from portbench.weights import make_retinaface_r50 as make
from portbench.yardstick.retinaface import conv_bound_ms
from portbench.yardstick.trace import Trace

CELL = "retinaface_r50.detect.b1"
SMALL = {"driver": "retinaface_detect", "pool": 3, "canvas": [256, 256],
         "faces": [6, 10], "fused": True, "warmup_calls": 1,
         "trace_calls": 1}


def test_the_weight_file_holds_what_calibration_sets():
    m = harness.Bench().config("retinaface_r50")["model"]
    shapes = dict(ref.param_shapes(m))
    assert os.path.getsize(make.OUT) < 1 << 20
    with np.load(make.OUT) as blob:
        assert int(blob["conv_seed"]) == make.CONV_SEED
        names = set(blob.files) - {"conv_seed"}
        for k in names:
            assert blob[k].dtype == np.float16 and blob[k].shape == \
                shapes[k], k
            assert np.isfinite(blob[k]).all(), k
    convs = {k for k, s in shapes.items() if len(s) == 4}
    assert names == set(shapes) - convs
    sd = make.load(m, make.OUT, "cpu")
    assert set(sd) == set(shapes)
    assert all(tuple(v.shape) == shapes[k] for k, v in sd.items())
    assert all(float(v.min()) > 0 for k, v in sd.items()
               if k.endswith("running_var"))


class F32Bench(harness.Bench):
    """The benchmark with the program in float32."""

    def config(self, name):
        cfg = super().config(name)
        cfg["precision"] = "float32"
        return cfg


@pytest.mark.parametrize("fault", (None, "altered", "raised_thr",
                                   "made_up"))
def test_planted_faults_fail(fault):
    r = run_cell(F32Bench(), CELL, 9, 0.3, False, device="cpu",
                 fault=fault, traffic=SMALL)
    assert r["correct"] is (fault is None), json.dumps(r["compared"])
    assert r["attempted"] > 0


def test_the_control_fails_a_limit_at_a_small_size():
    bench = harness.Bench()
    cfg = bench.config(bench.workload(CELL)["config"])
    drv = harness.driver_class(SMALL["driver"])(cfg, SMALL, 3, "cpu")
    drv.limits = limits = bench.limits(CELL)
    drv.setup()
    drv.release()
    numbers = drv.control()
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


def _drv(tmp_path, kernels):
    ev = [{"ph": "X", "cat": "user_annotation", "name": harness.SLICE,
           "ts": 0, "dur": 1000}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": d}
           for n, a, d in kernels]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    cfg = harness.Bench().config("retinaface_r50")
    return types.SimpleNamespace(trace=Trace(str(p), harness.SLICE),
                                 slice_calls=2, cfg=cfg,
                                 traffic={"canvas": [640, 640]})


def test_the_conv_readers_read_the_union(tmp_path):
    """Two conv launches that overlap by 20 us (a programmatic dependent's
    set-up under its predecessor's epilogue) count once, a library conv
    and a GEMM beside them too; other kernels not at all."""
    kernel = "void (anonymous namespace)::scrfd_fprop_kernel<4>(Conv)"
    drv = _drv(tmp_path, [
        (kernel, 0, 100), (kernel, 80, 100),
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
         "_tilesize128x128x64_cudnn", 300, 50),
        ("nvjet_tst_88x64_64x11_1x4_h_bz_TNN", 340, 20),
        ("void at::native::vectorized_elementwise_kernel<4>", 400, 50),
        ("void (anonymous namespace)::nms_mask_kernel<4>(float const*)",
         500, 10)])
    assert rf_conv_ms.read(drv) == pytest.approx((180 + 60) / 1e3 / 2)
    assert rf_conv_roofline.read(drv) == pytest.approx(
        100 * 2 * conv_bound_ms(drv.cfg["model"], 640, 640) / 0.240)
    none = _drv(tmp_path, [("void at::native::elementwise_kernel", 0, 5)])
    assert rf_conv_ms.read(none) is None
    assert rf_conv_roofline.read(none) is None
    none.trace = None
    assert rf_conv_ms.read(none) is None
    assert rf_conv_roofline.read(none) is None


def test_the_parent_program_fails_at_once(monkeypatch):
    """A program without the RetinaFace plan (as the port was before it)
    makes the driver raise at set-up, before the pool is drawn."""
    from yunet_tpu_torch import config
    monkeypatch.delattr(config, "RetinaFaceConfig")
    with pytest.raises(AttributeError):
        run_cell(harness.Bench(), CELL, 3, 0.1, False, device="cpu",
                 traffic=SMALL)
