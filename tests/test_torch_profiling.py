"""yunet_tpu_torch/utils/profiling.py and utils/trace_profile.py on the
CPU: profile_time's line equals the JAX package's under one patched
clock; trace() writes a chrome trace, which holds no device event here;
aggregate_trace, categorize and report on a trace written in the test
with device-lane events named as the card names them (exact sums, counts
and categories); device_rows and port_kernels on a stand-in profile."""

import collections
import gzip
import json
import os
import time
import types

import pytest
import torch

from yunet_tpu.utils import profiling as jax_profiling
from yunet_tpu_torch.utils import profiling
from yunet_tpu_torch.utils.trace_profile import (
    NoDeviceEvents, aggregate_trace, categories, categorize, device_rows,
    port_kernels, report)


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_profile_time_line_equals_jax(monkeypatch, capsys):
    lines = []
    for mod in (jax_profiling, profiling):
        _clock(monkeypatch, [10.0, 10.01234])
        with mod.profile_time("region", sync_on=[torch.zeros(2)]
                              if mod is profiling else None):
            pass
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] == "region: 12.34 ms\n"
    # a logger takes the line; disabled regions print nothing
    got = []
    log = types.SimpleNamespace(info=got.append)
    _clock(monkeypatch, [1.0, 1.5])
    with profiling.profile_time("x", logger=log):
        pass
    with profiling.profile_time("y", enabled=False):
        pass
    assert got == ["x: 500.00 ms"] and capsys.readouterr().out == ""


def test_trace_writes_cpu_trace_without_device_events(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    paths = list(tmp_path.glob("*.pt.trace.json.gz"))
    assert len(paths) == 1
    with gzip.open(paths[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)
    with pytest.raises(NoDeviceEvents, match="no device event"):
        aggregate_trace(str(tmp_path))


def test_aggregate_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no trace found"):
        aggregate_trace(str(tmp_path))


# (name, cat, dur us) as the card's chrome trace names them; the CPU-lane
# events (cpu_op, cuda_runtime) and a non-complete event must not count
EVENTS = [
    ("void (anonymous namespace)::topk_kernel<16>(float const*, int)",
     "kernel", 12.5),
    ("void (anonymous namespace)::topk_kernel<32>(float const*, int)",
     "kernel", 7.5),
    ("void (anonymous namespace)::valid_best_kernel(float const*)",
     "kernel", 4.0),
    ("void (anonymous namespace)::reduce_rows<float>(float*)", "kernel", 3.0),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "kernel", 30.0),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(int)",
     "kernel", 2.0),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel"
     "<1, float, int>(float const*)", "kernel", 9.0),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32", "kernel",
     6.0),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_s161616gemm>(int)",
     "kernel", 1.0),
    ("nvjet_tss_64x32_64x16_1x2_h_bz_TNT", "kernel", 0.5),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>"
     "(int)", "kernel", 5.0),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AddFunctor<float>>(int)", "kernel", 8.0),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AddFunctor<float>>(int)", "kernel", 8.0),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20.0),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1.5),
    ("Memset (Device)", "gpu_memset", 0.5),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "kernel", 11.0),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<float>"
     "(int)", "kernel", 2.5),
    ("aten::conv2d", "cpu_op", 100.0),
    ("cudaLaunchKernel", "cuda_runtime", 50.0),
]
WANT_CATS = {
    "port kernel": (12.5 + 7.5 + 4.0 + 3.0, 4),
    "conv": (30.0 + 2.0 + 9.0, 3),
    "gemm": (6.0 + 1.0 + 0.5, 3),
    "reduce": (5.0, 1),
    "elementwise": (16.0, 2),
    "copy/transfer": (22.0, 3),
    "collective": (11.0, 1),
    "other": (2.5, 1),
}


def _write_trace(path, events, gz=False):
    evs = [{"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "python"}},
           {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0, "pid": 1}]
    for i, (name, cat, dur) in enumerate(events):
        evs.append({"ph": "X", "cat": cat, "name": name, "ts": 10 * i,
                    "dur": dur, "pid": 1 if cat != "cpu_op" else 0,
                    "tid": 7})
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": evs}, f)


@pytest.mark.parametrize("gz", [False, True])
def test_aggregate_trace_sums_device_lane(tmp_path, gz):
    old = tmp_path / "old.pt.trace.json"
    _write_trace(old, EVENTS[:1])
    os.utime(old, (1, 1))
    (tmp_path / "sub").mkdir()
    _write_trace(tmp_path / "sub" / ("new.pt.trace.json" + ".gz" * gz),
                 EVENTS, gz=gz)
    tot, cnt = aggregate_trace(str(tmp_path))
    want_tot, want_cnt = collections.Counter(), collections.Counter()
    for name, cat, dur in EVENTS:
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            want_tot[name] += dur
            want_cnt[name] += 1
    assert tot == want_tot and cnt == want_cnt
    assert "aten::conv2d" not in tot and "instant" not in tot
    assert categories(tot, cnt) == WANT_CATS
    assert port_kernels([(k, us, cnt[k]) for k, us in tot.items()]) == {
        "topk_kernel": (20.0, 2), "valid_best_kernel": (4.0, 1),
        "reduce_rows": (3.0, 1)}


def test_categorize_names():
    got = {name: categorize(name) for name, _, _ in EVENTS[:18]}
    assert [got[n] for n, _, _ in EVENTS[:4]] == ["port kernel"] * 4
    assert got[EVENTS[6][0]] == "conv"          # depthwise, at::native
    assert got[EVENTS[17][0]] == "other"        # at::native max-pool
    assert got[EVENTS[9][0]] == "gemm"          # cuBLASLt
    assert categorize("Memset (Device)") == "copy/transfer"
    assert categorize("void (anonymous namespace)::convdp_mma_kernel<64, "
                      "64>(int)") == "port kernel"


def test_report_blocks(tmp_path, capsys):
    _write_trace(tmp_path / "t.pt.trace.json", EVENTS * 2)
    tot, cnt = aggregate_trace(str(tmp_path))
    report(tot, cnt, steps=2, top=3)
    out = capsys.readouterr().out.splitlines()
    total = sum(d for _, c, d in EVENTS if c not in ("cpu_op", "cuda_runtime"))
    assert out[0] == (f"device total: {total / 1e3:.2f} ms/step "
                      f"({len(tot)} distinct ops)")
    assert out[1:3] == ["", "by category:"]
    assert out[3] == f"{41.0 / 1e3:9.3f} ms/step  x3     conv"
    assert out[3 + len(WANT_CATS):5 + len(WANT_CATS)] == ["", "top ops:"]
    top = out[5 + len(WANT_CATS):8 + len(WANT_CATS)]
    assert top[0] == (f"{30.0 / 1e3:9.3f} ms/step  x1     [conv] "
                      f"{EVENTS[4][0][:70]}")
    assert top[2].startswith(f"{16.0 / 1e3:9.3f} ms/step  x2     "
                             "[elementwise] ")
    assert out[8 + len(WANT_CATS):] == [
        "", "port kernels (all instantiations):",
        f"{20.0 / 1e3:9.3f} ms/step  x2     topk_kernel",
        f"{4.0 / 1e3:9.3f} ms/step  x1     valid_best_kernel",
        f"{3.0 / 1e3:9.3f} ms/step  x1     reduce_rows"]


def test_device_rows_and_port_kernels():
    def ev(key, dev, us, count):
        return types.SimpleNamespace(
            key=key, device_type=types.SimpleNamespace(name=dev),
            device_time_total=us, count=count)
    prof = types.SimpleNamespace(key_averages=lambda: [
        ev("aten::mm", "CPU", 0.0, 4),
        ev(EVENTS[0][0], "CUDA", 400.0, 8),
        ev(EVENTS[1][0], "CUDA", 200.0, 4),
        ev(EVENTS[6][0], "CUDA", 1000.0, 4),
        ev("idle", "CUDA", 0.0, 1)])
    rows = device_rows(prof, calls=4)
    assert rows == [(EVENTS[6][0], 0.25, 1.0), (EVENTS[0][0], 0.1, 2.0),
                    (EVENTS[1][0], 0.05, 1.0)]
    assert port_kernels(rows) == {"topk_kernel": (0.1 + 0.05, 3.0)}
