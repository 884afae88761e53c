"""SCRFD-10GF-KPS on the port (``yunet_tpu_torch/models/scrfd.py`` and the
Detector's SCRFD path) against the plain reference
(``portbench/reference/scrfd.py``), on the CPU, at the published widths
on 64x64 and 96x128 canvases, with seeded random weights drawn and
calibrated as the benchmark's are (``portbench/weights/
make_scrfd_10g_bnkps.py:draw``): the unfused model and the folded f32
tree, the folded bf16 tree against a tolerance that float8 fails, the
decode against ``compare_inference.numpy_decode_scrfd``, detection with
host NMS, the counts of the preset, the 58 counted convs and the spans
of a detect, get_flops, and ``init_detector``'s formats for an SCRFD
plan."""

import dataclasses
import gzip
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import compare
from portbench.reference import scrfd as ref
from portbench.weights.make_scrfd_10g_bnkps import draw
from portbench.yardstick import gen
from portbench.yardstick import scrfd as yardstick
from yunet_tpu_torch.apis import init_detector
from yunet_tpu_torch.config import get_config
from yunet_tpu_torch.eval.detect import Detector
from yunet_tpu_torch.models.scrfd import (SCRFD, fold_scrfd, scrfd_conv,
                                          scrfd_forward)
from yunet_tpu_torch.utils import flops, profiling

CFG = get_config("scrfd_10g_bnkps")
M = dataclasses.asdict(CFG.model)
TEST = dataclasses.asdict(CFG.test)
CANVASES = [(64, 64), (96, 128)]
# the folded bf16 trunk's error, as a share of the spread of each output
# (rms of the difference over rms of the reference's deviation from its
# mean): bf16 keeps 8 significant bits, and the rounding of ~40 layers'
# activations and weights, amplified by the random BN-standardised
# trunk, reads 6-12% at these sizes and seeds; float8 e4m3 keeps 4 bits
# and reads 39-85%
BF16_SHARE = 0.25


def _setup(hw, seed=3, n=3):
    """(frames (n, h, w, 3) uint8, state dict, the port's model)."""
    frames = gen.frame_pool(seed, n, *hw, (1, 3), "cpu")
    sd = draw(M, frames, seed, 10, TEST["score_thr"])
    model = SCRFD(CFG.model, device="cpu")
    model.load_state_dict(harness.port_state_dict(sd))
    return frames, sd, model


def _nchw(frames, dtype=torch.float32):
    return torch.from_numpy(frames).to(dtype).permute(0, 3, 1, 2)


def _share(got, want):
    return float((got.float() - want).pow(2).mean().sqrt()
                 / (want - want.mean()).pow(2).mean().sqrt())


@pytest.fixture(scope="module", params=CANVASES,
                ids=[f"{h}x{w}" for h, w in CANVASES])
def setup(request):
    return _setup(request.param)


def test_unfused_and_folded_f32_equal_the_reference(setup):
    """f32 on both sides: the unfused model runs the reference's
    operations; the folded tree rounds BN into the weights once more and
    sums the swapped input channels in another order, so 1e-4 of each
    output's largest magnitude."""
    frames, sd, model = setup
    x = _nchw(frames)
    with torch.no_grad():
        want = ref.Forward(M, sd)(x)
        unfused = model.forward_flat(x)
        folded = scrfd_forward(fold_scrfd(model), x.contiguous(
            memory_format=torch.channels_last), CFG.model)
    assert set(want) == set(unfused) == set(folded) == {"cls", "bbox",
                                                        "kps"}
    for k in want:
        tol = 1e-4 * float(want[k].abs().max())
        torch.testing.assert_close(unfused[k], want[k], rtol=1e-5, atol=tol)
        torch.testing.assert_close(folded[k], want[k], rtol=1e-4, atol=tol)


def test_folded_bf16_within_bf16_and_float8_fails(setup):
    frames, sd, model = setup
    with torch.no_grad():
        want = ref.Forward(M, sd)(_nchw(frames))
        bf16 = scrfd_forward(fold_scrfd(model, torch.bfloat16), _nchw(
            frames, torch.bfloat16).contiguous(
                memory_format=torch.channels_last), CFG.model)
        fp8 = ref.Forward(M, sd, precision="fp8")(_nchw(frames))
    for k in want:
        assert bf16[k].dtype == torch.bfloat16
        assert _share(bf16[k], want[k]) < BF16_SHARE, k
        assert _share(fp8[k], want[k]) > BF16_SHARE, k


def test_decode_equals_numpy_decode_scrfd_before_its_nms(setup,
                                                         monkeypatch):
    """The Detector's scores, boxes and keypoints above score_thr, in
    their order, against compare_inference's SCRFD decoder with its NMS
    taken out, on the raw outputs split by stride (sigmoid applied, as
    the ONNX export does). f32: the same products, 1e-5."""
    from yunet_tpu_torch.tools import compare_inference as ci
    frames, sd, model = setup
    det = Detector(CFG, model, device="cpu", dtype=torch.float32)
    h, w = frames.shape[1:3]
    x = torch.from_numpy(frames[:1])
    scores, boxes, kps = (t[0].numpy() for t in det.raw(
        x, conv_kernel=False))
    with torch.no_grad():
        flat = model.forward_flat(_nchw(frames[:1]))
    sizes = [h // s * (w // s) * CFG.model.num_anchors
             for s in CFG.model.strides]
    cut = np.cumsum([0] + sizes)
    outs = [[flat[k][0, a:b].numpy() for a, b in zip(cut, cut[1:])]
            for k in ("cls", "bbox", "kps")]
    outs[0] = [1 / (1 + np.exp(-o)) for o in outs[0]]
    monkeypatch.setattr(ci, "_nms", lambda dets, thr: np.arange(len(dets)))
    dets, kp = ci.numpy_decode_scrfd(sum(outs, []), (h, w),
                                     score_thr=TEST["score_thr"])
    keep = scores >= TEST["score_thr"]
    assert keep.sum() > 3
    np.testing.assert_allclose(dets[:, :4], boxes[keep], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dets[:, 4], scores[keep], rtol=1e-5)
    np.testing.assert_allclose(kp, kps[keep], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_detect_and_detect_batch_match_the_reference(fused):
    """Three generated frames through detect and detect_batch with host
    NMS, f32, against the reference's detections (the benchmark's
    comparison): the same rows to f32 rounding, no pair over the NMS
    threshold, no candidate left uncovered."""
    frames, sd, model = _setup((96, 128), seed=11)
    det = Detector(CFG, model, device="cpu", dtype=torch.float32,
                   fused=fused)
    want = ref.detect_frames(M, TEST, sd, frames, top_k=TEST[
        "device_nms_pre"], device="cpu")
    assert sum(len(w["bboxes"]) for w in want) > 6
    got = [det.detect(f, "AUTO") for f in frames]
    got_b = det.detect_batch(list(frames), "AUTO")
    for g, gb, w in zip(got, got_b, want):
        for out in (g, gb):
            assert len(out["bboxes"]) == len(w["bboxes"])
            gaps = compare.frame_gaps(out, w, TEST["nms_iou_thr"])
            assert gaps["score_gap"] < 1e-5 and gaps["geom_gap"] < 1e-3 \
                and gaps["overlap"] <= 0.45 and gaps["uncovered"] == 0, gaps


def test_preset_counts():
    """insightface's model zoo lists 4.23M parameters for SCRFD_10G_KPS,
    and the name's 10 GFLOPs are its conv multiply-adds at 640x480; the
    port's counts equal the benchmark's frozen ones."""
    assert flops.count_params(CFG.model) == 4_229_905
    convs = flops.scrfd_convs(CFG.model, 480, 640)
    assert len(convs) == 58
    assert sum(c.macs for c in convs) == 10_005_513_600
    assert flops.count_macs(CFG.model, (640, 640)) == \
        yardstick.count_macs(M, (640, 640))
    assert [tuple(c) for c in convs] == [
        tuple(c) for c in yardstick.convs(M, 480, 640)]
    # the port's modules hold the reference's tensors under its names
    sd = SCRFD(CFG.model, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")} == \
        dict(ref.param_shapes(M))


def test_a_detect_issues_58_counted_convs_and_its_spans(tmp_path):
    """A fused detect with device NMS (the graph's program) issues 58
    convs through scrfd_conv, and under the profiler its trunk span holds
    the backbone, neck and head spans, in that order."""
    frames, sd, model = _setup((64, 64), n=1)
    det = Detector(CFG, model, device="cpu", dtype=torch.float32,
                   fused=True)
    before = scrfd_conv.launches
    det.detect(frames[0], "AUTO", use_device_nms=True)
    assert scrfd_conv.launches - before == 58
    with profiling.trace(str(tmp_path)):
        det.detect(frames[0], "AUTO", use_device_nms=True)
    (path,) = tmp_path.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + e["dur"], e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "cpu_op"
                   and e["name"].startswith(("yunet.trunk", "scrfd.")))
    assert [n for *_, n in spans] == ["yunet.trunk", "scrfd.backbone",
                                      "scrfd.neck", "scrfd.head"]
    t0, t1, _ = spans[0]
    assert all(t0 <= a and b <= t1 for a, b, _ in spans[1:])


def test_get_flops_reports_the_scrfd_preset(capsys):
    from yunet_tpu_torch.tools import get_flops
    get_flops.main(["scrfd_10g_bnkps", "--shape", "480", "640"])
    lines = capsys.readouterr().out.splitlines()
    assert "Input shape: (3, 480, 640)" in lines
    assert f"Flops: {flops.count_macs(CFG.model, (480, 640)) / 1e6:.2f} " \
        "MFLOPs" in lines
    assert "Params: 4,229,905" in lines


@pytest.mark.parametrize("fmt", [None, ".npz", ".onnx", ".pth"])
def test_init_detector_reads_a_pth_alone(fmt, tmp_path):
    """An SCRFD plan has no seeded init, no flat .npz and no .onnx import:
    each raises a ValueError that names the .pth state dict; a .pth loads
    by module name and detects the rows of ``Detector(cfg, sd)``."""
    frames, sd, _ = _setup((64, 64), n=1)
    sd = harness.port_state_dict(sd)
    path = None if fmt is None else str(tmp_path / f"scrfd{fmt}")
    if fmt == ".pth":
        torch.save(sd, path)
    elif fmt == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    elif fmt == ".onnx":
        open(path, "wb").close()
    if fmt != ".pth":
        with pytest.raises(ValueError, match=r"\.pth state dict"):
            init_detector("scrfd_10g_bnkps", path, device="cpu")
        return
    det = init_detector("scrfd_10g_bnkps", path, device="cpu",
                        dtype=torch.float32, fused=True)
    want = Detector(CFG, sd, device="cpu", dtype=torch.float32, fused=True)
    for use_device_nms in (False, True):
        got, ref_ = (d.detect(frames[0], "AUTO",
                              use_device_nms=use_device_nms)
                     for d in (det, want))
        assert len(ref_["bboxes"])
        for k in ("bboxes", "kps", "labels"):
            np.testing.assert_array_equal(got[k], ref_[k])
