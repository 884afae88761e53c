"""RetinaFace-R50 on the port (``yunet_tpu_torch/models/retinaface.py`` and
the Detector's RetinaFace path) against the plain reference
(``portbench/reference/retinaface.py``), on the CPU, at the published
widths on 64x64 and 96x128 canvases, with seeded random weights drawn and
calibrated as the benchmark's are (``portbench/weights/
make_retinaface_r50.py:draw``): the unfused model and the folded f32
tree, the folded bf16 tree against a tolerance that float8 fails, a
state dict under biubug6's names with the ``module.`` prefix, the priors
and decode against ``compare_inference``'s RetinaFace decoder, detection
with host and device NMS and its ``max_per_img``, the counts of the
preset, the counted convs and the spans of a detect, and get_flops."""

import dataclasses
import gzip
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import compare
from portbench.reference import retinaface as ref
from portbench.weights.make_retinaface_r50 import draw
from portbench.yardstick import gen
from portbench.yardstick import retinaface as yardstick
from yunet_tpu_torch.config import get_config
from yunet_tpu_torch.eval.detect import Detector
from yunet_tpu_torch.models import retinaface as rf
from yunet_tpu_torch.models.retinaface import (RetinaFace, fold_retinaface,
                                               retinaface_forward)
from yunet_tpu_torch.ops.conv_epi import conv_epi_plain
from yunet_tpu_torch.utils import flops, profiling

CFG = get_config("retinaface_r50")
M = dataclasses.asdict(CFG.model)
TEST = dataclasses.asdict(CFG.test)
CANVASES = [(64, 64), (96, 128)]
# the folded bf16 trunk's error, as a share of the spread of each output
# (rms of the difference over rms of the reference's deviation from its
# mean): bf16 keeps 8 significant bits, and the rounding of ~60 layers'
# activations and weights, amplified by the random BN-standardised
# trunk, reads 1.8-9.7% at these sizes and seeds; float8 e4m3 keeps 4 bits
# and reads 14.8-67%
BF16_SHARE = 0.125


def _setup(hw, seed=3, n=3):
    """(frames (n, h, w, 3) uint8, state dict, the port's model)."""
    frames = gen.frame_pool(seed, n, *hw, (1, 3), "cpu")
    sd = draw(M, frames, seed, 10, TEST["score_thr"])
    model = RetinaFace(CFG.model, device="cpu")
    model.load_state_dict(harness.port_state_dict(sd))
    return frames, sd, model


def _nchw(frames, dtype=torch.float32):
    return torch.from_numpy(frames).to(dtype).permute(0, 3, 1, 2)


def _share(got, want):
    return float((got.float() - want).pow(2).mean().sqrt()
                 / (want - want.mean()).pow(2).mean().sqrt())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs. Under pytest-xdist's
    six workers, each with a torch thread a core, ResNet-50's convs
    oversubscribed the cores and ran 30x slower (670 s, against 21 s alone
    on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=CANVASES,
                ids=[f"{h}x{w}" for h, w in CANVASES])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def seed11():
    return _setup((96, 128), seed=11)


def test_unfused_and_folded_f32_equal_the_reference(setup):
    """f32 on both sides: the unfused model runs the reference's
    operations; the folded tree rounds BN into the weights once more, so
    1e-4 of each output's largest magnitude; with and without use_kernel
    (both the plain version on the CPU)."""
    frames, sd, model = setup
    x = _nchw(frames)
    folded = fold_retinaface(model)
    with torch.no_grad():
        want = ref.Forward(M, sd)(x)
        unfused = model.forward_flat(x)
        got = [retinaface_forward(folded, x.contiguous(
            memory_format=torch.channels_last), CFG.model, use_kernel=k)
            for k in (True, False)]
    assert set(want) == set(unfused) == {"cls", "bbox", "kps"}
    for k in want:
        tol = 1e-4 * float(want[k].abs().max())
        torch.testing.assert_close(unfused[k], want[k], rtol=1e-5, atol=tol)
        for g in got:
            torch.testing.assert_close(g[k], want[k], rtol=1e-4, atol=tol)


def test_folded_bf16_within_bf16_and_float8_fails(setup):
    frames, sd, model = setup
    with torch.no_grad():
        want = ref.Forward(M, sd)(_nchw(frames))
        bf16 = retinaface_forward(fold_retinaface(model, torch.bfloat16),
                                  _nchw(frames, torch.bfloat16).contiguous(
                                      memory_format=torch.channels_last),
                                  CFG.model)
        fp8 = ref.Forward(M, sd, precision="fp8")(_nchw(frames))
    for k in want:
        assert bf16[k].dtype == torch.bfloat16
        assert _share(bf16[k], want[k]) < BF16_SHARE, k
        assert _share(fp8[k], want[k]) > BF16_SHARE, k


def test_a_prefixed_state_dict_loads_under_biubug6s_names(setup):
    """A checkpoint saved from DataParallel (every name behind
    ``module.``) loads as it is; the port's names are the reference's."""
    _, sd, model = setup
    net = RetinaFace(CFG.model, device="cpu")
    net.load_state_dict({"module." + k: v for k, v in
                         harness.port_state_dict(sd).items()})
    for k, v in model.state_dict().items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=0, atol=0)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert shapes == dict(ref.param_shapes(M))
    assert {"body.layer2.0.downsample.1.running_var", "fpn.output1.0.weight",
            "fpn.merge1.1.bias", "ssh1.conv3X3.0.weight",
            "ssh3.conv7x7_3.1.weight", "ClassHead.0.conv1x1.bias",
            "BboxHead.2.conv1x1.weight",
            "LandmarkHead.1.conv1x1.weight"} <= set(shapes)


def test_priors_and_decode_equal_numpy_decode_retinaface(setup,
                                                         monkeypatch):
    """The Detector's priors, and its scores, boxes and keypoints above
    score_thr in their order, against compare_inference's RetinaFace
    priors (normalised, scaled to pixels here) and decoder with its NMS
    taken out (softmax applied, as the ONNX export does). f32: the same
    products in another order (the decoder takes x2 = cx + w / 2, the
    source x1 + w, and works in the unit square), 1e-5 relative, and 1e-3
    px for a coordinate near 0."""
    from yunet_tpu_torch.tools import compare_inference as ci
    frames, sd, model = setup
    det = Detector(CFG, model, device="cpu", dtype=torch.float32)
    h, w = frames.shape[1:3]
    scale = np.asarray([w, h, w, h], np.float32)
    np.testing.assert_allclose(det.priors(h, w).numpy(),
                               ci.retinaface_priors((h, w)) * scale,
                               rtol=1e-6)
    np.testing.assert_array_equal(RetinaFace.priors(CFG.model, h, w),
                                  ref.priors(M, h, w, "cpu").numpy())
    scores, boxes, kps = (t[0].numpy() for t in det.raw(
        torch.from_numpy(frames[:1]), conv_kernel=False))
    with torch.no_grad():
        flat = model.forward_flat(_nchw(frames[:1]))
    outs = [flat["bbox"].numpy(), torch.softmax(flat["cls"], -1).numpy(),
            flat["kps"].numpy()]
    monkeypatch.setattr(ci, "_nms", lambda dets, thr: np.arange(len(dets)))
    dets, kp = ci.numpy_decode_retinaface(outs, (h, w),
                                          score_thr=TEST["score_thr"],
                                          variances=CFG.model.variance)
    keep = scores >= TEST["score_thr"]
    assert keep.sum() > 3
    np.testing.assert_allclose(dets[:, :4], boxes[keep], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(dets[:, 4], scores[keep], rtol=1e-5)
    np.testing.assert_allclose(kp, kps[keep], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_detect_matches_the_reference(seed11, fused):
    """Three generated frames through detect with host NMS and with the
    device-NMS program (its plain version here), f32, against the
    reference's detections (the benchmark's comparison): the same rows to
    f32 rounding, no pair over the NMS threshold, no candidate left
    uncovered."""
    frames, sd, model = seed11
    det = Detector(CFG, model, device="cpu", dtype=torch.float32,
                   fused=fused)
    want = ref.detect_frames(M, TEST, sd, frames, top_k=TEST[
        "device_nms_pre"], device="cpu")
    assert sum(len(w["bboxes"]) for w in want) > 6
    for use_device_nms in (False, True):
        for f, w in zip(frames, want):
            out = det.detect(f, "AUTO", use_device_nms=use_device_nms)
            assert len(out["bboxes"]) == len(w["bboxes"])
            gaps = compare.frame_gaps(out, w, TEST["nms_iou_thr"])
            assert gaps["score_gap"] < 1e-5 and gaps["geom_gap"] < 1e-3 \
                and gaps["overlap"] <= 0.4 and gaps["uncovered"] == 0, gaps


def test_max_per_img_keeps_the_top_detections(setup):
    """``test.max_per_img`` (the published keep_top_k) cuts the kept
    detections after NMS to the highest scoring, on the host and the
    device path alike, and so does the reference."""
    frames, sd, model = setup
    cap = 2
    cfg = dataclasses.replace(CFG, test=dataclasses.replace(
        CFG.test, max_per_img=cap))
    full, capped = (Detector(c, model, device="cpu", dtype=torch.float32,
                             fused=True) for c in (CFG, cfg))
    want = ref.detect_frames(M, dict(TEST, max_per_img=cap), sd, frames,
                             top_k=TEST["device_nms_pre"], device="cpu")
    seen = 0
    for f, w in zip(frames, want):
        for use_device_nms in (False, True):
            a, b = (d.detect(f, "AUTO", use_device_nms=use_device_nms)
                    for d in (full, capped))
            n = min(cap, len(a["bboxes"]))
            seen += len(a["bboxes"]) > cap
            np.testing.assert_array_equal(b["bboxes"], a["bboxes"][:n])
            np.testing.assert_array_equal(b["kps"], a["kps"][:n])
            assert len(w["bboxes"]) == n
            assert compare.frame_gaps(b, w, TEST["nms_iou_thr"])[
                "uncovered"] == 0
    assert seen


def test_preset_counts():
    """Deng et al.'s ResNet-50 RetinaFace as biubug6's cfg_re50 builds it:
    27,293,600 learnable parameters and 44.26 G conv multiply-adds in 82
    convs at 640x640; the port's counts equal the benchmark's frozen
    ones."""
    assert flops.count_params(CFG.model) == 27_293_600
    convs = flops.retinaface_convs(CFG.model, 640, 640)
    assert len(convs) == 82
    assert sum(c.macs for c in convs) == 44_264_652_800
    assert flops.count_macs(CFG.model, (640, 640)) == \
        yardstick.count_macs(M, (640, 640))
    assert [tuple(c) for c in convs] == [
        tuple(c) for c in yardstick.convs(M, 640, 640)]


def test_a_detect_issues_76_counted_convs_and_its_spans(tmp_path,
                                                       monkeypatch):
    """A fused detect with device NMS (the graph's program) issues 76
    convs through retinaface_conv (the published 82, each level's three
    heads one conv), 2 adding the level above after their ReLU (the FPN's
    finer laterals) and 12 into a slice of a wider map (the SSH's 9
    branch ends, the 3 heads); under the profiler its trunk span holds
    the backbone, FPN, SSH and head spans, in that order."""
    frames, sd, model = _setup((64, 64), n=1)
    det = Detector(CFG, model, device="cpu", dtype=torch.float32,
                   fused=True)
    calls = []

    def plain(x, w, b, **kw):
        calls.append(kw)
        return conv_epi_plain(x, w, b, **kw)

    monkeypatch.setattr(rf, "conv_epi_plain", plain)
    before = rf.retinaface_conv.launches
    det.detect(frames[0], "AUTO", use_device_nms=True)
    assert rf.retinaface_conv.launches - before == len(calls) == 76
    assert sum(c["post_add"] for c in calls) == 2
    assert sum(c["out"] is not None for c in calls) == 12
    with profiling.trace(str(tmp_path)):
        det.detect(frames[0], "AUTO", use_device_nms=True)
    (path,) = tmp_path.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + e["dur"], e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "cpu_op"
                   and e["name"].startswith(("yunet.trunk", "retinaface.")))
    assert [n for *_, n in spans] == [
        "yunet.trunk", "retinaface.backbone", "retinaface.fpn",
        "retinaface.ssh", "retinaface.head"]
    t0, t1, _ = spans[0]
    assert all(t0 <= a and b <= t1 for a, b, _ in spans[1:])


def test_get_flops_reports_the_retinaface_preset(capsys):
    from yunet_tpu_torch.tools import get_flops
    get_flops.main(["retinaface_r50", "--shape", "640", "640"])
    lines = capsys.readouterr().out.splitlines()
    assert "Input shape: (3, 640, 640)" in lines
    assert "Flops: 44551.49 MFLOPs" in lines
    assert "Params: 27,293,600" in lines
