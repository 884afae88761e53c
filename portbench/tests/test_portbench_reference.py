"""The plain reference against the port on the CPU, at small sizes, in
float32: the forward and detection with NMS. The port runs its plain
versions here (no kernel runs without a card); the reference shares no
code with it."""

import numpy as np
import torch

from portbench import harness
from portbench.reference import compare, model as ref_model
from portbench.reference.detect import detect_frames
from portbench.yardstick import gen


def config():
    """yunet_n's configuration file, float32."""
    cfg = harness.Bench().config("yunet_n")
    cfg["precision"] = "float32"
    return cfg


def test_forward_equals_the_ports():
    from yunet_tpu_torch.models.detector import YuNet
    cfg = config()
    sd = harness.weights(cfg, "cpu")
    model = YuNet(harness.port_config(cfg).model, device="cpu")
    model.load_state_dict(harness.port_state_dict(sd))
    x = torch.from_numpy(gen.frame_pool(3, 2, 96, 128, (1, 3), "cpu")
                         ).float().permute(0, 3, 1, 2)
    with torch.no_grad():
        want = model.forward_flat(x)
        got = ref_model.Forward(cfg["model"], sd)(x)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


def test_detections_equal_the_ports():
    from yunet_tpu_torch.eval.detect import Detector
    cfg = config()
    sd = harness.weights(cfg, "cpu")
    frames = gen.frame_pool(9, 4, 128, 128, (1, 4), "cpu")
    det = Detector(harness.port_config(cfg), harness.port_state_dict(sd),
                   device="cpu", dtype=torch.float32)
    got = det.detect_batch(list(frames), (128, 128), use_device_nms=True,
                           device_nms_top_k=750)
    want = detect_frames(cfg["model"], cfg["test"], sd, frames, top_k=750,
                         device="cpu")
    assert sum(len(w["bboxes"]) for w in want) > 4
    for g, w in zip(got, want):
        assert len(g["bboxes"]) == len(w["bboxes"])
        gaps = compare.frame_gaps(g, w, cfg["test"]["nms_iou_thr"])
        assert gaps["score_gap"] < 1e-5 and gaps["geom_gap"] < 1e-3 and \
            gaps["overlap"] <= 0.45 and gaps["uncovered"] == 0, gaps


def test_greedy_nms_suppresses_above_the_threshold_only():
    from portbench.reference.detect import greedy_nms
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 4.5 + 1e-3],
                      [0, 0, 10, 4.5 - 1e-3], [20, 20, 30, 30]], np.float32)
    # box 1 overlaps box 0 at IoU just above 0.45 and is dropped; box 2
    # just below it and stays
    assert greedy_nms(boxes, 0.45) == [0, 2, 3]
