"""The port's cross-engine harness (yunet_tpu_torch/tools/compare_inference
.py) against tools/compare_inference.py, on the CPU:

  * the numpy decoders (YuNet, SCRFD, RetinaFace and its priors,
    YOLO5Face), resize_img in every mode and TimeEngine's report: equal
    to JAX's on seeded inputs;
  * blob_from_image equal to cv2.dnn.blobFromImage;
  * --eval through the onnx: engine (the torch ONNX executor against JAX's
    bundled interpreter) on a 4-image make_synth_wider --tier hard split:
    APs within 1e-4;
  * --eval through the torch: engine against JAX's jax: engine, both in
    bf16 with device NMS: APs within the bf16 allowance of
    tests/test_torch_widerface.py (0.02);
  * the FPS mode on an .npy image, the jax: spec's error naming torch:, and
    a foreign-contract engine without onnxruntime failing with a clear
    error.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")

import compare_inference as jci  # noqa: E402

from yunet_tpu_torch.tools import compare_inference as pci  # noqa: E402

AP_TOL = 1e-4
BF16_AP_TOL = 0.02      # tests/test_torch_widerface.py BF16_ROWS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: these tests share the CPU with the other test
    workers, some of whose subprocesses have deadlines."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Four hard-tier val images with labelv2.txt and GT mats, the port's
    decoded cache, the r04 weights as a .pth and the port's ONNX export
    of them at 320^2."""
    import make_synth_wider as gen
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.data.cache import build_decoded_cache
    from yunet_tpu_torch.export.onnx_export import export_onnx
    from yunet_tpu_torch.models.detector import YuNet
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    root = tmp_path_factory.mktemp("ci")
    val = str(root / "val")
    per_event = gen.generate_split(val, 4, 23, tier=gen.TIERS["hard"])
    gen.write_gt_mats(os.path.join(val, "gt"), per_event)
    ann = os.path.join(val, "labelv2.txt")
    cache = str(root / "cache")
    build_decoded_cache(ann, os.path.join(val, "images"), cache,
                        verbose=False)
    cfg = yunet_n()
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, cfg.model))
    pth = str(root / "r04.pth")
    torch.save({"state_dict": sd}, pth)
    model = YuNet(cfg.model, device="cpu")
    model.load_state_dict(sd)
    onnx = str(root / "m320.onnx")
    with open(onnx, "wb") as f:
        f.write(export_onnx(model, cfg.model, input_shape=(320, 320)))
    return {"ann": ann, "images": os.path.join(val, "images"),
            "gt": os.path.join(val, "gt"), "cache": cache, "pth": pth,
            "onnx": onnx}


def test_yunet_decoder_equal():
    rng = np.random.RandomState(0)
    h, w = 96, 128
    outs = {}
    for s in (8, 16, 32):
        n = (h // s) * (w // s)
        outs[f"cls_{s}"] = rng.uniform(0, 1, (1, n, 1)).astype(np.float32)
        outs[f"obj_{s}"] = rng.uniform(0, 1, (1, n, 1)).astype(np.float32)
        outs[f"bbox_{s}"] = rng.normal(0, 0.5, (1, n, 4)).astype(np.float32)
        outs[f"kps_{s}"] = rng.normal(0, 1, (1, n, 10)).astype(np.float32)
    for a, b in zip(jci.numpy_decode_yunet(outs, (h, w), 0.1, 0.45),
                    pci.numpy_decode_yunet(outs, (h, w), 0.1, 0.45)):
        np.testing.assert_array_equal(a, b)


def test_foreign_decoders_equal():
    rng = np.random.RandomState(1)
    h = w = 64
    scrfd = [rng.uniform(0, 1, ((h // s) * (w // s) * 2, 1)).astype(
        np.float32) for s in (8, 16, 32)]
    scrfd += [rng.uniform(0, 3, ((h // s) * (w // s) * 2, 4)).astype(
        np.float32) for s in (8, 16, 32)]
    scrfd += [rng.normal(0, 1, ((h // s) * (w // s) * 2, 10)).astype(
        np.float32) for s in (8, 16, 32)]
    for a, b in zip(jci.numpy_decode_scrfd(scrfd, (h, w), 0.3),
                    pci.numpy_decode_scrfd(scrfd, (h, w), 0.3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jci.retinaface_priors((48, 80)),
                                  pci.retinaface_priors((48, 80)))
    n = len(pci.retinaface_priors((h, w)))
    retina = [rng.normal(0, 1, (1, n, 4)).astype(np.float32),
              rng.uniform(0, 1, (1, n, 2)).astype(np.float32),
              rng.normal(0, 1, (1, n, 10)).astype(np.float32)]
    for a, b in zip(jci.numpy_decode_retinaface(retina, (h, w), 0.5),
                    pci.numpy_decode_retinaface(retina, (h, w), 0.5)):
        np.testing.assert_array_equal(a, b)
    rows = rng.uniform(0, 1, (1, 300, 16)).astype(np.float32)
    rows[..., :4] *= 60
    for a, b in zip(jci.numpy_decode_yolo5face(rows, 0.2),
                    pci.numpy_decode_yolo5face(rows, 0.2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["AUTO", "ORIGIN", "320,320", "VGA",
                                  "640,480", "96,64", "150,100"])
def test_resize_img_equal(mode):
    rng = np.random.RandomState(2)
    for hw in ((100, 150), (151, 97), (480, 640), (64, 96)):
        img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        (a, sa), (b, sb) = jci.resize_img(img, mode), pci.resize_img(img,
                                                                     mode)
        assert sa == sb
        np.testing.assert_array_equal(a, b)


def test_time_engine_equal():
    reports = []
    for mod in (jci, pci):
        te = mod.TimeEngine()
        for key, total, n in (("preprocess", 0.25, 5), ("forward_run", 1.5,
                                                         5)):
            te(key).total, te(key).n = total, n
        reports.append((te.report(5), te.total_second(), te("x").fps))
    assert reports[0] == reports[1]


def test_blob_from_image_equals_cv2():
    img = np.random.RandomState(3).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        pci.blob_from_image(img, 1.0 / 128, (127.5, 127.5, 127.5)),
        cv2.dnn.blobFromImage(img, 1.0 / 128, (56, 40),
                              (127.5, 127.5, 127.5), swapRB=True))


def _eval_argv(split, models, mode, cache=True):
    argv = ["--models", *models, "--eval", "--ann", split["ann"],
            "--gt-dir", split["gt"], "--mode", mode]
    return argv + (["--cache-dir", split["cache"]] if cache
                   else ["--img-prefix", split["images"]])


def test_onnx_eval_aps_equal_jax(split):
    spec = f"onnx:{split['onnx']}"
    want = jci.main(_eval_argv(split, [spec], "320,320", cache=False))[spec]
    got = pci.main(_eval_argv(split, [spec], "320,320"), device="cpu")[spec]
    assert max(want) > 0.1, want
    np.testing.assert_allclose(got, want, rtol=0, atol=AP_TOL)
    # the port from the JPEGs (cv2) gives the same APs as from the cache
    jpeg = pci.main(_eval_argv(split, [spec], "320,320", cache=False),
                    device="cpu")[spec]
    np.testing.assert_allclose(jpeg, got, rtol=0, atol=AP_TOL)


def test_torch_engine_eval_vs_jax_engine(split):
    want = jci.main(_eval_argv(split, [f"jax:yunet_n:{split['pth']}"],
                               "320,320", cache=False))
    got = pci.main(_eval_argv(split, [f"torch:yunet_n:{split['pth']}"],
                              "320,320"), device="cpu")
    (want,), (got,) = want.values(), got.values()
    assert max(want) > 0.1, want
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_AP_TOL)


def test_fps_mode(split, tmp_path, capsys):
    from yunet_tpu_torch.data.cache import load_cached
    from yunet_tpu_torch.data.labelv2 import parse_labelv2
    rec = parse_labelv2(split["ann"], test_mode=True)[0]
    npy = str(tmp_path / "img.npy")
    np.save(npy, load_cached(split["cache"], rec.filename))
    specs = [f"torch:yunet_n:{split['pth']}", f"onnx:{split['onnx']}"]
    fps = pci.main(["--models", *specs, "--image", npy, "--iters", "2",
                    "--mode", "320,320"], device="cpu")
    assert set(fps) == set(specs) and all(v > 0 for v in fps.values())
    out = capsys.readouterr().out
    assert "forward_run" in out and "FPS" in out


def test_engine_spec_errors(split):
    with pytest.raises(SystemExit, match="torch:"):
        pci.build_engine(f"jax:yunet_n:{split['pth']}", device="cpu")
    with pytest.raises(SystemExit, match="unknown engine"):
        pci.build_engine("nope:x", device="cpu")
    try:
        import onnxruntime  # noqa: F401
    except ImportError:
        for kind in ("scrfd", "retinaface", "yolo5face"):
            with pytest.raises(SystemExit, match="onnxruntime"):
                pci.build_engine(f"{kind}:{split['onnx']}", device="cpu")
