"""The export CLIs and detect_image on the port, run in-process on the CPU
against the JAX package's CLIs on the same weights (the r04 EMA params as
a reference-layout .pth): the files they write and the lines they print.

  * detect_image: .npy in and out (JAX's: .png in and out, through cv2),
    f32 detectors on both sides, host NMS and --fused --device-nms: the
    printed lines and the drawn image equal; the numpy drawing equals
    cv2.rectangle / cv2.circle; .ppm output; other formats through cv2,
    and a clear error without it;
  * yunet2onnx --verify (static, dynamic), yunet2cpp, yunet2tflite --verify
    (none, dynamic): byte-equal files and equal lines (the port's verify
    line names the torch model where JAX's names the JAX model);
  * get_flops: equal lines; the int8 calibration images equal JAX's.
"""

import functools
import os
import sys

import cv2
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The r04 weights as a .pth, and a synthetic face image (the kind r04
    was trained on) as .npy and .png."""
    from make_synth_wider import make_image
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    d = tmp_path_factory.mktemp("cli")
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, yunet_n().model))
    pth = str(d / "r04.pth")
    torch.save({"meta": {"epoch": 0}, "state_dict": sd}, pth)
    img = make_image(np.random.RandomState(3), 224, 160)[0]
    np.save(str(d / "face.npy"), img)
    cv2.imwrite(str(d / "face.png"), img)
    return d, pth


def _lines(capsys, fn, *args, **kwargs):
    capsys.readouterr()
    out = fn(*args, **kwargs)
    return out, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flags", [[], ["--fused", "--device-nms"]])
def test_detect_image_matches_jax(files, flags, capsys, monkeypatch):
    import detect_image as jax_cli
    import yunet_tpu.eval
    from yunet_tpu_torch.tools import detect_image as cli
    d, pth = files
    # f32 trunks on both sides: the same detections, so the same pixels
    monkeypatch.setattr(yunet_tpu.eval, "Detector", functools.partial(
        yunet_tpu.eval.Detector, bf16=False))
    monkeypatch.setattr(cli, "Detector", functools.partial(
        cli.Detector, dtype=torch.float32))
    tag = "_".join(f.strip("-") for f in flags)
    _, want = _lines(capsys, jax_cli.main, [
        "yunet_n", pth, str(d / "face.png"), "--out",
        str(d / f"jax{tag}.png")] + flags)
    out = str(d / f"port{tag}.npy")
    result, got = _lines(capsys, cli.main, [
        "yunet_n", pth, str(d / "face.npy"), "--out", out] + flags,
        device="cpu")
    assert int(want[0].split()[0]) > 0
    assert got[:-1] == want[:-1]
    assert got[-1] == f"output: {out}"
    assert result["bboxes"].shape[0] == int(got[0].split()[0])
    np.testing.assert_array_equal(np.load(out),
                                  cv2.imread(str(d / f"jax{tag}.png")))


def test_detect_image_formats(files, capsys, monkeypatch):
    """bf16 (the CLI's trunk): .npy and .png in give the same result;
    .ppm out holds the .npy's pixels; without cv2 a .png raises a clear
    error."""
    from yunet_tpu_torch.tools import detect_image as cli
    d, pth = files
    common = ["yunet_n", pth, "--no-kps"]
    a, lines_a = _lines(capsys, cli.main, common[:2] + [
        str(d / "face.npy"), "--out", str(d / "b.npy"), "--no-kps"],
        device="cpu")
    b, lines_b = _lines(capsys, cli.main, common[:2] + [
        str(d / "face.png"), "--out", str(d / "b.ppm"), "--no-kps"],
        device="cpu")
    assert lines_a[:-1] == lines_b[:-1]
    np.testing.assert_array_equal(a["bboxes"], b["bboxes"])
    with open(d / "b.ppm", "rb") as f:
        assert f.read(2) == b"P6"
    np.testing.assert_array_equal(cv2.imread(str(d / "b.ppm")),
                                  np.load(d / "b.npy"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="OpenCV"):
        cli.main(common[:2] + [str(d / "face.png")], device="cpu")
    with pytest.raises(SystemExit, match="OpenCV"):
        cli.main(common[:2] + [str(d / "face.npy"), "--out",
                               str(d / "x.jpg")], device="cpu")


def test_drawing_equals_cv2():
    """draw_box == cv2.rectangle(..., 2) for any corners (in or off the
    image, either order); draw_point == cv2.circle(..., 1, ..., 2) for a
    centre in the image."""
    from yunet_tpu_torch.tools.detect_image import draw_box, draw_point
    rng = np.random.RandomState(0)
    for _ in range(500):
        h, w = (int(v) for v in rng.randint(5, 60, 2))
        want = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = want.copy()
        p1 = tuple(int(v) for v in rng.randint(-20, 80, 2))
        p2 = tuple(int(v) for v in rng.randint(-20, 80, 2))
        c = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        cv2.rectangle(want, p1, p2, (0, 0, 255), 2)
        cv2.circle(want, c, 1, (255, 0, 0), 2)
        draw_box(got, *p1, *p2)
        draw_point(got, *c)
        np.testing.assert_array_equal(got, want)


def _verify_line(lines):
    return [x.replace("the torch model", "the JAX model") for x in lines]


@pytest.mark.parametrize("dynamic", [False, True])
def test_yunet2onnx_matches_jax(files, dynamic, capsys):
    import yunet2onnx as jax_cli
    from yunet_tpu_torch.tools import yunet2onnx as cli
    d, pth = files
    extra = ["--dynamic"] if dynamic else ["--shape", "160", "192"]
    _, want = _lines(capsys, jax_cli.main, [
        "yunet_n", pth, "--output", str(d / "jax.onnx"), "--verify"] + extra)
    _, got = _lines(capsys, cli.main, [
        "yunet_n", pth, "--output", str(d / "port.onnx"), "--verify"]
        + extra, device="cpu")
    assert _verify_line(got) == [x.replace("jax.onnx", "port.onnx")
                                 for x in want]
    assert got[-1] == ("verification passed: onnx outputs match the torch "
                       "model")
    with open(d / "jax.onnx", "rb") as a, open(d / "port.onnx", "rb") as b:
        assert a.read() == b.read()


def test_yunet2cpp_matches_jax(files, capsys):
    import yunet2cpp as jax_cli
    from yunet_tpu_torch.tools import yunet2cpp as cli
    d, pth = files
    _, want = _lines(capsys, jax_cli.main, [
        "yunet_n", pth, "--output-file", str(d / "jax" / "data.cpp")])
    _, got = _lines(capsys, cli.main, [
        "yunet_n", pth, "--output-file", str(d / "port" / "data.cpp")])
    assert got == [x.replace(str(d / "jax"), str(d / "port")) for x in want]
    assert got[2].startswith("Flops: ") and got[3].startswith("Params: ")
    with open(d / "jax" / "data.cpp") as a, \
            open(d / "port" / "data.cpp") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("quantize", ["none", "dynamic"])
def test_yunet2tflite_matches_jax(files, quantize, capsys):
    pytest.importorskip("tensorflow")
    import yunet2tflite as jax_cli
    from yunet_tpu_torch.tools import yunet2tflite as cli
    d, pth = files
    common = ["--shape", "96", "128", "--quantize", quantize, "--verify"]
    rc, want = _lines(capsys, jax_cli.main, [
        "yunet_n", pth, "--output", str(d / "jax.tflite")] + common)
    assert rc == 0
    rc, got = _lines(capsys, cli.main, [
        "yunet_n", pth, "--output", str(d / "port.tflite")] + common)
    assert rc == 0
    assert _verify_line(got) == [x.replace("jax.tflite", "port.tflite")
                                 for x in want]
    assert got[-1].startswith("verification passed")
    with open(d / "jax.tflite", "rb") as a, \
            open(d / "port.tflite", "rb") as b:
        assert a.read() == b.read()


def test_rep_images_equal_jax(tmp_path):
    """The int8 calibration batches: the synthetic renders, and a
    directory of images (the port reads .npy and resizes with
    ops/resize.py; JAX reads .png and resizes with cv2)."""
    import yunet2tflite as jax_cli
    from yunet_tpu_torch.tools import yunet2tflite as cli
    for a, b in zip(cli.rep_images(96, 128, count=3),
                    jax_cli.rep_images(96, 128, count=3)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(4)
    (tmp_path / "png").mkdir()
    (tmp_path / "npy").mkdir()
    for i, (h, w) in enumerate(((120, 200), (300, 170), (96, 128))):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(tmp_path / "png" / f"{i}.png"), img)
        np.save(str(tmp_path / "npy" / f"{i}.npy"), img)
    got = list(cli.rep_images(96, 128, str(tmp_path / "npy")))
    want = list(jax_cli.rep_images(96, 128, str(tmp_path / "png")))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["yunet_n", "yunet_s"])
def test_get_flops_matches_jax(name, capsys):
    import get_flops as jax_cli
    from yunet_tpu_torch.tools import get_flops as cli
    for shape in (["--shape", "320", "320"], ["--shape", "256", "320"]):
        _, want = _lines(capsys, jax_cli.main, [name] + shape)
        _, got = _lines(capsys, cli.main, [name] + shape)
        assert got == want and len(got) == 5
