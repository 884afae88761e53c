"""The port's extended augmentation library (data/aug_extra.py,
data/auto_augment.py) and the OpenCV ops it replaces (ops/color.py,
ops/warp.py), on the CPU:

  * the uint8 colour conversions byte-equal to OpenCV (cv2 5.0) on EVERY
    input: each BGR triple for BGR->HSV and BGR->GRAY, each (H < 180, S,
    V) triple for HSV->BGR, through OpenCV's vector loop and through its
    scalar loop; then a sample in rows that take both;
  * warpPerspective (float32, INTER_LINEAR, constant border) within 1e-4
    of OpenCV on seeded affine and perspective maps and image sizes;
  * every transform against yunet_tpu's with the same RandomState: equal
    outputs (within 1e-2 where OpenCV's float resize stands in, the
    ops/resize.py tolerance; 1e-4 after a warp) and the same draws (the
    generators' next values agree);
  * neither module imports cv2: both run in a process where importing it
    fails.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from yunet_tpu.data import aug_extra as jax_aug
from yunet_tpu.data import auto_augment as jax_auto
from yunet_tpu_torch.data import aug_extra as aug
from yunet_tpu_torch.data import auto_augment as auto
from yunet_tpu_torch.ops.color import bgr_to_gray, bgr_to_hsv, hsv_to_bgr
from yunet_tpu_torch.ops.warp import warp_perspective

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP_ATOL = 1e-4
RESIZE_ATOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: these tests share the CPU with the other test
    workers, some of whose subprocesses have deadlines."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _all_bgr():
    a = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(a, a, a, indexing="ij")
    return np.stack([b, g, r], -1).reshape(-1, 3)


def _all_hsv():
    a = np.arange(256, dtype=np.uint8)
    h, s, v = np.meshgrid(np.arange(180, dtype=np.uint8), a, a,
                          indexing="ij")
    return np.stack([h, s, v], -1).reshape(-1, 3)


def _rows(px, width, chunk_rows):
    """The pixels as images of rows of ``width``, chunk_rows rows at a
    time (len(px) is a multiple of width)."""
    rows = px.reshape(-1, width, 3)
    for i in range(0, len(rows), chunk_rows):
        yield np.ascontiguousarray(rows[i:i + chunk_rows])


def _mixed(px, seed):
    """A 2^16-pixel sample of px in rows of 45: OpenCV's vector loop and
    its scalar remainder in every row."""
    pick = np.random.RandomState(seed).randint(0, len(px), 45 * 1456)
    return np.ascontiguousarray(px[pick].reshape(-1, 45, 3))


# every pixel through OpenCV's vector loops (rows of 4096) and through its
# scalar loops (rows of 1); then rows that take both
@pytest.mark.parametrize("width", [4096, 1, 45])
def test_bgr_to_hsv_and_gray_exhaustive(width):
    px = _all_bgr()
    imgs = ([_mixed(px, 0)] if width == 45
            else _rows(px, width, max(1, 2 ** 21 // width)))
    for img in imgs:
        t = torch.from_numpy(img)
        np.testing.assert_array_equal(bgr_to_hsv(t).numpy(),
                                      cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        np.testing.assert_array_equal(bgr_to_gray(t).numpy(),
                                      cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("width", [256, 1, 45])
def test_hsv_to_bgr_exhaustive(width):
    px = _all_hsv()
    imgs = ([_mixed(px, 1)] if width == 45
            else _rows(px, width, max(1, 2 ** 21 // width)))
    for img in imgs:
        np.testing.assert_array_equal(
            hsv_to_bgr(torch.from_numpy(img)).numpy(),
            cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("seed", range(6))
def test_warp_perspective_matches_cv2(seed):
    rng = np.random.RandomState(seed)
    for trial in range(6):
        h, w = rng.randint(5, 260, size=2)
        img = (rng.rand(h, w, 3) * 255).astype(np.float32)
        a = np.radians(rng.uniform(-30, 30))
        s = rng.uniform(0.5, 1.5)
        p = rng.uniform(-1e-3, 1e-3, 2) * (trial % 2)
        m = np.array([[np.cos(a) * s, -np.sin(a) * s + rng.uniform(-.1, .1),
                       rng.uniform(-20, 20)],
                      [np.sin(a) * s + rng.uniform(-.1, .1), np.cos(a) * s,
                       rng.uniform(-20, 20)], [p[0], p[1], 1]], np.float32)
        border = (114.0,) * 3 if trial % 3 else (128.0,) * 3
        want = cv2.warpPerspective(img, m, dsize=(int(w), int(h)),
                                   borderValue=border)
        got = warp_perspective(torch.from_numpy(img), m, (int(w), int(h)),
                               border).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


def test_warp_perspective_rejects_uint8():
    with pytest.raises(TypeError):
        warp_perspective(torch.zeros((4, 4, 3), dtype=torch.uint8),
                         np.eye(3, dtype=np.float32), (4, 4))


# -- transforms against yunet_tpu's ----------------------------------------

def _scene(h=100, w=150, n=3, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    c = rng.uniform(20, min(h, w) - 20, (n, 2))
    wh = rng.uniform(8, 20, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    kps = np.zeros((n, 5, 3), np.float32)
    kps[..., :2] = c[:, None, :] + rng.uniform(-3, 3, (n, 5, 2))
    kps[..., 2] = 1.0
    return img, boxes, kps


def _both(fn_jax, fn_port, seed, *args, **kw):
    """Both functions on copies of args with RandomState(seed); returns
    their outputs and checks that they drew the same numbers."""
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    cp = lambda a: a.copy() if isinstance(a, np.ndarray) else a  # noqa: E731
    out_j = fn_jax(*[cp(a) for a in args], rj, **kw)
    out_p = fn_port(*[cp(a) for a in args], rp, **kw)
    assert rj.randint(2 ** 31) == rp.randint(2 ** 31), "draws differ"
    return out_j, out_p


def _close(a, b, atol):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, atol)
        return
    assert np.shape(a) == np.shape(b)
    if atol == 0:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("seed", range(8))
def test_photometric_distortion_equal(seed):
    img, _, _ = _scene(seed=seed, w=151)
    j, p = _both(jax_aug.photometric_distortion,
                 aug.photometric_distortion, seed, img)
    _close(j, p, 0)


@pytest.mark.parametrize("seed", range(4))
def test_expand_crop_cutout_equal(seed):
    img, boxes, kps = _scene(seed=seed, h=200, w=200)
    _close(*_both(jax_aug.expand, aug.expand, seed, img, boxes, kps,
                  mean=(128, 128, 128)), 0)
    labels = np.zeros(len(boxes), np.int64)
    _close(*_both(jax_aug.min_iou_random_crop, aug.min_iou_random_crop,
                  seed, img, boxes, kps, labels), 0)
    _close(*_both(jax_aug.cutout, aug.cutout, seed, img), 0)


@pytest.mark.parametrize("seed", range(3))
def test_mosaic4_equal(seed):
    # two of the four images exceed out_size, so they are resized
    samples = [_scene(h=100 + 150 * (i % 2), w=150 + 120 * (i % 2),
                      seed=10 * seed + i) for i in range(4)]
    j, p = _both(jax_aug.mosaic4, aug.mosaic4, seed, samples, out_size=400)
    _close(j[0], p[0], RESIZE_ATOL)
    _close(j[1:], p[1:], 0)


@pytest.mark.parametrize("seed", range(4))
def test_random_affine_equal(seed):
    img, boxes, kps = _scene(seed=seed, w=173)
    j, p = _both(jax_aug.random_affine, aug.random_affine, seed, img,
                 boxes, kps)
    _close(j[0], p[0], WARP_ATOL)
    _close(j[1:], p[1:], 0)


@pytest.mark.parametrize("seed", range(4))
def test_mixup_equal(seed):
    img, boxes, kps = _scene(seed=seed)
    mimg, mboxes, mkps = _scene(h=130, w=90, seed=seed + 50)
    j, p = _both(jax_aug.mixup, aug.mixup, seed, img, boxes, kps, mimg,
                 mboxes, mkps, img_scale=(160, 160))
    _close(j[0], p[0], RESIZE_ATOL)
    _close(j[1:], p[1:], 0)


@pytest.mark.parametrize("op", ["shear", "rotate", "translate"])
@pytest.mark.parametrize("seed", range(3))
def test_auto_augment_geometric_equal(op, seed):
    img, boxes, kps = _scene(seed=seed, w=141)
    kw = {"level": 7, "prob": 0.9}
    if op != "rotate":
        kw["direction"] = "vertical" if seed % 2 else "horizontal"
    j, p = _both(getattr(jax_auto, op), getattr(auto, op), seed, img, boxes,
                 kps, **kw)
    _close(j[0], p[0], WARP_ATOL)
    _close(j[1:], p[1:], 0)


@pytest.mark.parametrize("op", ["adjust_color", "adjust_brightness",
                                "adjust_contrast", "equalize"])
@pytest.mark.parametrize("seed", range(3))
def test_auto_augment_photometric_equal(op, seed):
    img, _, _ = _scene(seed=seed)
    kw = {} if op == "equalize" else {"level": 3 + 2 * seed}
    _close(*_both(getattr(jax_auto, op), getattr(auto, op), seed, img,
                  prob=0.9, **kw), 0)


def test_rotation_matrix_matches_cv2():
    for center, angle, scale in (((31.5, 19.5), -17.3, 1.0),
                                 ((0.1, 3.3), 45.0, 1.2),
                                 ((99.5, 0.0), 0.0, 0.7)):
        np.testing.assert_array_equal(
            auto.rotation_matrix_2d(center, angle, scale),
            cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("seed", range(6))
def test_auto_augment_policies_equal(seed):
    img, boxes, kps = _scene(seed=seed, w=163)
    j, p = _both(
        lambda *a: jax_auto.auto_augment(*a, jax_auto.default_policies()),
        lambda *a: auto.auto_augment(*a, auto.default_policies()),
        seed, img, boxes, kps)
    _close(j[0], p[0], WARP_ATOL)
    _close(j[1:], p[1:], 0)


def test_runs_without_opencv():
    """Both modules, every transform, in a process where cv2 cannot be
    imported."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from yunet_tpu_torch.data import aug_extra as a, auto_augment as t\n"
        "rng = np.random.RandomState(0)\n"
        "img = rng.uniform(0, 255, (90, 120, 3)).astype(np.float32)\n"
        "b = np.array([[10, 10, 40, 50]], np.float32)\n"
        "k = np.zeros((1, 5, 3), np.float32); k[..., :2] = 25; k[..., 2] = 1\n"
        "a.photometric_distortion(img, rng)\n"
        "a.random_affine(img, b, k, rng)\n"
        "a.mosaic4([(img, b, k)] * 4, rng, out_size=100)\n"
        "a.mixup(img, b, k, img, b, k, rng, img_scale=(64, 64))\n"
        "for p in t.default_policies():\n"
        "    t.apply_policy(img, b, k, rng, [dict(d, prob=1.0) for d in p])\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
