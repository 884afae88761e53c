"""yunet_tpu_torch.ops.resize == cv2.resize(img, (w, h)) (INTER_LINEAR),
and the port's resize_img == yunet_tpu's (which calls cv2) in every mode.

uint8 is EQUAL to OpenCV byte for byte in every case: 11-bit fixed-point
weights, OpenCV's vector vertical pass (shift by 4, high 16 bits of the
product, rounding shift by 2) and its exact-2x switch to INTER_AREA.

f32 is held to 1e-2 (under a hundredth of a grey level), not to equality:
OpenCV's float route (Intel IPP in opencv-python) rounds inside its sums
its own way. test_resize_f32_within_tolerance_of_cv2 prints, per case,
the share of pixels that differ and by how much: 19-33% by at most
3.05e-5 (two ulps at 255), none where every tap is an integer, and 79.3%
by at most 6.2e-4 for the 1-pixel wide source.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from yunet_tpu.eval.detect import resize_img as jax_resize_img  # noqa: E402
from yunet_tpu_torch.eval.detect import resize_img  # noqa: E402
from yunet_tpu_torch.ops.resize import resize  # noqa: E402

F32_ATOL = 1e-2

CASES = [
    # (source (h, w), destination (w, h)), what the case covers
    ((100, 150), (96, 64)),         # down, non-integer ratios
    ((1536, 1024), (426, 640)),     # WIDER-like portrait to a 640 canvas
    ((576, 1024), (640, 360)),      # WIDER-like landscape, 1.6x down
    ((480, 640), (853, 640)),       # up, non-integer ratios
    ((33, 47), (427, 640)),         # large upscale
    ((7, 5), (9, 13)),              # small up
    ((300, 200), (100, 150)),       # exact 2x down: INTER_AREA
    ((1024, 1280), (640, 512)),     # exact 2x down at WIDER size
    ((301, 200), (100, 150)),       # 2x on one axis only: linear
    ((90, 90), (30, 30)),           # exact 3x down: linear, integer taps
    ((1, 9), (4, 3)),               # a 1-pixel high source
    ((70, 1), (255, 103)),          # a 1-pixel wide source
    ((20, 20), (1, 1)),             # a 1-pixel destination
    ((1, 1), (5, 5)),               # a single pixel up
]


def _img(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 255, shape).astype(dtype)


@pytest.mark.parametrize("channels", [3, None])
@pytest.mark.parametrize("src,dsize", CASES)
def test_resize_uint8_equals_cv2(src, dsize, channels):
    shape = src if channels is None else (*src, channels)
    img = _img(shape, np.uint8, sum(src) + sum(dsize))
    want = cv2.resize(img, dsize)
    got = resize(torch.from_numpy(img), dsize).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dsize", CASES)
def test_resize_f32_within_tolerance_of_cv2(src, dsize):
    """Prints the share of pixels that differ and the largest difference
    (pytest -s)."""
    img = _img((*src, 3), np.float32, sum(src) + sum(dsize))
    want = cv2.resize(img, dsize)
    got = resize(torch.from_numpy(img), dsize).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    print(f"f32 {src} -> {dsize}: {np.mean(diff > 0):.1%} of pixels "
          f"differ, by at most {diff.max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_resize_seeded_sweep_uint8_equals_cv2():
    """200 seeded random shapes, up and down, 1-399 px a side."""
    rng = np.random.RandomState(1)
    for _ in range(200):
        sh, sw = rng.randint(1, 400, 2)
        dw, dh = (int(v) for v in rng.randint(1, 400, 2))
        img = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            resize(torch.from_numpy(img), (dw, dh)).numpy(),
            cv2.resize(img, (dw, dh)), err_msg=f"{(sh, sw)} -> {(dw, dh)}")


def test_resize_rejects_other_dtypes_and_sizes():
    with pytest.raises(TypeError):
        resize(torch.zeros((4, 4, 3), dtype=torch.int16), (2, 2))
    with pytest.raises(ValueError):
        resize(torch.zeros((4, 4, 3), dtype=torch.uint8), (0, 2))


@pytest.mark.parametrize("mode", [(640, 640), (96, 64), (64, 96), "VGA",
                                  "ORIGIN", "AUTO", "640,480"])
@pytest.mark.parametrize("hw", [(100, 150), (150, 100), (480, 640),
                                (333, 333), (1536, 1024)])
def test_resize_img_matches_jax(mode, hw):
    img = _img((*hw, 3), np.uint8, hw[0] * 7 + hw[1])
    want, want_scale = jax_resize_img(img, mode)
    got, got_scale = resize_img(img, mode)
    assert got_scale == want_scale
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,hw", [((640, 640), (640, 640)),
                                     ("640,480", (480, 640)),
                                     ("640,480", (640, 480))])
def test_resize_img_frame_of_the_canvas_size(mode, hw):
    """A frame of its canvas's size (square, landscape, portrait) gives the
    bits and det_scale of a letterbox onto a new zeroed canvas, and JAX's;
    the caller's frame, read-only here, is never written."""
    img = _img((*hw, 3), np.uint8, hw[0] + 3 * hw[1])
    was = img.copy()
    img.setflags(write=False)
    got, scale = resize_img(img, mode)
    letterbox = np.zeros_like(img)
    letterbox[:hw[0], :hw[1]] = img
    assert scale == 1.0 and got.dtype == img.dtype
    np.testing.assert_array_equal(got, letterbox)
    want, want_scale = jax_resize_img(img, mode)
    assert want_scale == scale
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(img, was)


def test_resize_img_f32_and_read_only_input():
    """A float image letterboxes within F32_ATOL of JAX's; a read-only
    (memory-mapped) image resizes without a copy warning."""
    img = _img((120, 200, 3), np.float32, 3)
    want, ws = jax_resize_img(img, (96, 64))
    got, gs = resize_img(img, (96, 64))
    assert gs == ws and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    ro = _img((120, 200, 3), np.uint8, 4)
    ro.setflags(write=False)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, _ = resize_img(ro, (96, 64))
    np.testing.assert_array_equal(got, jax_resize_img(ro, (96, 64))[0])
