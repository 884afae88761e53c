"""The port's host data pipeline (yunet_tpu_torch/data/transforms.py,
dataset.py) against yunet_tpu's, on the CPU: the same RandomState draws
give the same crop, the torch resize gives cv2.resize's bytes on uint8
(so boxes, keypoints and images are EQUAL), and WiderFaceDataset yields
equal samples from JPEGs (cv2 decode) and from the decoded .npy cache.
"""

import os
import sys

import numpy as np
import pytest

from yunet_tpu.data import dataset as jds
from yunet_tpu.data import transforms as jtr
from yunet_tpu_torch.data import dataset as tds
from yunet_tpu_torch.data import transforms as ttr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))


def make_train_split(root, n_images=8, seed=3):
    """A make_synth_wider --tier hard train split (JPEGs with landmarks,
    occluded -1 rows and ignore lines) and its decoded cache. Returns
    (labelv2 path, image prefix, cache dir)."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    split = os.path.join(root, "train")
    gen.generate_split(split, n_images, seed, tier=gen.TIERS["hard"])
    ann = os.path.join(split, "labelv2.txt")
    prefix, cache = os.path.join(split, "images"), os.path.join(root, "cache")
    assert build_decoded_cache(ann, prefix, cache, verbose=False) == n_images
    return ann, prefix, cache


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return make_train_split(str(tmp_path_factory.mktemp("train_split")))


def _scene(seed, h, w, n=5, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(dtype)
    xy = rng.uniform(0, [w - 20, h - 20], (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])],
                           1).astype(np.float32)
    kps = np.concatenate([rng.uniform(0, [w, h], (n, 5, 2)),
                          np.ones((n, 5, 1))], -1).astype(np.float32)
    ign = boxes[:2] + 1.0
    return img, boxes, kps, ign


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("crop_choice", [(0.5,), (0.3, 0.45, 0.6, 0.8, 1.0),
                                         (0.5, 0.7, 0.9, 1.1, 1.3, 1.5)])
@pytest.mark.parametrize("seed", range(4))
def test_random_square_crop_equals_jax(seed, crop_choice):
    """Crops that stay inside the image and crops padded past its edge;
    the rng is left in the same state."""
    img, boxes, kps, ign = _scene(seed, 150 + 17 * seed, 220)
    rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
    _equal(ttr.random_square_crop(img, boxes, kps, ign, crop_choice, rt),
           jtr.random_square_crop(img, boxes, kps, ign, crop_choice, rj))
    assert rt.randint(2 ** 31) == rj.randint(2 ** 31)


@pytest.mark.parametrize("src", [192, 60, 150, 96, 333])
@pytest.mark.parametrize("out", [(96, 96), (640, 640)])
def test_resize_with_targets_equals_jax(src, out):
    """Downscale, upscale, exact 2x (192 -> 96: OpenCV's INTER_AREA) and
    the identity: image byte-equal, boxes and keypoints equal."""
    img, boxes, kps, ign = _scene(src, src, src)
    _equal(ttr.resize_with_targets(img, boxes, kps, ign, out),
           jtr.resize_with_targets(img, boxes, kps, ign, out))


def test_resize_with_targets_reads_a_memory_map(tmp_path):
    img, boxes, kps, ign = _scene(7, 120, 130)
    np.save(tmp_path / "a.npy", img)
    mm = np.load(tmp_path / "a.npy", mmap_mode="r")
    _equal(ttr.resize_with_targets(mm, boxes, kps, ign, (96, 96)),
           jtr.resize_with_targets(img, boxes, kps, ign, (96, 96)))


def test_horizontal_flip_equals_jax():
    img, boxes, kps, ign = _scene(11, 90, 130)
    _equal(ttr.horizontal_flip(img, boxes, kps, ign),
           jtr.horizontal_flip(img, boxes, kps, ign))
    empty = np.zeros((0, 4), np.float32)
    _equal(ttr.horizontal_flip(img, boxes, kps, empty),
           jtr.horizontal_flip(img, boxes, kps, empty))


def _samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("source", ["jpeg", "cache", "reduced_jpeg"])
def test_get_train_sample_equals_jax(split, source):
    """Every image of the split, two seeds each, at 96^2 (downscaled
    crops) and 640^2 (upscaled ones): the port's samples from JPEGs, from
    the decoded cache or from reduced JPEG decodes equal JAX's from
    JPEGs (or reduced decodes)."""
    ann, prefix, cache = split
    for size in (96, 640):
        spec = tds.SampleSpec(img_size=size, max_gts=32)
        kw = {"cache": dict(decoded_cache=cache),
              "reduced_jpeg": dict(reduced_decode=True)}.get(source, {})
        ours = tds.WiderFaceDataset(ann, prefix, spec, **kw)
        theirs = jds.WiderFaceDataset(
            ann, prefix, jds.SampleSpec(img_size=size, max_gts=32),
            reduced_decode=source == "reduced_jpeg")
        assert len(ours) == len(theirs) == 8
        for idx in range(len(ours)):
            for seed in (idx, 100 + idx):
                got = ours.get_train_sample(idx, np.random.RandomState(seed))
                want = theirs.get_train_sample(idx,
                                               np.random.RandomState(seed))
                _samples_equal(got, want)
                assert got["image"].dtype == np.uint8
                assert got["gt_valid"].any()


def test_cache_miss_decodes_the_jpeg_and_missing_raises(split, tmp_path):
    """An image missing from the cache is decoded from its JPEG (as in
    JAX); an image in neither raises."""
    ann, prefix, _ = split
    spec = tds.SampleSpec(img_size=96, max_gts=32)
    empty = tds.WiderFaceDataset(ann, prefix, spec,
                                 decoded_cache=str(tmp_path / "none"))
    jpeg = tds.WiderFaceDataset(ann, prefix, spec)
    _samples_equal(empty.get_train_sample(0, np.random.RandomState(1)),
                   jpeg.get_train_sample(0, np.random.RandomState(1)))
    gone = tds.WiderFaceDataset(ann, str(tmp_path / "no_images"), spec)
    with pytest.raises(FileNotFoundError):
        gone.get_train_sample(0, np.random.RandomState(1))


@pytest.mark.parametrize("n,max_gts", [(3, 8), (8, 8), (13, 8), (40, 16)])
def test_pack_sample_equals_jax(n, max_gts):
    """Overflow keeps the largest faces (ties in input order) and counts
    the dropped ones."""
    rng = np.random.RandomState(n)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    xy = rng.uniform(0, 20, (n, 2))
    wh = rng.randint(1, 6, (n, 2)).astype(np.float64)   # area ties
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    kps = rng.uniform(0, 32, (n, 5, 3)).astype(np.float32)
    got = tds.pack_sample(img, boxes, kps, max_gts)
    _samples_equal(got, jds.pack_sample(img, boxes, kps, max_gts))
    assert int(got["num_overflow"]) == max(0, n - max_gts)
    if n > max_gts:
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        kept = got["gt_bboxes"]
        kept_area = (kept[:, 2] - kept[:, 0]) * (kept[:, 3] - kept[:, 1])
        assert kept_area.min() >= np.sort(area)[::-1][max_gts - 1]
    f32 = tds.pack_sample(img.astype(np.float32), boxes, kps, max_gts)
    assert f32["image"].dtype == np.float32
    batch = tds.pack_batch([got, got])
    _samples_equal(batch, jds.pack_batch([got, got]))
