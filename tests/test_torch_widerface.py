"""The WIDER evaluation path of yunet_tpu_torch against yunet_tpu's:

  * native.wider_match (C++) == _wider_match_numpy == JAX's wider_match,
    integer outputs equal;
  * norm_scores, voc_ap, _img_pr_info, wider_evaluation and eval_map
    EQUAL to JAX's on GT dirs that the port's write_gt_mats writes, and
    that writer's files read back equal to JAX's writer's;
  * parse_labelv2, the decoded-image cache, AutoRank and the mode table
    against JAX's on a tools/make_synth_wider.py --tier hard val split;
  * the CLI (yunet_tpu_torch.tools.test_widerface.main) against
    tools/test_widerface.py:main on that split, modes 0 and 2: in bf16 on
    the CPU (as shipped) the same dump files, APs within AP_TOL and line
    counts within BF16_ROWS; in f32 the same line counts and APs within
    1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from yunet_tpu import native as jax_native
from yunet_tpu.eval import widerface as jw
from yunet_tpu_torch import native
from yunet_tpu_torch.eval import widerface as tw
from yunet_tpu_torch.tools.make_synth_wider import write_gt_mats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
# the two CLIs' APs: two bf16 trunks on the CPU, rounded at different
# places, move a detection's score in its third digit
AP_TOL = 0.02
# bf16 dump rows an image may differ by: 5 or 3% of the count
BF16_ROWS = lambda n: max(5, int(0.03 * n))  # noqa: E731


def _match_case(rng, n, m, ignore_frac=0.2):
    """Score-desc predictions (n, 5) xywh+score scattered around m GTs
    (m, 4) xywh, and a keep mask with ~ignore_frac ignored faces."""
    gts = np.concatenate([rng.uniform(0, 300, (m, 2)),
                          rng.uniform(4, 80, (m, 2))], 1).astype(np.float32)
    pick = rng.randint(0, max(m, 1), n)
    preds = np.zeros((n, 5), np.float32)
    if m:
        preds[:, :4] = gts[pick] + rng.normal(0, 3, (n, 4))
    far = rng.uniform(size=n) < 0.2
    preds[far, :2] = rng.uniform(400, 600, (int(far.sum()), 2))
    preds[:, 2:4] = np.abs(preds[:, 2:4]) + 1
    preds[:, 4] = np.sort(rng.uniform(size=n))[::-1]
    keep = (rng.uniform(size=m) > ignore_frac).astype(np.int32)
    return preds, gts, keep


@pytest.mark.parametrize("seed", range(12))
def test_wider_match_native_plain_and_jax_equal(seed):
    rng = np.random.RandomState(seed)
    n, m = rng.randint(1, 60), rng.randint(1, 30)
    preds, gts, keep = _match_case(rng, n, m)
    for thr in (0.5, 0.3):
        got = native.wider_match(preds, gts, keep, thr)
        for other in (native._wider_match_numpy(preds, gts, keep, thr),
                      jax_native.wider_match(preds, gts, keep, thr)):
            for g, o in zip(got, other):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, o)


def test_wider_match_ignore_and_claimed_twice():
    """Two predictions on one evaluated face: the second is a proposal but
    claims nothing; a prediction on an ignored face is not a proposal."""
    gts = np.asarray([[10, 10, 20, 20], [100, 100, 30, 30]], np.float32)
    keep = np.asarray([1, 0], np.int32)
    preds = np.asarray([[10, 10, 20, 20, 0.9], [11, 10, 20, 20, 0.8],
                        [100, 100, 30, 30, 0.7], [300, 300, 5, 5, 0.6]],
                       np.float32)
    for fn in (native.wider_match, native._wider_match_numpy,
               jax_native.wider_match):
        recall, proposal = fn(preds, gts, keep, 0.5)
        np.testing.assert_array_equal(recall, [1, 1, 1, 1])
        np.testing.assert_array_equal(proposal, [1, 1, -1, 1])
    with pytest.raises(ValueError):
        native.wider_match(preds[:, :4], gts, keep, 0.5)


def _per_event(rng, n_events=3, n_imgs=5):
    """{event: [(stem, boxes xyxy, kps, ignore)]}: heights 3-140 px (all
    three subsets differ), ~10% ignored faces, one image without faces."""
    per_event = {}
    for i in range(n_events):
        imgs = []
        for j in range(n_imgs):
            n = 0 if (i, j) == (0, 0) else rng.randint(1, 20)
            xy = rng.uniform(0, 900, (n, 2))
            wh = rng.uniform(3, 140, (n, 2))
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            ign = rng.uniform(size=n) < 0.1
            imgs.append((f"img_{i}_{j}", boxes,
                         np.zeros((n, 5, 3), np.float32), ign))
        per_event[f"{i}--Ev"] = imgs
    return per_event


def _predictions(rng, per_event):
    """xywh+score predictions: noisy copies of most faces plus FPs."""
    pred = {}
    for ev, imgs in per_event.items():
        pred[ev] = {}
        for stem, boxes, _, _ in imgs:
            xywh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]],
                                  1)
            hit = xywh[rng.uniform(size=len(xywh)) < 0.8]
            hit = hit + rng.normal(0, 2, hit.shape)
            fp = np.concatenate([rng.uniform(0, 900, (3, 2)),
                                 rng.uniform(5, 60, (3, 2))], 1)
            rows = np.concatenate([hit, fp], 0)
            scores = rng.uniform(0.05, 0.99, (len(rows), 1))
            rows = np.concatenate([rows, scores], 1)
            pred[ev][stem] = rows[np.argsort(-rows[:, 4], kind="stable")]
    return pred


@pytest.fixture(scope="module")
def gt_case(tmp_path_factory):
    rng = np.random.RandomState(3)
    per_event = _per_event(rng)
    gt_dir = str(tmp_path_factory.mktemp("gt_port"))
    write_gt_mats(gt_dir, per_event)
    return per_event, gt_dir, _predictions(rng, per_event)


def test_write_gt_mats_reads_back_equal_to_jax(gt_case, tmp_path):
    import make_synth_wider as gen
    per_event, gt_dir, _ = gt_case
    gen.write_gt_mats(str(tmp_path), per_event)
    got, want = jw.load_gt(gt_dir), jw.load_gt(str(tmp_path))

    def same(a, b):
        if isinstance(a, np.ndarray) and a.dtype == object:
            assert a.shape == b.shape
            for x, y in zip(a.ravel(), b.ravel()):
                same(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got[:3], want[:3]):
        same(g, w)
    for s in ("easy", "medium", "hard"):
        same(got[3][s], want[3][s])
    # the subsets differ, and an ignored face is in no keep list
    sizes = [sum(len(k) for ev in got[3][s][:, 0] for k in ev[:, 0])
             for s in ("easy", "medium", "hard")]
    n_faces = sum(len(b) for imgs in per_event.values() for _, b, _, _ in imgs)
    n_ign = sum(int(i.sum()) for imgs in per_event.values()
                for _, _, _, i in imgs)
    assert sizes[0] < sizes[1] < sizes[2] == n_faces - n_ign


def test_wider_evaluation_equals_jax(gt_case):
    _, gt_dir, pred = gt_case
    got = tw.wider_evaluation(pred, gt_dir)
    want = jw.wider_evaluation(pred, gt_dir)
    assert got == want
    assert len(set(got)) == 3 and all(0 < a < 1 for a in got)


def test_widerface_helpers_equal_jax(gt_case):
    rng = np.random.RandomState(5)
    _, _, pred = gt_case
    got, want = tw.norm_scores(pred), jw.norm_scores(pred)
    for ev in want:
        for k in want[ev]:
            np.testing.assert_array_equal(got[ev][k], want[ev][k])
    rec = np.sort(rng.uniform(size=50))
    prec = rng.uniform(size=50)
    assert tw.voc_ap(rec, prec) == jw.voc_ap(rec, prec)
    scores = np.sort(rng.uniform(size=40))[::-1]
    proposal = np.where(rng.uniform(size=40) < 0.2, -1, 1)
    recall = np.cumsum(rng.uniform(size=40) < 0.5)
    np.testing.assert_array_equal(tw._img_pr_info(scores, proposal, recall),
                                  jw._img_pr_info(scores, proposal, recall))


def test_eval_map_equals_jax():
    rng = np.random.RandomState(6)
    dets, anns = [], []
    for i in range(8):
        m = rng.randint(0, 10)
        gt = np.concatenate([rng.uniform(0, 200, (m, 2)),
                             rng.uniform(0, 200, (m, 2)) + 10], 1)
        gt[:, 2:] += gt[:, :2]
        ig = gt[:1] + 1 if (i % 3 == 0 and m) else np.zeros((0, 4))
        d = np.concatenate([gt + rng.normal(0, 3, gt.shape),
                            rng.uniform(0, 400, (3, 4))], 0)
        d[:, 2:] = np.maximum(d[:, 2:], d[:, :2] + 1)
        d = np.concatenate([d, rng.uniform(size=(len(d), 1))], 1)
        dets.append(d)
        anns.append({"bboxes": gt, "bboxes_ignore": ig})
    got, want = tw.eval_map(dets, anns), jw.eval_map(dets, anns)
    assert got == want and 0 < got < 1
    for det, ann in zip(dets, anns):
        for g, w in zip(tw._tpfp(det, ann["bboxes"], ann["bboxes_ignore"],
                                 0.5),
                        jw._tpfp(det, ann["bboxes"], ann["bboxes_ignore"],
                                 0.5)):
            np.testing.assert_array_equal(g, w)


# -- a tools/make_synth_wider.py --tier hard val split ------------------------

@pytest.fixture(scope="module")
def hard_split(tmp_path_factory):
    """Four hard-tier val images (JPEGs), labelv2.txt and the GT mats, as
    make_synth_wider.py writes them, plus the port's decoded cache."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    root = tmp_path_factory.mktemp("synth_hard")
    val = str(root / "val")
    per_event = gen.generate_split(val, 4, 11, tier=gen.TIERS["hard"])
    gen.write_gt_mats(os.path.join(val, "gt"), per_event)
    cache = str(root / "cache")
    ann = os.path.join(val, "labelv2.txt")
    assert build_decoded_cache(ann, os.path.join(val, "images"), cache,
                               verbose=False) == 4
    return val, cache


@pytest.mark.parametrize("kw", [dict(test_mode=True), dict(),
                                dict(min_size=10.0)])
def test_parse_labelv2_equals_jax(hard_split, kw):
    from yunet_tpu.data.labelv2 import parse_labelv2 as jax_parse
    from yunet_tpu_torch.data import parse_labelv2
    ann = os.path.join(hard_split[0], "labelv2.txt")
    got, want = parse_labelv2(ann, **kw), jax_parse(ann, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("filename", "width", "height"):
            assert getattr(g, field) == getattr(w, field)
        for field in ("bboxes", "labels", "kps", "bboxes_ignore"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sum(len(r.bboxes_ignore) for r in got) > 0 or "min_size" not in kw


def test_decoded_cache_equals_jax(hard_split):
    import cv2
    from yunet_tpu.data import cache as jc
    from yunet_tpu_torch.data import cache as tc
    from yunet_tpu_torch.data import parse_labelv2
    val, cache = hard_split
    for rec in parse_labelv2(os.path.join(val, "labelv2.txt"),
                             test_mode=True):
        assert tc.cache_path(cache, rec.filename) == \
            jc.cache_path(cache, rec.filename)
        img = tc.load_cached(cache, rec.filename)
        np.testing.assert_array_equal(
            img, cv2.imread(os.path.join(val, "images", rec.filename)))
        np.testing.assert_array_equal(img, jc.load_cached(cache,
                                                          rec.filename))
    assert tc.load_cached(cache, "nope/none.jpg") is None
    for short, scale, out in ((1024, 1.0, 640), (1024, 0.3, 64),
                              (500, 2.0, 640), (4000, 1.0, 100)):
        assert tc.pick_reduction(short, scale, out) == \
            jc.pick_reduction(short, scale, out)


def test_autorank_and_eval_modes_equal_jax(tmp_path):
    from yunet_tpu.eval.eval_hook import widerface_eval_mode as jax_mode
    from yunet_tpu.utils.autorank import AutoRank as JaxAutoRank
    from yunet_tpu_torch.eval import widerface_eval_mode
    from yunet_tpu_torch.utils.autorank import AutoRank
    for mode in (0, 1, 2, 31, 640):
        assert widerface_eval_mode(mode) == jax_mode(mode)
    with pytest.raises(ValueError):
        widerface_eval_mode(5)
    rows = [({"easy": 0.9, "medium": 0.8, "hard": 0.5}, "a"),
            ({"easy": 0.7, "medium": 0.6, "hard": 0.65}, "b")]
    for cls, path in ((AutoRank, tmp_path / "t.log"),
                      (JaxAutoRank, tmp_path / "j.log")):
        for aps, tag in rows:
            cls(str(path)).update(aps, tag=tag)
    strip = [[{k: v for k, v in json.loads(line).items() if k != "time"}
              for line in p.read_text().splitlines()]
             for p in (tmp_path / "t.log", tmp_path / "j.log")]
    assert strip[0] == strip[1] and strip[0][0]["tag"] == "b"


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("mode", [0, 2])
def test_cli_matches_jax_cli(hard_split, tmp_path, monkeypatch, mode,
                             precision):
    """The port's CLI (decoded cache) and JAX's (JPEGs through cv2) on the
    same split and weights: the same dump files, one AutoRank row each.
    bf16 (the CLIs as shipped): APs within AP_TOL; the two trunks round at
    different places, so a few detections near the score threshold come
    and go, and the line counts agree within BF16_ROWS. f32 (both Detectors built in f32 by patching
    the tests' side only): the same line counts, APs within 1e-6."""
    import functools
    import torch
    import detect_image
    import test_widerface as jax_cli
    import yunet_tpu.eval
    from yunet_tpu_torch.tools import test_widerface as cli
    from yunet_tpu_torch.utils.jax_params import load_flat_npz
    monkeypatch.setattr(detect_image, "load_weights",
                        lambda cfg, path: load_flat_npz(path, cfg.model))
    if precision == "f32":
        monkeypatch.setattr(yunet_tpu.eval, "Detector", functools.partial(
            yunet_tpu.eval.Detector, bf16=False))
        monkeypatch.setattr(cli, "init_detector", functools.partial(
            cli.init_detector, dtype=torch.float32))
    val, cache = hard_split
    common = ["yunet_n", FIXTURE, "--mode", str(mode),
              "--ann", os.path.join(val, "labelv2.txt"),
              "--gt-dir", os.path.join(val, "gt")]
    want = jax_cli.main(common + [
        "--img-prefix", os.path.join(val, "images"),
        "--out", str(tmp_path / "jax"),
        "--eval-log", str(tmp_path / "jax.log")])
    got = cli.main(common + [
        "--cache-dir", cache, "--out", str(tmp_path / "port"),
        "--eval-log", str(tmp_path / "port.log")], device="cpu")
    assert all(np.isfinite(got)) and all(0 <= a <= 1 for a in got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=AP_TOL if precision == "bf16" else 1e-6)

    def dump(d):
        return {os.path.relpath(os.path.join(p, f), d): open(
            os.path.join(p, f)).read().splitlines()
                for p, _, fs in os.walk(d) for f in fs}
    gd, wd = dump(str(tmp_path / "port")), dump(str(tmp_path / "jax"))
    assert sorted(gd) == sorted(wd) and len(gd) == 4
    for name in wd:
        assert gd[name][0] == wd[name][0]
        assert int(gd[name][1]) == len(gd[name]) - 2
        rows = (0 if precision == "f32"
                else BF16_ROWS(len(wd[name]) - 2))
        assert abs(len(gd[name]) - len(wd[name])) <= rows, name
    for log in ("port.log", "jax.log"):
        assert len((tmp_path / log).read_text().splitlines()) == 1


def test_cli_missing_image_raises(hard_split, tmp_path):
    from yunet_tpu_torch.tools import test_widerface as cli
    val, _ = hard_split
    with pytest.raises(SystemExit, match="missing image"):
        cli.main(["yunet_n", FIXTURE, "--mode", "0",
                  "--ann", os.path.join(val, "labelv2.txt"),
                  "--cache-dir", str(tmp_path / "empty"),
                  "--eval-log", str(tmp_path / "x.log")], device="cpu")


def test_port_imports_no_jax_no_cv2_and_names_no_jax_module():
    """The new modules import neither jax, yunet_tpu nor cv2; no module of
    the port and not chip_smoke.py imports jax, yunet_tpu or tools/, and
    eval/detect.py does not import cv2 at all."""
    import re
    mods = ("yunet_tpu_torch.eval, yunet_tpu_torch.eval.widerface, "
            "yunet_tpu_torch.tools.test_widerface, yunet_tpu_torch.data, "
            "yunet_tpu_torch.data.cache, yunet_tpu_torch.utils.autorank, "
            "yunet_tpu_torch.tools.make_synth_wider, "
            "yunet_tpu_torch.ops.resize")
    code = ("import sys; before = set(sys.modules); "
            f"import {mods}; "
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'yunet_tpu', 'cv2')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    banned = re.compile(r"^\s*(import|from)\s+(jax|yunet_tpu|tools)(\.|\s|$)",
                        re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, fs in os.walk(os.path.join(ROOT, "yunet_tpu_torch")):
        files += [os.path.join(dirpath, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not banned.search(src), path
    with open(os.path.join(ROOT, "yunet_tpu_torch", "eval", "detect.py")) as f:
        assert not re.search(r"^\s*(import|from)\s+cv2", f.read(), re.M)
