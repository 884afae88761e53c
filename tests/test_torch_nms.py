"""yunet_tpu_torch device NMS (plain version, on the CPU) == yunet_tpu's
Pallas NMS kernels (interpret mode) and the host C++ NMS. keep, idx and
dets must be EQUAL: the same f32 IoU expression, the same top-k order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu import native as jax_native
from yunet_tpu.ops.nms_pallas import pallas_nms, pallas_nms_batched
from yunet_tpu_torch import native
from yunet_tpu_torch.ops.nms import (device_nms, device_nms_batched,
                                     greedy_nms_keep, greedy_nms_keep_plain)

IOU, SCORE = 0.45, 0.02


def _boxes(rng, n, size=200.0):
    # clustered boxes, so that many pairs overlap
    centers = rng.uniform(20, size - 20, (max(n // 8, 1), 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(8, 50, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _case(bsz, n, counts, seed, tied):
    """Scores with exactly counts[b] candidates above SCORE in image b;
    tied=True quantizes them to three values (many exact ties)."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([_boxes(rng, n) for _ in range(bsz)])
    scores = rng.uniform(0, 0.01, (bsz, n)).astype(np.float32)
    for b, cnt in enumerate(counts):
        hi = rng.uniform(0.1, 1.0, cnt)
        if tied:
            hi = np.round(hi * 2) / 2 + 0.25
        scores[b, rng.choice(n, cnt, replace=False)] = hi
    if tied:
        scores[scores < SCORE] = 0.005
    return boxes, scores


CASES = [(1, 150, (0,)), (1, 150, (1,)), (1, 150, (12,)), (1, 150, (60,)),
         (3, 300, (0, 12, 60)), (3, 300, (1, 60, 60))]


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("bsz,n,counts", CASES)
def test_batched_matches_pallas(bsz, n, counts, tied):
    boxes, scores = _case(bsz, n, counts, 10 * bsz + len(counts), tied)
    top_k = 128
    want = pallas_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                              top_k=top_k, iou_thr=IOU, score_thr=SCORE)
    got = device_nms_batched(torch.from_numpy(boxes),
                             torch.from_numpy(scores), top_k=top_k,
                             iou_thr=IOU, score_thr=SCORE)
    dets, keep, idx = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[1].numpy(), keep)
    np.testing.assert_array_equal(got[2].numpy(), idx)
    np.testing.assert_array_equal(got[0].numpy(), dets)
    for b, cnt in enumerate(counts):
        assert keep[b].sum() <= cnt
        # host C++ NMS on the candidates above the threshold
        valid = scores[b] >= SCORE
        host = native.nms(boxes[b][valid], scores[b][valid], IOU)
        np.testing.assert_array_equal(
            host, jax_native.nms(boxes[b][valid], scores[b][valid], IOU))
        np.testing.assert_array_equal(
            np.flatnonzero(valid)[host], got[2][b][got[1][b]].numpy())


@pytest.mark.parametrize("bsz,n,counts", CASES[:4] + [(1, 400, (300,))])
def test_per_image_matches_pallas(bsz, n, counts):
    boxes, scores = _case(bsz, n, counts, 7 + n, tied=False)
    top_k = 256
    want = pallas_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                      top_k=top_k, iou_thr=IOU, score_thr=SCORE)
    got = device_nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                     top_k=top_k, iou_thr=IOU, score_thr=SCORE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_keep_uses_each_images_own_count():
    """The plain loop over the largest count == image by image."""
    boxes, scores = _case(3, 200, (5, 60, 0), 3, tied=False)
    _, _, idx = device_nms_batched(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), top_k=100)
    top = torch.gather(torch.from_numpy(boxes), 1,
                       idx[..., None].expand(-1, -1, 4)).contiguous()
    counts = torch.tensor([5, 60, 0], dtype=torch.int32)
    keep = greedy_nms_keep(top, counts, IOU)
    for b in range(3):
        one = greedy_nms_keep_plain(top[b:b + 1], counts[b:b + 1], IOU)
        assert torch.equal(keep[b], one[0])
    assert not keep[2].any()


def test_keep_raises_on_device_without_kernel():
    with pytest.raises(ValueError):
        greedy_nms_keep(torch.zeros(1, 4, 4, device="meta"),
                        torch.zeros(1, dtype=torch.int32, device="meta"), IOU)


def _edge_case(name):
    """boxes (B, P, 4), scores (B, P) of a case where a keep set is easy
    to get wrong."""
    rng = np.random.RandomState(21)
    if name == "iou_at_threshold":
        # inter 45 over union 100 is 0.45 in f32, equal to the threshold:
        # kept, the test is strict; 4.6 wide gives IoU > 0.45
        boxes, scores = _case(1, 200, (30,), 21, tied=False)
        scores = scores * 0.5
        special = [(1000, 1000, 1010, 1010), (1000, 1000, 1004.5, 1010),
                   (2000, 2000, 2010, 2010), (2000, 2000, 2004.6, 2010)]
        for i, box in enumerate(special):
            boxes[0, i], scores[0, i] = box, 0.9 - 0.1 * i
        return boxes, scores
    if name == "iou_ulps_from_threshold":
        # 48 pairs whose IoUs step by an ulp of the width across 0.45: box
        # B of pair k is 4.5 + (k - 24) * 2^-21 wide, box A 10, both 10
        # high, the pairs far apart (below, at and above the threshold)
        boxes, scores = _case(1, 200, (0,), 24, tied=False)
        for k in range(48):
            y0 = 1000.0 + 100.0 * k
            boxes[0, 2 * k] = (0, y0, 10, y0 + 10)
            boxes[0, 2 * k + 1] = (0, y0, 4.5 + (k - 24) * 2.0 ** -21,
                                   y0 + 10)
            scores[0, 2 * k:2 * k + 2] = (0.9 - 0.01 * k, 0.895 - 0.01 * k)
        return boxes, scores
    if name == "zero_area_duplicates":
        # zero-width boxes, one point six times, inverted boxes (x2 < x1)
        # and duplicate pairs, with distinct (image 0) and tied (image 1)
        # scores
        boxes, scores = _case(2, 200, (60, 60), 22, tied=False)
        for b in range(2):
            top = np.argsort(-scores[b], kind="stable")[:60]
            bx = boxes[b, top]
            bx[0:8, 2] = bx[0:8, 0]
            bx[8:14] = np.tile(bx[8, :2], 2)
            bx[14:20, 3] = bx[14:20, 1] - 5
            bx[20:40:2] = bx[21:41:2]
            boxes[b, top] = bx
            if b:
                scores[b, top[20:40:2]] = scores[b, top[21:41:2]]
        return boxes, scores
    counts = (31, 32, 33, 63, 64, 65, 95, 96, 97)
    return _case(len(counts), 300, counts, 23, tied=False)


@pytest.mark.parametrize("name", ["iou_at_threshold",
                                  "iou_ulps_from_threshold",
                                  "zero_area_duplicates", "counts_around_32"])
def test_edge_cases_match_pallas(name):
    boxes, scores = _edge_case(name)
    top_k = 128
    want = pallas_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                              top_k=top_k, iou_thr=IOU, score_thr=SCORE)
    got = device_nms_batched(torch.from_numpy(boxes),
                             torch.from_numpy(scores), top_k=top_k,
                             iou_thr=IOU, score_thr=SCORE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(len(boxes)):                   # the per-image kernel
        one = pallas_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                         top_k=top_k, iou_thr=IOU, score_thr=SCORE)
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    if name == "iou_at_threshold":
        a = np.float32(100)
        inter = np.float32(4.5) * np.float32(10)
        assert inter / (a + inter - inter) == np.float32(IOU)
        kept = set(got[2][0][got[1][0]].tolist())
        assert {0, 1, 2} <= kept and 3 not in kept
    if name == "iou_ulps_from_threshold":            # both sides are hit
        kept_b = [k for k in range(48) if 2 * k + 1 in
                  set(got[2][0][got[1][0]].tolist())]
        assert 0 < len(kept_b) < 48
