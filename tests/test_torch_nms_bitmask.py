"""A CPU model of the greedy-NMS kernel's two launches (csrc/nms.cu),
held equal to the plain version (greedy_nms_keep_plain) and to yunet_tpu's
Pallas NMS kernels (interpret mode).

The model keeps the kernel's bit layout (bit c of word mask[i][w] is
column 32w + c; rows i < n, words floor(i/32) <= w < ceil(n/32); a row is
mask_words(K) words) and simulates its scan lane by lane: lane l owns the
removed words w = l + 32q, a shuffle is an index into the lanes'
registers, a ballot packs one predicate a lane, and each tile is read from
its staged copy (rows < n, words from t rounded down to 4 up to ceil(n/32)
rounded up to 4). Words the mask launch did not write, and staged entries
no copy filled, hold poison: the kernel ORs some of them into removed
words, and the model checks that no tile reads a removed word that holds
poison. A copy with one step broken (no diagonal resolution, or ORing the
words of removed rows) must fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu.ops.nms_pallas import pallas_nms, pallas_nms_batched
from yunet_tpu_torch.ops.nms import (MAX_K, greedy_nms_keep,
                                     greedy_nms_keep_plain, mask_words,
                                     topk_candidates)

IOU, SCORE = 0.45, 0.02
FULL = 0xFFFFFFFF


def mask_model(boxes, n, thr):
    """Launch A on one image: boxes (K, 4) f32 sorted by score, n valid.
    Returns the (K, mask_words(K)) u32 mask, poison where unwritten, and
    which words were written."""
    k = boxes.shape[0]
    words, wn = mask_words(k), (n + 31) // 32
    mask = np.full((k, words), FULL, np.uint32)
    written = np.zeros((k, words), bool)
    x1, y1, x2, y2 = boxes.T
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    for t in range(wn):                       # a 32-row tile
        i = np.arange(32 * t, min(32 * t + 32, n))[:, None]
        j = np.arange(32 * t, n)[None]        # its live columns
        iw = np.minimum(x2[j], x2[i]) - np.maximum(x1[j], x1[i])
        ih = np.minimum(y2[j], y2[i]) - np.maximum(y1[j], y1[i])
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        union = np.maximum(area[j] + area[i] - inter, np.float32(1e-9))
        hit = np.zeros((i.shape[0], 32 * (wn - t)), bool)
        hit[:, :j.shape[1]] = (inter / union > np.float32(thr)) & (j > i)
        bits = hit.reshape(i.shape[0], wn - t, 32).astype(np.uint64)
        mask[i[:, 0], t:wn] = (bits << np.arange(32, dtype=np.uint64)).sum(
            -1).astype(np.uint32)
        written[i[:, 0], t:wn] = True
    return mask, written


def ballot(pred):
    return sum(1 << lane for lane, p in enumerate(pred) if p)


def scan_model(mask, written, n, broken=""):
    """Launch B on one image, lane by lane. broken: "no_diag" skips the
    tile's greedy steps, "removed_rows" ORs the later words of every valid
    row of a tile, removed or not. Returns keep (K,) bool."""
    k, words = mask.shape
    q_max, wn = (words + 31) // 32, (n + 31) // 32
    s = 32 * q_max                            # a staged row's words
    rem = np.zeros((32, q_max), np.int64)     # lane l, q: word l + 32q
    poisoned = np.zeros((32, q_max), bool)
    keep = np.zeros(k, bool)
    buf = np.full((33, s), FULL, np.int64)    # row 32: zeros
    buf[32] = 0
    good = np.zeros((33, s), bool)            # filled by a copy, written
    good[32] = True
    for t in range(wn):
        q, tl = divmod(t, 32)
        rows = min(32, n - 32 * t)
        # the staged tile (stale entries keep poison)
        w0, w1 = t & ~3, (wn + 3) & ~3
        buf[:32], good[:32] = FULL, False
        buf[:rows, w0:w1] = mask[32 * t:32 * t + rows, w0:w1]
        good[:rows, w0:w1] = written[32 * t:32 * t + rows, w0:w1]
        valid = FULL if rows == 32 else (1 << rows) - 1
        diag = [int(buf[lane, t]) if lane < rows else 0 for lane in range(32)]
        assert all(good[:rows, t]), "a diagonal word was not written"
        assert not poisoned[tl, q], "a tile read a poisoned removed word"
        cur = int(rem[tl, q]) & valid                   # shuffle from tl
        todo = ballot([d != 0 for d in diag]) & ~cur & FULL
        while todo and broken != "no_diag":
            cur |= diag[(todo & -todo).bit_length() - 1]  # shuffle
            todo &= (todo - 1) & ~cur
        alive = ~cur & valid
        for lane in range(min(32, k - 32 * t)):
            keep[32 * t + lane] = (alive >> lane) & 1
        src = valid if broken == "removed_rows" else alive
        # at most 64 words a row: all 32 rows, the removed ones masked;
        # above: the alive rows only (four a round, the zero row padding)
        picked = [r for r in range(32) if (src >> r) & 1]
        for q2 in range(q, q_max):
            if 32 * q2 + 31 <= t or 32 * q2 >= wn:
                continue
            for lane in range(32):
                w = 32 * q2 + lane
                rows_read = picked if q_max > 2 else range(32)
                for r in rows_read:
                    if r in picked:
                        rem[lane, q2] |= int(buf[r, w])
                        poisoned[lane, q2] |= not good[r, w]
    return keep


def bitmask_keep(boxes, counts, thr=IOU, broken=""):
    """The two launches on a (B, K, 4) batch: keep (B, K) bool."""
    out = []
    for bx, n in zip(boxes, counts):
        n = min(max(int(n), 0), bx.shape[0])
        out.append(scan_model(*mask_model(bx, n, thr), n, broken=broken))
    return np.stack(out)


def _boxes(rng, n, size):
    # clustered boxes, so that many pairs overlap
    centers = rng.uniform(20, size - 20, (max(n // 8, 1), 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(8, 50, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _case(counts, p, size, seed):
    """boxes (B, P, 4), scores (B, P) with counts[b] above SCORE."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([_boxes(rng, p, size) for _ in counts])
    scores = rng.uniform(0, 0.01, (len(counts), p)).astype(np.float32)
    for b, cnt in enumerate(counts):
        scores[b, rng.choice(p, cnt, replace=False)] = \
            rng.uniform(0.05, 1.0, cnt)
    return boxes, scores


def _candidates(boxes, scores, top_k):
    top, _, _, counts = topk_candidates(torch.from_numpy(boxes),
                                        torch.from_numpy(scores), top_k,
                                        SCORE)
    return top.contiguous(), counts


COUNTS = (0, 1, 31, 32, 33, 63, 64, 65, 300, 750)


@pytest.mark.parametrize("count", COUNTS)
def test_model_matches_plain_and_pallas(count):
    boxes, scores = _case([count], 900, 200.0, seed=count)
    top, counts = _candidates(boxes, scores, 750)
    got = bitmask_keep(top.numpy(), counts.numpy())
    want = greedy_nms_keep(top, counts, IOU).numpy()     # the plain loop
    np.testing.assert_array_equal(got, want)
    _, keep, _ = pallas_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                            top_k=750, iou_thr=IOU, score_thr=SCORE)
    np.testing.assert_array_equal(got[0], np.asarray(keep))
    assert got.sum() <= count


def test_model_matches_batched_pallas():
    """All the counts in one batch: each image scans to its own count."""
    boxes, scores = _case(COUNTS, 900, 200.0, seed=11)
    top, counts = _candidates(boxes, scores, 750)
    got = bitmask_keep(top.numpy(), counts.numpy())
    _, keep, _ = pallas_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                    top_k=750, iou_thr=IOU, score_thr=SCORE)
    np.testing.assert_array_equal(got, np.asarray(keep))
    np.testing.assert_array_equal(
        got, greedy_nms_keep_plain(top, counts, IOU).numpy())


def test_model_at_k5000():
    """One 640^2 image at device_nms_pre = 5000, all valid: five removed
    words a lane, the last one partly used."""
    boxes, scores = _case([5000], 5200, 640.0, seed=5)
    top, counts = _candidates(boxes, scores, 5000)
    got = bitmask_keep(top.numpy(), counts.numpy())
    np.testing.assert_array_equal(
        got, greedy_nms_keep_plain(top, counts, IOU).numpy())
    _, keep, _ = pallas_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                            top_k=5000, iou_thr=IOU, score_thr=SCORE)
    np.testing.assert_array_equal(got[0], np.asarray(keep))
    assert (5000 + 31) // 32 > 4 * 32                 # uses q = 4


@pytest.mark.parametrize("name", ["iou_at_threshold",
                                  "iou_ulps_from_threshold",
                                  "zero_area_duplicates", "counts_around_32"])
def test_model_on_edge_cases(name):
    """test_torch_nms's edge cases: an IoU at the threshold, IoUs an ulp
    of the width either side of it, zero-area, inverted and duplicate
    boxes, counts on both sides of multiples of 32."""
    from test_torch_nms import _edge_case
    boxes, scores = _edge_case(name)
    top, counts = _candidates(boxes, scores, 128)
    got = bitmask_keep(top.numpy(), counts.numpy())
    np.testing.assert_array_equal(
        got, greedy_nms_keep_plain(top, counts, IOU).numpy())
    _, keep, _ = pallas_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                    top_k=128, iou_thr=IOU, score_thr=SCORE)
    np.testing.assert_array_equal(got, np.asarray(keep))


@pytest.mark.parametrize("broken", ["no_diag", "removed_rows"])
def test_broken_model_fails(broken):
    """A scan without the tile's greedy steps, or one that ORs the words
    of removed rows, gives another keep set on the serving-size cases."""
    boxes, scores = _case([300, 750], 900, 200.0, seed=3)
    top, counts = _candidates(boxes, scores, 750)
    want = greedy_nms_keep_plain(top, counts, IOU).numpy()
    np.testing.assert_array_equal(
        bitmask_keep(top.numpy(), counts.numpy()), want)
    assert not np.array_equal(
        bitmask_keep(top.numpy(), counts.numpy(), broken=broken), want)


def test_poisoned_words_stay_unread():
    """Every word the mask launch leaves unwritten holds poison: the keep
    set is unchanged, so no tile reads a removed word that holds it."""
    boxes, scores = _case([65], 300, 200.0, seed=8)
    top, counts = _candidates(boxes, scores, 256)
    mask, written = mask_model(top[0].numpy(), 65, IOU)
    assert not written[65:].any() and not written[40, :1].any()
    assert (mask[~written] == FULL).all()
    np.testing.assert_array_equal(
        scan_model(mask, written, 65),
        greedy_nms_keep_plain(top, counts, IOU)[0].numpy())


def test_max_k_is_the_serial_kernels_limit():
    """Every K the one-block-per-image kernel took (24 B a candidate in a
    block's 227 KB) is taken; the scan's lanes then hold 10 words each."""
    assert MAX_K == 232448 // 24
    assert ((MAX_K + 31) // 32 + 31) // 32 == 10
