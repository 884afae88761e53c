"""The streamed SimOTA kernel's selection, modelled on the CPU.

``csrc/simota.cu`` orders (cost, prior index) pairs and IoUs by one
integer key each, keeps per-thread lists of k keys, merges each warp's 32
lists with shuffles and the block's 8 warp lists in shared memory, and
takes a GT's argmin over its image's live slots only. A CUDA kernel cannot
run here, so this file holds that order of work, written out in Python on
the keys of ``ops/simota.py``, to the plain version's stable sort
(``topk_min_idx``), ``torch.topk`` and ``torch.argmin``, on seeded cases
where ties are the rule: many priors at BIG, GTs with fewer than k priors
in box and centre, one decoded box and one score for every prior. The
kernel itself is held to the plain version on the card by
``chip_smoke.py:phase_simota``, and the plain version to JAX by
``tests/test_torch_assign.py``.
"""

import numpy as np
import pytest
import torch

from yunet_tpu_torch.ops import simota
from yunet_tpu_torch.ops.priors import grid_priors

THREADS, WARPS, UNROLL = 256, 8, 2   # csrc/simota.cu kThreads, kUnroll
NO_KEY = 2 ** 64 - 1
STRIDES = (8, 16, 32)


def warp_min(lane_values):
    """What each of the 32 lanes holds after csrc/simota.cu:warp_min's
    xor-shuffle butterfly."""
    v = list(lane_values)
    for off in (16, 8, 4, 2, 1):
        v = [min(v[lane], v[lane ^ off]) for lane in range(32)]
    return v


def model_topk(keys, k, eligible):
    """The k smallest of the eligible keys of one GT column, NO_KEY where
    there are fewer, in topk_kernel's order of work: thread t visits
    priors p0 + u * THREADS for p0 = t, t + THREADS * UNROLL, ... and
    inserts each eligible key that beats its list's last into its sorted
    list of k. Each warp runs up to k rounds of warp_min over its lanes'
    heads (none once the min is NO_KEY); the lane whose head is the min
    pops it and lane r keeps round r's min. Warp 0 merges the 8 warp lists
    the same way, lane w < 8 walking list w, the other lanes holding no
    key."""
    p_n = len(keys)
    lists = [[NO_KEY] * k for _ in range(THREADS)]
    for t, lst in enumerate(lists):
        for p0 in range(t, p_n, THREADS * UNROLL):
            for u in range(UNROLL):
                p = p0 + u * THREADS
                if p >= p_n:
                    break
                key = int(keys[p])
                if eligible[p] and key < lst[k - 1]:
                    for j in range(k - 1, 0, -1):
                        lst[j] = (lst[j - 1] if key < lst[j - 1]
                                  else key if key < lst[j] else lst[j])
                    lst[0] = min(lst[0], key)
    warp_lists = []
    for w in range(WARPS):
        lanes = lists[32 * w:32 * (w + 1)]
        kept = [NO_KEY] * 32
        for r in range(k):
            m = warp_min(lst[0] for lst in lanes)
            if m[0] == NO_KEY:
                break
            for lane, lst in enumerate(lanes):
                if lst[0] == m[lane]:
                    lst[:] = lst[1:] + [NO_KEY]
            kept[r] = m[r]
        warp_lists.append(kept[:k])
    at = [0] * 32
    heads = [warp_lists[lane][0] if lane < WARPS else NO_KEY
             for lane in range(32)]
    kept = [NO_KEY] * 32
    for r in range(k):
        m = warp_min(heads)
        if m[0] == NO_KEY:
            break
        for lane in range(WARPS):
            if heads[lane] == m[lane]:
                at[lane] += 1
                heads[lane] = (warp_lists[lane][at[lane]] if at[lane] < k
                               else NO_KEY)
        kept[r] = m[r]
    return np.array(kept[:k], np.uint64)


def model_best(cost, in_both, valid_prior, gt_valid):
    """valid_best_kernel's argmin: the live slots compacted in ascending
    order; when a slot holds the prior in box and centre, only such slots
    are costed; the first strictly smaller cost wins; an invalid prior
    gets 0. cost, in_both (P, G)."""
    live = np.flatnonzero(gt_valid)
    best = np.zeros(cost.shape[0], np.int32)
    for p in np.flatnonzero(valid_prior):
        tier = in_both[p, live].any()
        best_v = np.float32(1e9)
        for g in live:
            if (not tier or in_both[p, g]) and cost[p, g] < best_v:
                best_v, best[p] = cost[p, g], g
    return best


def _case(kind, seed, hw=(256, 320), b=2, g=12):
    """Seeded SimOTA inputs on a (H, W) prior grid (1680 priors, 6-7 a
    thread). kind: "tiny" (2-6 px GTs: few priors in box and centre, most
    priors at BIG), "tied" (one score and one decoded box for every prior
    of an image), "mixed" (random boxes, some GT slots dead)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    pri = grid_priors([(h // s, w // s) for s in STRIDES], STRIDES, 0.0)
    pri = np.concatenate([pri[:, :2] + pri[:, 2:] * 0.5, pri[:, 2:]],
                         -1).astype(np.float32)
    p = pri.shape[0]
    scores = rng.uniform(1e-4, 1, (b, p)).astype(np.float32)
    c = rng.uniform(0, [w, h], (b, p, 2))
    wh = rng.uniform(4, 80, (b, p, 2))
    dec = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    gc = rng.uniform(10, [w - 10, h - 10], (b, g, 2))
    gwh = rng.uniform(2, 6, (b, g, 2)) if kind == "tiny" else \
        rng.uniform(8, 120, (b, g, 2))
    gtb = np.concatenate([gc - gwh / 2, gc + gwh / 2], -1).astype(np.float32)
    gv = rng.uniform(size=(b, g)) < 0.75
    gv[:, 0] = True
    if kind == "tied":
        scores[:] = 0.25
        dec[:] = gtb[:, :1] + np.float32(1.5)
    onehot = (rng.uniform(size=(b, g)) < 0.8).astype(np.float32)
    return [torch.from_numpy(a) for a in (scores, pri, dec, gtb, onehot, gv)]


def _dense(ins):
    """valid_prior (B, P), IoU and cost (B, P, G) of the plain version,
    and the in-box-and-centre mask (B, P, G)."""
    scores, pri, dec, gtb, onehot, gv = ins
    in_gts, in_cts = simota._pair_masks(pri, gtb, gv, 2.5)
    return (*simota.dense_cost(scores[..., None], pri, dec, gtb,
                               onehot[..., None], gv, center_radius=2.5,
                               iou_weight=3.0, cls_weight=1.0, eps=1e-7),
            in_gts & in_cts)


# -- the keys ---------------------------------------------------------------

def test_keys_signed_zero_is_one_value():
    z = np.array([0.0, -0.0], np.float32)
    assert simota.ordered_bits(z)[0] == simota.ordered_bits(z)[1]
    keys = simota.cost_keys(np.array([-0.0, 0.0, -0.0], np.float32),
                            np.array([2, 1, 0]))
    # equal costs: the order is the index order
    np.testing.assert_array_equal(np.argsort(keys), [2, 1, 0])
    assert simota.iou_from_key(simota.iou_keys(
        np.float32(-0.0), 0)).view(np.uint32) == 0


def test_keys_order_tiny_negatives_and_tiers():
    """Costs slightly below zero (-log(iou + eps) < 0 when iou ~ 1), the
    INF tier (1e5 + a few, where f32 steps are 1/128) and BIG order as
    floats do."""
    v = np.array([1e9, 1e5 + 1 / 128, 1e5, -1e-7, -2.4e-7, -np.float32(
        np.finfo(np.float32).tiny), 0.0, 1e-45, 3.0, -3.0, np.inf, -np.inf,
        1e5 + 2 / 128, 100000.0], np.float32)
    idx = np.arange(len(v))
    want = np.lexsort((idx, v))
    np.testing.assert_array_equal(
        np.argsort(simota.cost_keys(v, idx), kind="stable"), want)
    # the same keys, shuffled, sort to the same order
    perm = np.random.RandomState(0).permutation(len(v))
    np.testing.assert_array_equal(
        perm[np.argsort(simota.cost_keys(v[perm], idx[perm]))], want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_keys_match_stable_sort(seed):
    """On one column of many equal values (BIG, INF-tier, repeated
    costs), ascending keys are topk_min_idx's (value, index) order."""
    rng = np.random.RandomState(seed)
    n = 3000
    v = rng.choice(np.array([1e9, 1e5, 1e5 + 1 / 128, 2.5, -1e-7, 0.0,
                             -0.0], np.float32), n)
    spread = rng.uniform(size=n) < 0.3
    v[spread] = rng.normal(0, 10, int(spread.sum()))
    want = simota.topk_min_idx(torch.from_numpy(v), n).numpy()
    got = np.argsort(simota.cost_keys(v, np.arange(n)))
    np.testing.assert_array_equal(got, want)


def test_iou_keys_match_topk_values():
    rng = np.random.RandomState(3)
    iou = rng.choice(np.array([0.0, -0.0, 0.5, 1.0, 1e-6], np.float32),
                     500)
    iou[:50] = rng.uniform(0, 1, 50)
    keys = simota.iou_keys(iou, np.arange(500))
    top = np.sort(keys)[:16]
    np.testing.assert_array_equal(
        simota.iou_from_key(top),
        torch.topk(torch.from_numpy(iou), 16).values.numpy())
    # descending IoU, ties to the lower index
    np.testing.assert_array_equal(np.argsort(keys),
                                  np.lexsort((np.arange(500), -iou)))


# -- the order of work ------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("kind,seed", [("tiny", 0), ("tied", 1),
                                       ("mixed", 2)])
def test_model_topk_matches_plain(kind, seed, k):
    ins = _case(kind, seed)
    valid_prior, ious, cost, in_both = _dense(ins)
    gv = ins[5].numpy()
    both_t = in_both.transpose(1, 2).numpy()
    cost_t = cost.transpose(1, 2).contiguous()
    iou_t = ious.transpose(1, 2).contiguous()
    want_idx = simota.topk_min_idx(cost_t, k).numpy()
    want_iou = torch.topk(iou_t, k, dim=-1).values.numpy()
    p = cost.shape[1]
    idx = np.arange(p)
    short = full = 0
    for b in range(cost.shape[0]):
        for g in range(cost.shape[2]):
            # cost keys of the priors in box and centre; a second pass
            # over every prior when fewer than k came out
            keys = simota.cost_keys(cost_t[b, g].numpy(), idx)
            ck = model_topk(keys, k, both_t[b, g])
            if (ck == NO_KEY).any():
                ck = model_topk(keys, k, np.ones(p, bool))
            iou = iou_t[b, g].numpy()
            ik = model_topk(simota.iou_keys(iou, idx), k, iou > 0)
            np.testing.assert_array_equal(
                (ck & np.uint64(0xffffffff)).astype(np.int32),
                want_idx[b, g], err_msg=f"cand_idx b={b} g={g}")
            np.testing.assert_array_equal(simota.iou_from_key(ik),
                                          want_iou[b, g],
                                          err_msg=f"topk_iou b={b} g={g}")
            short += bool(gv[b, g] and both_t[b, g].sum() < k)
            full += bool(gv[b, g] and both_t[b, g].sum() >= k)
    # the cases hold what they are for
    big = (~valid_prior).float().mean()
    if kind == "tiny":
        assert big > 0.5 and short > 0
    if kind == "mixed":   # the path that keys in-box-and-centre priors only
        assert full > 0
    if kind == "tied":
        assert (cost_t[torch.from_numpy(gv)] < 1e9).sum() > 0
        v = ious.transpose(1, 2)[0, 0][valid_prior[0]]
        assert torch.all(v == v[0])


@pytest.mark.parametrize("kind,seed", [("tiny", 3), ("tied", 4),
                                       ("mixed", 5)])
def test_model_best_matches_argmin(kind, seed):
    ins = _case(kind, seed)
    valid_prior, _, cost, in_both = _dense(ins)
    want = torch.argmin(cost, dim=-1).numpy()
    for b in range(cost.shape[0]):
        np.testing.assert_array_equal(
            model_best(cost[b].numpy(), in_both[b].numpy(),
                       valid_prior[b].numpy(), ins[5][b].numpy()), want[b])
    # both branches ran: priors with and without a box-and-centre slot
    tier = in_both.any(-1)[valid_prior]
    assert tier.any() and (~tier).any()
