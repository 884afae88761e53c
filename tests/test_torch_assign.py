"""yunet_tpu_torch SimOTA == yunet_tpu's, on the CPU.

* The dense ``sim_ota_assign`` against JAX's on tests/test_assign.py's
  constructions: fg_mask and matched_gt EQUAL, matched_iou within 1e-6
  (the same f32 IoU expression; JAX reads it from the pairwise matrix).
* The streamed plain version (what the CUDA kernel is held to on the card)
  against JAX ``streamed_simota(interpret=True)``, folded and 4-D grid,
  with the chunk and tile constants shrunk so that several of each run:
  valid_prior, best_gt and cand_idx EQUAL on valid GT rows (invalid rows
  are don't-care, and the two define them differently), and the assembled
  result equal to JAX's dense batched assignment. topk_iou is EQUAL to the
  top-k of JAX's dense ``pairwise_iou`` (each op rounded on its own, as
  torch and the CUDA kernel do) and within one f32 ulp of the interpreted
  Pallas kernel, whose fused XLA CPU program rounds the IoU differently
  (measured: 1 ulp on 10 of 230 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_assign import _make_case
from yunet_tpu.ops import simota_pallas
from yunet_tpu.ops.assign import sim_ota_assign as jax_assign
from yunet_tpu.ops.assign import sim_ota_assign_batched as jax_assign_batched
from yunet_tpu.ops.boxes import bbox_decode as jax_decode
from yunet_tpu.ops.boxes import fuse_score as jax_fuse
from yunet_tpu.ops.boxes import pairwise_iou as jax_pairwise_iou
from yunet_tpu_torch.ops import simota
from yunet_tpu_torch.ops.assign import (assemble_streamed, sim_ota_assign,
                                        sim_ota_assign_batched)


def _same_assign(got, want, err=""):
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask), err_msg=err)
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt), err_msg=err)
    np.testing.assert_allclose(got.matched_iou.numpy(),
                               np.asarray(want.matched_iou), rtol=0,
                               atol=1e-6, err_msg=err)


@pytest.mark.parametrize("seed,num_gts", [(0, 3), (1, 7), (2, 1), (3, 12),
                                          (4, 5), (7, 9)])
def test_dense_assign_matches_jax(seed, num_gts):
    priors, cls_l, obj_l, bbox_p, gts, labels, pad_to = _make_case(
        seed, num_gts)
    scores = np.array(jax_fuse(jnp.asarray(cls_l),
                                 jnp.asarray(obj_l)[:, None]))
    offset = np.concatenate([priors[:, :2] + priors[:, 2:] * 0.5,
                             priors[:, 2:]], -1)
    decoded = np.array(jax_decode(jnp.asarray(priors), jnp.asarray(bbox_p)))
    gts_p = np.zeros((pad_to, 4), np.float32)
    gts_p[:num_gts] = gts
    labels_p = np.zeros((pad_to,), np.int32)
    valid = np.arange(pad_to) < num_gts
    want = jax_assign(jnp.asarray(scores), jnp.asarray(offset),
                      jnp.asarray(decoded), jnp.asarray(gts_p),
                      jnp.asarray(labels_p), jnp.asarray(valid))
    batched = [torch.from_numpy(a)[None] for a in (
        scores, decoded, gts_p, labels_p, valid)]
    batched.insert(1, torch.from_numpy(offset))
    got = sim_ota_assign(*batched)
    got = type(got)(*(t[0] for t in got))
    assert int(got.fg_mask.sum()) > 0
    _same_assign(got, want)
    # the streamed path (plain version on the CPU) gives the same answer
    streamed = sim_ota_assign_batched(*batched, use_streamed=True)
    _same_assign(type(got)(*(t[0] for t in streamed)), want)


def test_dense_assign_no_gts():
    priors, cls_l, obj_l, bbox_p, *_ = _make_case(5, 2)
    p = priors.shape[0]
    res = sim_ota_assign(torch.rand(1, p, 1), torch.from_numpy(priors),
                         torch.from_numpy(priors)[None], torch.zeros(1, 8, 4),
                         torch.zeros(1, 8, dtype=torch.int32),
                         torch.zeros(1, 8, dtype=torch.bool))
    assert not res.fg_mask.any() and not res.matched_gt.any()


def _streamed_case(rng, b, p, g, pvalid, tied):
    """Random priors/boxes as tests/test_assign.py builds them. tied=True
    gives every prior the same score and one decoded box per image, so
    every cost in a GT column ties except across the INF/BIG tiers.
    Image 0 has no valid GT."""
    pri = np.stack([rng.uniform(0, 320, p), rng.uniform(0, 320, p),
                    np.full(p, 8.0), np.full(p, 8.0)], -1).astype(np.float32)
    scores = rng.uniform(1e-4, 1, (b, p)).astype(np.float32)
    c = rng.uniform(20, 300, (b, p, 2))
    wh = rng.uniform(4, 80, (b, p, 2))
    dec = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if tied:
        scores[:] = 0.25
        dec[:] = dec[:, :1]
    gc = rng.uniform(20, 300, (b, g, 2))
    gwh = rng.uniform(8, 100, (b, g, 2))
    gtb = np.concatenate([gc - gwh / 2, gc + gwh / 2], -1).astype(np.float32)
    gv = rng.uniform(size=(b, g)) < pvalid
    gv[0] = False
    return scores, pri, dec, gtb, gv


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("tied", [False, True])
def test_streamed_plain_matches_jax_kernel(monkeypatch, folded, tied):
    monkeypatch.setattr(simota_pallas, "T_CHUNK", 128)
    monkeypatch.setattr(simota_pallas, "GT_TILE", 8)
    rng = np.random.RandomState(11 + tied)
    b, p, g = 3, 300, 20          # 3 prior chunks of 128, 3 GT tiles of 8
    scores, pri, dec, gtb, gv = _streamed_case(rng, b, p, g, 0.6, tied)
    onehot = np.ones((b, g), np.float32)
    want = simota_pallas.streamed_simota(
        jnp.asarray(scores), jnp.asarray(pri), jnp.asarray(dec),
        jnp.asarray(gtb), jnp.asarray(onehot), jnp.asarray(gv),
        folded=folded, interpret=True)
    got = simota.streamed_simota(*(torch.from_numpy(a) for a in (
        scores, pri, dec, gtb, onehot, gv)))
    np.testing.assert_array_equal(got.valid_prior.numpy(),
                                  np.asarray(want.valid_prior))
    np.testing.assert_array_equal(got.best_gt.numpy(),
                                  np.asarray(want.best_gt))
    assert gv.sum() > 0
    np.testing.assert_array_equal(got.cand_idx.numpy()[gv],
                                  np.asarray(want.cand_idx)[gv])
    iou = np.where(got.valid_prior.numpy()[:, None, :] & gv[:, :, None],
                   np.swapaxes(np.asarray(jax_pairwise_iou(dec, gtb)), 1, 2),
                   np.float32(0))
    np.testing.assert_array_equal(got.topk_iou.numpy()[gv],
                                  -np.sort(-iou, -1)[..., :10][gv])
    np.testing.assert_allclose(got.topk_iou.numpy()[gv],
                               np.asarray(want.topk_iou)[gv], rtol=2.4e-7,
                               atol=0)
    # the port's defined value on invalid rows
    np.testing.assert_array_equal(got.cand_idx.numpy()[~gv],
                                  np.broadcast_to(np.arange(10), (
                                      int((~gv).sum()), 10)))
    assert not got.topk_iou.numpy()[~gv].any()

    # the assembled matching equals JAX's dense batched assignment
    dense = jax_assign_batched(
        jnp.asarray(scores[..., None]), jnp.asarray(pri), jnp.asarray(dec),
        jnp.asarray(gtb), jnp.zeros((b, g), jnp.int32), jnp.asarray(gv),
        use_pallas=False)
    res = assemble_streamed(got.valid_prior, got.best_gt, got.cand_idx,
                            got.topk_iou, torch.from_numpy(gtb),
                            torch.from_numpy(gv), torch.from_numpy(dec))
    assert int(res.fg_mask.sum()) > 0
    _same_assign(res, dense)


def test_streamed_dispatch():
    """The plain version for CPU tensors; any other device that is not
    CUDA raises (a CUDA tensor reaches the kernel or raises; chip_smoke.py
    holds the kernel to the plain version on the card). More than one
    class with the streamed path raises, as in JAX."""
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(a) for a in _streamed_case(rng, 2, 40, 4, 1.0,
                                                        False)]
    onehot = torch.ones(2, 4)
    got = simota.streamed_simota(args[0], args[1], args[2], args[3], onehot,
                                 args[4])
    want = simota.streamed_simota_plain(args[0], args[1], args[2], args[3],
                                        onehot, args[4])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    meta = [a.to("meta") for a in (args[0], args[1], args[2], args[3],
                                   onehot, args[4])]
    with pytest.raises(ValueError, match="no kernel"):
        simota.streamed_simota(*meta)
    with pytest.raises(ValueError, match="shape"):
        simota.streamed_simota(args[0], args[1][:5], args[2], args[3],
                               onehot, args[4])
    with pytest.raises(ValueError, match="num_classes"):
        sim_ota_assign_batched(torch.rand(2, 40, 2), args[1], args[2],
                               args[3], torch.zeros(2, 4, dtype=torch.int32),
                               args[4], use_streamed=True)
