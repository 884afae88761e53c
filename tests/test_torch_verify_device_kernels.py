"""yunet_tpu_torch/tools/verify_device_kernels.py on the CPU, against the
JAX package's tools/misc/verify_device_kernels.py:

  * the seeded inputs equal those JAX's tool draws (recorded from its own
    check_nms / check_simota runs);
  * on them, the port's plain NMS gives the keep sets and indices of JAX's
    device_nms and pallas_nms_batched (interpret mode), and the port's
    dense and streamed (plain) SimOTA the fg_mask and matched_gt of JAX's
    sim_ota_assign_batched(use_pallas=False): EQUAL;
  * each check's control flow runs on the plain versions (what the card
    runs through the kernels);
  * without a CUDA device main() exits 1 (no fallback).
"""

import os
import sys

import numpy as np
import pytest
import torch

import yunet_tpu.ops.assign as jax_assign
import yunet_tpu.ops.nms as jax_nms
import yunet_tpu.ops.nms_pallas as jax_nms_pallas
from yunet_tpu_torch.ops.assign import sim_ota_assign_batched
from yunet_tpu_torch.tools import verify_device_kernels as vdk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools", "misc"))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's tool's checks run as written, with their inputs and outputs
    recorded: {"nms": [(boxes, scores, top_k, keep, idx)], "device_nms":
    [(keep, idx)], "simota": (args, fg_mask, matched_gt)}."""
    import verify_device_kernels as jv
    rec = {"nms": [], "device_nms": [], "simota": None}
    mp = pytest.MonkeyPatch()
    batched, per_image = jax_nms_pallas.pallas_nms_batched, jax_nms.device_nms
    dense = jax_assign.sim_ota_assign_batched

    def rec_batched(boxes, scores, **kw):
        out = batched(boxes, scores, **kw)
        rec["nms"].append((np.asarray(boxes), np.asarray(scores),
                           kw["top_k"], np.asarray(out[1]),
                           np.asarray(out[2])))
        return out

    def rec_device_nms(boxes, scores, **kw):
        out = per_image(boxes, scores, **kw)
        rec["device_nms"].append((np.asarray(out[1]), np.asarray(out[2])))
        return out

    def rec_simota(*args, use_pallas):
        # both of JAX's calls take the dense formulation here (its Pallas
        # kernel's equality with it is JAX's own test)
        out = dense(*args, use_pallas=False)
        rec["simota"] = ([np.asarray(a) for a in args],
                         np.asarray(out.fg_mask), np.asarray(out.matched_gt))
        return out

    mp.setattr(jax_nms_pallas, "pallas_nms_batched", rec_batched)
    mp.setattr(jax_nms, "device_nms", rec_device_nms)
    mp.setattr(jax_assign, "sim_ota_assign_batched", rec_simota)
    try:
        jv.check_nms(False)
        jv.check_simota()
    finally:
        mp.undo()
    return rec


def test_nms_inputs_and_keep_sets_equal_jax(jax_runs):
    ins = vdk.nms_inputs()
    assert len(ins) == len(jax_runs["nms"]) == 2
    images = 0
    for (boxes, scores, top_k), (jb, js, jk, jkeep, jidx) in zip(
            ins, jax_runs["nms"]):
        np.testing.assert_array_equal(boxes, jb)
        np.testing.assert_array_equal(scores, js)
        assert top_k == jk
        keep, idx = vdk.plain_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), top_k)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        np.testing.assert_array_equal(idx.numpy(), jidx)
        for b in range(scores.shape[0]):
            k1, i1 = jax_runs["device_nms"][images]
            np.testing.assert_array_equal(keep[b].numpy(), k1)
            np.testing.assert_array_equal(idx[b].numpy(), i1)
            images += 1
        # the sparse regime: 0, 1, 12 and 60 candidates an image
        assert all(int(k.sum()) <= c for k, c in zip(keep, (0, 1, 12, 60)))
    assert images == len(jax_runs["device_nms"]) == 6
    assert vdk.nms_inputs(quick=True)[0][2] == 256


def test_simota_inputs_and_assignment_equal_jax(jax_runs):
    jargs, jfg, jmatched = jax_runs["simota"]
    ins = vdk.simota_inputs()
    for a, j in zip(ins, jargs):
        np.testing.assert_array_equal(a, j)
    args = [torch.from_numpy(a) for a in ins]
    for streamed in (False, True):
        r = sim_ota_assign_batched(*args, use_streamed=streamed)
        np.testing.assert_array_equal(r.fg_mask.numpy(), jfg)
        np.testing.assert_array_equal(r.matched_gt.numpy(), jmatched)
    assert jfg.sum() > 0


@pytest.mark.parametrize("name", ["nms", "simota", "convdp", "convdp_bwd",
                                  "convdp_cm"])
def test_checks_run_on_plain_versions(name, capsys):
    """The checks' shapes, layouts and tolerance code on the CPU, where
    each wrapper runs its plain version (the card runs the kernel)."""
    fn = getattr(vdk, f"check_{name}")
    fn(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.startswith(f"  {name}")


def test_no_cuda_device_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert vdk.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.undo()
    assert vdk.main(["--quick"], device="cpu") == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "PASS" not in out.out
