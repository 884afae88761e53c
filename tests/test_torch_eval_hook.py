"""The port's in-training WIDER eval hook
(yunet_tpu_torch/eval/eval_hook.py:make_wider_eval_hook) on a
tools/make_synth_wider.py --tier hard val split with the r04 EMA fixture,
on the CPU, in bf16 as shipped:

  * its APs EQUAL the port's test_widerface CLI's on the same weights and
    mode (the same sweep and protocol);
  * against yunet_tpu's hook (bf16 both) within AP_TOL, the band of
    tests/test_torch_widerface.py for two bf16 trunks;
  * the decoded .npy cache and the JPEGs give the same APs;
  * the EMA shadow is evaluated when present, the raw parameters with
    also_raw under raw_* keys, as in JAX.
"""

import collections
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.eval.eval_hook import make_wider_eval_hook as jax_hook
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.eval.eval_hook import (ema_state_dict,
                                            make_wider_eval_hook)
from yunet_tpu_torch.train import init_train_state
from yunet_tpu_torch.utils.jax_params import (jax_from_state_dict,
                                              load_flat_npz,
                                              state_dict_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
AP_TOL = 0.02        # tests/test_torch_widerface.py: two bf16 trunks
KEYS = ["easy", "hard", "medium"]
JaxState = collections.namedtuple("JaxState", "params state ema_params")


@pytest.fixture(scope="module")
def val(tmp_path_factory):
    """Four hard-tier val images (JPEGs), labelv2.txt, GT mats and the
    decoded cache: {ann, images, gt, cache}."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    root = tmp_path_factory.mktemp("hook_val")
    split = str(root / "val")
    per_event = gen.generate_split(split, 4, 11, tier=gen.TIERS["hard"])
    gen.write_gt_mats(os.path.join(split, "gt"), per_event)
    paths = {"ann": os.path.join(split, "labelv2.txt"),
             "images": os.path.join(split, "images"),
             "gt": os.path.join(split, "gt"), "cache": str(root / "cache")}
    assert build_decoded_cache(paths["ann"], paths["images"], paths["cache"],
                               verbose=False) == 4
    return paths


@pytest.fixture(scope="module")
def r04_sd():
    return state_dict_from_jax(*load_flat_npz(FIXTURE, yunet_n().model))


def _state(sd, ema_momentum=0.0):
    cfg = yunet_n()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_momentum=ema_momentum))
    return init_train_state(cfg, steps_per_epoch=1, total_batch=1,
                            device="cpu", state_dict=sd)[0]


def _hook(val, mode, **kw):
    kw.setdefault("cache_dir", val["cache"])
    return make_wider_eval_hook(yunet_n(), device="cpu", mode=mode,
                                ann=val["ann"], img_prefix=val["images"],
                                gt_dir=val["gt"], **kw)


def _cli_aps(val, mode, device_nms, tmp_path):
    from yunet_tpu_torch.tools import test_widerface as cli
    argv = ["yunet_n", FIXTURE, "--mode", str(mode), "--ann", val["ann"],
            "--gt-dir", val["gt"], "--cache-dir", val["cache"],
            "--eval-log", str(tmp_path / "eval.log")]
    return cli.main(argv + (["--device-nms"] if device_nms else []),
                    device="cpu")


@pytest.fixture(scope="module")
def cli_mode0(val, tmp_path_factory):
    return _cli_aps(val, 0, False, tmp_path_factory.mktemp("cli"))


def test_hook_equals_test_widerface_mode0(val, r04_sd, cli_mode0):
    aps = _hook(val, (640, 640))(_state(r04_sd), 1)
    assert sorted(aps) == KEYS
    assert [aps["easy"], aps["medium"], aps["hard"]] == list(cli_mode0)
    assert all(0 < a <= 1 for a in aps.values())


def test_hook_equals_test_widerface_mode2_device_nms(val, r04_sd, tmp_path):
    aps = _hook(val, "ORIGIN", use_device_nms=True)(_state(r04_sd), 1)
    want = _cli_aps(val, 2, True, tmp_path)
    assert [aps["easy"], aps["medium"], aps["hard"]] == list(want)


def test_hook_cache_and_jpeg_agree(val, r04_sd):
    ts = _state(r04_sd)
    assert (_hook(val, (640, 640), cache_dir=None)(ts, 1)
            == _hook(val, (640, 640))(ts, 1))


def test_hook_missing_cache_entry_raises(val, r04_sd, tmp_path):
    with pytest.raises(FileNotFoundError):
        _hook(val, (640, 640), cache_dir=str(tmp_path))(_state(r04_sd), 1)


def _perturbed_with_ema(r04_sd):
    """A TrainState whose raw head is scaled by 0.5 and whose EMA shadow is
    the r04 parameters (the BN statistics are r04's)."""
    ts = _state(r04_sd, ema_momentum=0.01)
    with torch.no_grad():
        for name, p in ts.model.named_parameters():
            if name.startswith("bbox_head."):
                p.mul_(0.5)
    return ts


def _jax_state(ts):
    sd = ts.model.state_dict()
    params, state = jax_from_state_dict(sd, yunet_n().model)
    ema = (jax_from_state_dict(ema_state_dict(ts), yunet_n().model)[0]
           if ts.ema is not None else None)
    return JaxState(params, state, ema)


def test_ema_and_raw_are_picked_as_in_jax(val, r04_sd, cli_mode0):
    ts = _perturbed_with_ema(r04_sd)
    both = _hook(val, (640, 640), also_raw=True)(ts, 1)
    assert sorted(both) == sorted(KEYS + [f"raw_{k}" for k in KEYS])
    # the EMA shadow is r04: the CLI's APs on r04
    assert [both["easy"], both["medium"], both["hard"]] == list(cli_mode0)
    assert [both[f"raw_{k}"] for k in KEYS] != [both[k] for k in KEYS]
    raw_only = _hook(val, (640, 640), use_ema=False)(ts, 1)
    assert raw_only == {k: both[f"raw_{k}"] for k in KEYS}
    want = jax_hook(jax_yunet_n(), mode=(640, 640), ann=val["ann"],
                    img_prefix=val["images"], gt_dir=val["gt"],
                    also_raw=True)(_jax_state(ts), 1)
    assert sorted(want) == sorted(both)
    for k in want:
        np.testing.assert_allclose(both[k], want[k], rtol=0, atol=AP_TOL,
                                   err_msg=k)


def test_hook_matches_jax_hook_origin_size(val, r04_sd):
    ts = _state(r04_sd)
    got = _hook(val, "ORIGIN")(ts, 1)
    want = jax_hook(jax_yunet_n(), mode="ORIGIN", ann=val["ann"],
                    img_prefix=val["images"], gt_dir=val["gt"])(
                        _jax_state(ts), 1)
    assert sorted(want) == sorted(got) == KEYS
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=AP_TOL,
                                   err_msg=k)


def test_hook_refuses_a_mesh(val):
    """A mesh with no process group behind it is refused (the 2-rank hook:
    tests/test_torch_parallel.py)."""
    from yunet_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match="process group"):
        _hook(val, (640, 640), mesh=Mesh(0, 2, torch.device("cpu")))
