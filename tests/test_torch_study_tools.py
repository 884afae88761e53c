"""The port's study tools against their tools/ counterparts, on the CPU:

  * make_synth_wider: both tiers draw the same images and annotations as
    tools/make_synth_wider.py for the same seed (make_image arrays equal;
    generate_split's JPEG and labelv2 bytes equal; main's files and line
    equal), and the base tier's three-argument make_image still works;
  * ema_ab_table: stdout byte-equal to tools/misc/ema_ab_table.py's
    (plain and --markdown, a truncated line, replayed steps), and the same
    exit code and message without records;
  * export_band_fixture: from a port checkpoint with an EMA shadow, the
    file's leaves rebuild through JAX's tree_unflatten path (as
    tests/test_hard_band.py loads it) and through load_flat_npz into
    parameters equal to the shadow, meta carries JAX's keys, and its mode-0
    and mode-2 APs equal test_widerface's on the same weights and split;
  * quant_ap_study: the onnx float32 anchor and the TFLite ``none`` row
    equal to tools/misc/quant_ap_study.py's (same APs, same file sizes);
    needs TensorFlow.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tools", "misc"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")

import make_synth_wider as jgen  # noqa: E402

from yunet_tpu_torch.tools import make_synth_wider as pgen  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: these tests share the CPU with the other test
    workers, some of whose subprocesses have deadlines."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tier", ["base", "hard"])
def test_make_image_equal(tier):
    for seed in range(3):
        a = jgen.make_image(np.random.RandomState(seed), 512, 384,
                            jgen.TIERS[tier])
        b = pgen.make_image(np.random.RandomState(seed), 512, 384,
                            pgen.TIERS[tier])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # the base tier by default, as the TFLite calibration calls it
    for x, y in zip(jgen.make_image(np.random.RandomState(7), 320, 256),
                    pgen.make_image(np.random.RandomState(7), 320, 256)):
        np.testing.assert_array_equal(x, y)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".jpg", ".txt")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("tier", ["base", "hard"])
def test_generate_split_and_main_equal(tier, tmp_path, capsys):
    for mod, name in ((jgen, "jax"), (pgen, "port")):
        mod.generate_split(str(tmp_path / name / "split"), 3, 5,
                           tier=mod.TIERS[tier])
        mod.main(["--out", str(tmp_path / name / "cli"), "--train-n", "2",
                  "--val-n", "2", "--seed", "3", "--tier", tier])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace(str(tmp_path / "jax"), "") \
        == lines[1].replace(str(tmp_path / "port"), "")
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert len(want) == 3 + 1 + 2 * (2 + 1) and want == got
    from scipy.io import loadmat
    for sub in ("face", "easy", "medium", "hard"):
        p = f"cli/val/gt/wider_{sub}_val.mat"
        a, b = (loadmat(str(tmp_path / n / p)) for n in ("jax", "port"))
        key = "face_bbx_list" if sub == "face" else "gt_list"
        assert repr(a[key]) == repr(b[key])


def _val(step, easy, hard, raw_hard):
    return json.dumps({"step": step, "mode": "val", "easy": easy,
                       "medium": easy / 2, "hard": hard, "raw_easy": 0.5,
                       "raw_medium": 0.25, "raw_hard": raw_hard}) + "\n"


@pytest.mark.parametrize("markdown", [False, True])
def test_ema_ab_table_stdout_equal(tmp_path, capsys, markdown):
    import ema_ab_table as jtab
    from yunet_tpu_torch.tools import ema_ab_table as ptab
    path = tmp_path / "metrics.jsonl"
    path.write_text(
        _val(100, 0.9, 0.41, 0.40)
        + json.dumps({"step": 150, "mode": "train", "loss": 1.0}) + "\n"
        + _val(200, 0.91, 0.42, 0.45) + '{"step": 250, "mo'
        + _val(200, 0.92, 0.43, 0.44) + _val(300, 0.93, 0.47, 0.46)
        + json.dumps({"step": 300, "mode": "val", "easy": 0.1}) + "\n")
    argv = [str(path)] + (["--markdown"] if markdown else [])
    outs = []
    for mod in (jtab, ptab):
        assert mod.main(argv) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and "endpoint (step 300)" in outs[0].out
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"step": 1, "mode": "val", "easy": 1}) + "\n")
    for mod in (jtab, ptab):
        assert mod.main([str(empty)]) == 1
        assert "no --eval-both-params" in capsys.readouterr().err


# -- the band fixture and the quantization study ---------------------------

@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """A 3-image hard-tier val split with GT mats and its decoded cache
    (under data/val, make_synth_wider's layout), and a port checkpoint
    from the r04 weights whose EMA shadow differs from its parameters."""
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.data.cache import build_decoded_cache
    from yunet_tpu_torch.train.checkpoint import save_checkpoint
    from yunet_tpu_torch.train.step import init_train_state
    import dataclasses
    root = tmp_path_factory.mktemp("study")
    data = str(root / "data")
    val = os.path.join(data, "val")
    per_event = jgen.generate_split(val, 3, 31, tier=jgen.TIERS["hard"])
    jgen.write_gt_mats(os.path.join(val, "gt"), per_event)
    cache = str(root / "val_cache")
    build_decoded_cache(os.path.join(val, "labelv2.txt"),
                        os.path.join(val, "images"), cache, verbose=False)
    cfg = yunet_n()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_momentum=0.0002))
    sd = state_dict_from_r04(cfg)
    ts, opt = init_train_state(cfg, steps_per_epoch=1, total_batch=1,
                               device="cpu", state_dict=sd)
    g = torch.Generator().manual_seed(0)
    ts.ema = [e * (1 + 1e-3 * torch.randn(e.shape, generator=g))
              for e in ts.ema]
    ts.step = 40
    ckpt = save_checkpoint(str(root / "work"), ts, opt, epoch=4)
    names = [n for n, _ in ts.model.named_parameters()]
    ema_sd = dict(sd)
    ema_sd.update({n: e for n, e in zip(names, ts.ema)})
    return {"data": data, "val": val, "cache": cache, "ckpt": ckpt,
            "ema_sd": ema_sd, "root": root}


def state_dict_from_r04(cfg):
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    return state_dict_from_jax(*load_flat_npz(FIXTURE, cfg.model))


def test_band_fixture_reads_back_through_jax(study, tmp_path):
    import jax
    from yunet_tpu.config import yunet_n as jax_yunet_n
    from yunet_tpu.train.step import init_train_state
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.tools import export_band_fixture, test_widerface
    from yunet_tpu_torch.utils.jax_params import (_leaves,
                                                  jax_from_state_dict,
                                                  load_flat_npz)
    out = str(tmp_path / "band.npz")
    meta = export_band_fixture.main(
        ["--ckpt", study["ckpt"], "--data", study["data"], "--out", out,
         "--cache-dir", study["cache"]], device="cpu")
    blob = np.load(out, allow_pickle=False)
    fmeta = json.loads(str(blob["meta"]))
    assert set(fmeta) == {"step", "ckpt", "data", "n_params", "n_state",
                          "val_n", "tier", "mode0_aps", "mode2_aps"}
    assert fmeta == meta and fmeta["step"] == 40 and fmeta["val_n"] == 3
    want_p, want_s = jax_from_state_dict(study["ema_sd"], yunet_n().model)

    # tests/test_hard_band.py's _load_fixture path
    ts0, _ = init_train_state(jax_yunet_n(), steps_per_epoch=1,
                              total_batch=1)
    pleaves, ptree = jax.tree_util.tree_flatten(ts0.params)
    sleaves, stree = jax.tree_util.tree_flatten(ts0.state)
    assert len(pleaves) == fmeta["n_params"]
    assert len(sleaves) == fmeta["n_state"]
    params = jax.tree_util.tree_unflatten(
        ptree, [blob[f"p{i}"] for i in range(len(pleaves))])
    state = jax.tree_util.tree_unflatten(
        stree, [blob[f"s{i}"] for i in range(len(sleaves))])
    for (path, w), (_, g) in zip(_leaves(want_p), _leaves(params)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))
    for (path, w), (_, g) in zip(_leaves(want_s), _leaves(state)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))
    got_p, got_s = load_flat_npz(out, yunet_n().model)
    for (_, w), (_, g) in zip(_leaves(want_p), _leaves(got_p)):
        np.testing.assert_array_equal(g, w)

    # the recorded APs are test_widerface's on the same weights and split
    for key, mode in (("mode0_aps", 0), ("mode2_aps", 2)):
        aps = test_widerface.main(
            ["yunet_n", out, "--mode", str(mode), "--ann",
             os.path.join(study["val"], "labelv2.txt"), "--gt-dir",
             os.path.join(study["val"], "gt"), "--cache-dir",
             study["cache"], "--eval-log", str(tmp_path / "eval.log")],
            device="cpu")
        assert [fmeta[key][k] for k in ("easy", "medium", "hard")] \
            == [float(a) for a in aps], key


def test_quant_study_none_row_equal_jax(study, monkeypatch):
    pytest.importorskip("tensorflow")
    import quant_ap_study as jstudy
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.tools import quant_ap_study as pstudy
    from yunet_tpu_torch.utils.jax_params import jax_from_state_dict
    params, state = jax_from_state_dict(study["ema_sd"], yunet_n().model)
    monkeypatch.setattr(jstudy, "load_ema_params",
                        lambda ckpt, cfg: (params, state, {"step": 40}))
    argv = ["--ckpt", study["ckpt"], "--data", study["val"], "--shape",
            "160", "160", "--modes", "none"]
    want = jstudy.main(argv)
    got = pstudy.main(argv + ["--cache-dir", study["cache"]], device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want] \
        == ["onnx float32", "tflite none"]
    for (_, wsize, waps), (_, gsize, gaps) in zip(want, got):
        assert gsize == wsize
        np.testing.assert_allclose(gaps, waps, rtol=0, atol=1e-4)
