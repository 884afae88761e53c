"""The port's training loop (yunet_tpu_torch/train/loop.py:fit) against
yunet_tpu's, on the CPU:

  * both fits from the same reference-style .pth (JAX's initial
    parameters through state_dict_from_jax, read back equal by JAX's
    load_pth_params) on SyntheticLoader, f32, 4 steps with log_interval 1:
    the per-step metrics in metrics.jsonl agree within LOSS_RTOL, and the
    checkpoint layout, `latest` pointer and meta.json keys are JAX's;
  * kill and resume is bit-exact within the port: 2 steps, then
    auto-resume to 4, on a TrainLoader over a cached split (so the
    loader's cursor matters), equals 4 straight steps in the parameters,
    BN statistics, optimizer trace and count, EMA shadow, step and the
    step 3-4 losses;
  * the eval cadence of tests/test_loop.py, the finite-loss guard, the
    refusal of a mesh without a process group, and one step of
    device-side augmentation;
  * init_detector reads a checkpoint directory back to the same
    detections as the in-memory model.

JAX runs its factored ConvDPUnit (model.composed_dp=false), the
port's formulation: with JAX's default composed pw*dw conv the two runs
part at step 3, where a SimOTA positive flips on a random-init model.
LOSS_RTOL: measured on these inputs, the largest relative gap of a metric
grows from 1.3e-6 at step 1 to 4.5e-5 (loss_cls) at step 4; 1e-4 holds
that and the 1.3e-5 of JAX's f32 warmup schedule (ROADMAP Queue 3).
"""

import dataclasses
import json
import logging
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_data import make_train_split
from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.train.loop import fit as jax_fit
from yunet_tpu.utils.torch_import import load_pth_params
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.tools.smoke_data import SyntheticLoader
from yunet_tpu_torch.train.checkpoint import read_state
from yunet_tpu_torch.train.loop import fit
from yunet_tpu_torch.utils.jax_params import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

LOSS_RTOL = 1e-4
METRICS = ("loss", "loss_cls", "loss_obj", "loss_bbox", "loss_kps",
           "num_pos")


def tiny_cfg(mod=None, **train):
    """tests/test_loop.py's _tiny_cfg (96^2, 2 a batch, 8 GTs, f32,
    checkpoint every epoch) with log_interval 1 and ``train`` on top; of
    the port, or of ``mod``'s yunet_n."""
    cfg = (mod or yunet_n)()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_size=96, max_gts=8,
                                 samples_per_device=2),
        train=dataclasses.replace(cfg.train, **{
            "bf16": False, "log_interval": 1, "checkpoint_interval": 1,
            **train}))


def metrics_rows(work_dir, mode="train"):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r["mode"] == mode]


def _synthetic(loader_cls, cfg, steps_per_epoch=4):
    loader = loader_cls(cfg, batch_size=2)
    loader.steps_per_epoch = steps_per_epoch
    return loader


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """JAX's initial yunet_n parameters as a reference-style .pth."""
    params, state = JaxYuNet(jax_yunet_n().model).init(jax.random.PRNGKey(1))
    params, state = jax.tree.map(np.asarray, (params, state))
    path = str(tmp_path_factory.mktemp("pth") / "init.pth")
    torch.save({"state_dict": state_dict_from_jax(params, state)}, path)
    back = load_pth_params(path)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a)
    assert (jax.tree_util.tree_structure((params, state))
            == jax.tree_util.tree_structure(back))
    return path


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.msgs = []

    def emit(self, record):
        self.msgs.append(record.getMessage())


@pytest.fixture(scope="module")
def both_fits(pth, tmp_path_factory):
    """(port work dir, port TrainState, JAX work dir, JAX's log messages)
    after 4 steps. JAX's logger writes the train.log of the first run in
    a process only, so its messages are read off the logger."""
    from smoke_data import SyntheticLoader as JaxSyntheticLoader
    from yunet_tpu.utils.logging import get_logger
    root = tmp_path_factory.mktemp("fits")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jcfg = tiny_cfg(jax_yunet_n)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, composed_dp=False))
    jax_log, collect = get_logger(), _Collect()
    jax_log.addHandler(collect)
    try:
        jax_fit(jcfg, work_dir=jdir, max_steps=4, load_pth=pth,
                loader=_synthetic(JaxSyntheticLoader, jcfg))
    finally:
        jax_log.removeHandler(collect)
    cfg = tiny_cfg()
    ts = fit(cfg, device="cpu", work_dir=tdir, max_steps=4, load_pth=pth,
             loader=_synthetic(SyntheticLoader, cfg))
    return tdir, ts, jdir, collect.msgs


def _masked(msgs):
    """Log messages after the environment block, numbers and paths
    masked."""
    return [re.sub(r"-?\d+(\.\d+)?|/\S+", "#", m.rstrip("\n"))
            for m in msgs if not m.startswith("environment")]


def test_fit_logs_like_jax(both_fits):
    tdir, _, _, jax_msgs = both_fits
    with open(os.path.join(tdir, "train.log")) as f:
        got = _masked(line.split(" - INFO - ", 1)[1] for line in f
                      if " - INFO - " in line)
    # weights loaded, the header, 4 steps, the checkpoint
    assert got == _masked(jax_msgs) and len(got) == 7


def test_fit_losses_match_jax(both_fits):
    tdir, ts, jdir, _ = both_fits
    got, want = metrics_rows(tdir), metrics_rows(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        [1, 2, 3, 4]
    assert ts.step == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"{k} at step {w['step']}")
        assert np.isfinite(g["imgs_per_sec"]) and g["imgs_per_sec"] > 0
    # the parameters moved: the losses are not one value repeated
    assert len({r["loss"] for r in got}) == 4


def test_checkpoint_layout_and_meta_match_jax(both_fits):
    tdir, _, jdir, _ = both_fits
    ckpts = sorted(d for d in os.listdir(tdir) if d.startswith("ckpt_"))
    assert ckpts == sorted(d for d in os.listdir(jdir)
                           if d.startswith("ckpt_")) == ["ckpt_00000004"]
    for d in (tdir, jdir):
        with open(os.path.join(d, "latest")) as f:
            assert f.read() == os.path.join(os.path.abspath(d), ckpts[0])
    # each run logs into its own work dir (JAX's logger keeps the first
    # run's file of the process, so its dir is not checked)
    with open(os.path.join(tdir, "train.log")) as f:
        assert "saved checkpoint" in f.read()
    metas = []
    for d in (tdir, jdir):
        with open(os.path.join(d, ckpts[0], "meta.json")) as f:
            metas.append(json.load(f))
    assert sorted(metas[0]) == sorted(metas[1])
    for k in ("step", "epoch", "classes", "config"):
        assert metas[0][k] == metas[1][k], k
    state = read_state(os.path.join(tdir, ckpts[0]))
    assert sorted(state) == ["ema", "model", "opt_count", "opt_trace",
                             "step"]
    assert state["step"] == state["opt_count"] == 4


def test_init_detector_from_checkpoint_dir(both_fits):
    """The checkpoint directory through init_detector gives the raw
    outputs and detections of the trained in-memory model."""
    from yunet_tpu_torch.apis import init_detector
    from yunet_tpu_torch.eval.detect import Detector
    tdir, ts, _, _ = both_fits
    cfg = tiny_cfg()
    loaded = init_detector(cfg, os.path.join(tdir, "ckpt_00000004"),
                           device="cpu", dtype=torch.float32)
    live = Detector(cfg, ts.model.state_dict(), device="cpu",
                    dtype=torch.float32)
    img = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    x = live._input([img])
    for a, b in zip(loaded.raw(x, conv_kernel=False),
                    live.raw(x, conv_kernel=False)):
        assert torch.equal(a, b)
    for a, b in zip(loaded.detect(img, score_thr=0.0).values(),
                    live.detect(img, score_thr=0.0).values()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cached_split(tmp_path_factory):
    return make_train_split(str(tmp_path_factory.mktemp("resume_split")))


def test_kill_and_resume_is_bit_exact(cached_split, pth, tmp_path):
    ann, prefix, cache = cached_split
    # a 3-step warmup: each step's lr differs, so a lost count shows
    cfg = tiny_cfg(ema_momentum=0.01, warmup_iters=3)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, train_ann=ann, train_img_prefix=prefix,
        decoded_cache=cache, workers=0))
    straight, broken = str(tmp_path / "straight"), str(tmp_path / "broken")
    ts = fit(cfg, device="cpu", work_dir=straight, max_steps=4,
             load_pth=pth)
    fit(cfg, device="cpu", work_dir=broken, max_steps=2, load_pth=pth)
    assert os.path.isdir(os.path.join(broken, "ckpt_00000002"))
    ts2 = fit(cfg, device="cpu", work_dir=broken, max_steps=4,
              load_pth=pth, auto_resume=True)
    assert ts.step == ts2.step == 4
    a = read_state(os.path.join(straight, "ckpt_00000004"))
    b = read_state(os.path.join(broken, "ckpt_00000004"))
    assert a["step"] == b["step"] == 4 and a["opt_count"] == b["opt_count"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for name in ("opt_trace", "ema"):
        assert len(a[name]) == len(b[name]) > 0
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name
    for x, y in zip(ts.ema, ts2.ema):
        assert torch.equal(x, y)
    rows_a, rows_b = metrics_rows(straight), metrics_rows(broken)
    assert [r["step"] for r in rows_b] == [1, 2, 3, 4]
    for ra, rb in zip(rows_a[2:], rows_b[2:]):
        for k in METRICS:
            assert ra[k] == rb[k], (k, ra["step"])
    # the loader's cursor mattered: steps 3 and 4 saw other batches than
    # steps 1 and 2, so a loader restarted at step 0 would differ
    assert rows_a[2]["num_pos"] != rows_a[0]["num_pos"] or \
        rows_a[3]["num_pos"] != rows_a[1]["num_pos"]


def test_eval_cadence_matches_jax(tmp_path):
    """tests/test_loop.py:test_fit_and_auto_resume's cadence: 4 steps,
    then a resume to 8 with the hook every epoch of 4 fires at 8 only."""
    cfg = tiny_cfg(log_interval=2)
    ts = fit(cfg, device="cpu", work_dir=str(tmp_path), max_steps=4,
             loader=_synthetic(SyntheticLoader, cfg))
    assert ts.step == 4 and os.path.exists(tmp_path / "latest")
    evals = []

    def eval_hook(state, step):
        evals.append(step)
        return {"mAP": 0.5}

    ts2 = fit(cfg, device="cpu", work_dir=str(tmp_path), auto_resume=True,
              max_steps=8, loader=_synthetic(SyntheticLoader, cfg),
              eval_hook=eval_hook, eval_interval_epochs=1)
    assert ts2.step == 8 and evals == [8]
    assert [r["step"] for r in metrics_rows(str(tmp_path), "val")] == [8]
    assert [r["step"] for r in metrics_rows(str(tmp_path))] == [2, 4, 6, 8]


def test_fit_raises_on_nan(tmp_path):
    cfg = tiny_cfg(lr=1e10, warmup_iters=0)
    with pytest.raises(FloatingPointError):
        fit(cfg, device="cpu", work_dir=str(tmp_path), max_steps=6,
            loader=_synthetic(SyntheticLoader, cfg, 100))


def test_fit_refuses_a_mesh_and_device_aug(cached_split, tmp_path):
    """A mesh with no process group behind it is refused (data-parallel
    fit: tests/test_torch_dist_cli.py); data.device_aug trains: the bank
    is staged and one step runs on it (tests/test_torch_device_aug.py
    holds it to JAX's)."""
    from yunet_tpu_torch.parallel import Mesh
    cfg = tiny_cfg()
    with pytest.raises(ValueError, match="process group"):
        fit(cfg, device="cpu", work_dir=str(tmp_path), max_steps=1,
            mesh=Mesh(0, 2, torch.device("cpu")),
            loader=_synthetic(SyntheticLoader, cfg))
    ann, prefix, cache = cached_split
    aug = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, device_aug=True, train_ann=ann, train_img_prefix=prefix,
        decoded_cache=cache, bank_size=96, bank_canvas=192))
    ts = fit(aug, device="cpu", work_dir=str(tmp_path / "aug"), max_steps=1)
    assert ts.step == 1
    rows = metrics_rows(str(tmp_path / "aug"))
    assert [r["step"] for r in rows] == [1] and np.isfinite(rows[0]["loss"])
    with open(tmp_path / "aug" / "train.log") as f:
        assert "staged 8 images" in f.read()


def test_sample_stats_and_memory_hooks_match_jax(tmp_path):
    """SampleSizeStatistics equal to JAX's on the same batches, and fit's
    --sample-stats dump; MemoryProfiler reads this process."""
    from yunet_tpu.train.hooks import SampleSizeStatistics as JaxStats
    from yunet_tpu_torch.train.hooks import (MemoryProfiler,
                                             SampleSizeStatistics)
    ours, theirs = SampleSizeStatistics(), JaxStats()
    rng = np.random.RandomState(0)
    for _ in range(3):
        xy = rng.uniform(0, 500, (2, 8, 2))
        batch = {"gt_bboxes": np.concatenate(
            [xy, xy + rng.uniform(1, 600, (2, 8, 2))], -1).astype(np.float32),
            "gt_valid": rng.uniform(size=(2, 8)) < 0.7}
        ours.update(batch)
        theirs.update(batch)
    assert ours.summary() == theirs.summary() and ours.total == theirs.total
    assert MemoryProfiler.rss_mb() > 0
    cfg = tiny_cfg()
    fit(cfg, device="cpu", work_dir=str(tmp_path), max_steps=2,
        loader=_synthetic(SyntheticLoader, cfg), sample_stats=True)
    with open(tmp_path / "sample_size_stats.json") as f:
        dumped = json.load(f)
    # SyntheticLoader: 6 valid GTs an image, 2 images, 2 steps
    assert dumped["total"] == 24 and sum(dumped["hist"].values()) == 24
