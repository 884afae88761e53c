"""The port's training CLI data-parallel on the CPU:
``tools.train.main([... "--distributed" ...], device="cpu")`` in 2 gloo
ranks joined through a FileStore (tests/torch_dist_worker.py), and
``yunet_tpu_torch/tools/dist_train.sh`` through torch.distributed.run.

  * rank 0 alone writes the checkpoints, metrics.jsonl and train.log, in
    the one work dir both ranks share; each rank's loader is its shard;
    the gathered eval hook reports on rank 0;
  * kill and resume: 2 steps, then --auto-resume to 4, ends torch.equal
    to 4 straight steps (parameters, BN statistics, momentum trace and
    count, EMA shadow, step);
  * dist_train.sh trains 2 ranks on the CPU (--device cpu).

(--distributed with neither a group nor torchrun's environment raises:
tests/test_torch_train_cli.py::test_distributed_raises.)
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_data import make_train_split
from torch_dist_worker import ROOT, run_ranks
from yunet_tpu_torch.train.checkpoint import read_state

sys.path.insert(0, os.path.join(ROOT, "tools"))

STEPS = 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An 8-image train split with its cache, and a 4-image val split:
    {ann, prefix, cache, val_ann, val_gt, val_cache}."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    root = tmp_path_factory.mktemp("dist_cli")
    ann, prefix, cache = make_train_split(str(root))
    split = str(root / "val")
    per_event = gen.generate_split(split, 4, 11, tier=gen.TIERS["hard"])
    gen.write_gt_mats(os.path.join(split, "gt"), per_event)
    val_ann = os.path.join(split, "labelv2.txt")
    assert build_decoded_cache(val_ann, os.path.join(split, "images"),
                               str(root / "val_cache"), verbose=False) == 4
    return {"ann": ann, "prefix": prefix, "cache": cache, "val_ann": val_ann,
            "val_gt": os.path.join(split, "gt"),
            "val_cache": str(root / "val_cache")}


def _argv(data, work, steps, *extra):
    """2 images a rank at 96^2 (2 steps an epoch over the 8 images), a
    checkpoint every epoch, EMA and a 3-step warmup (each step's lr
    differs, so a lost count shows)."""
    return ["yunet_n", "--distributed", "--work-dir", work, "--max-steps",
            str(steps), *extra, "--cfg-options",
            f"data.train_ann={data['ann']}",
            f"data.train_img_prefix={data['prefix']}",
            f"data.decoded_cache={data['cache']}", "data.workers=0",
            "data.img_size=96", "data.samples_per_device=2",
            "data.max_gts=16", "train.bf16=false", "train.log_interval=1",
            "train.checkpoint_interval=1", "train.ema_momentum=0.01",
            "train.warmup_iters=3"]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """In one 2-rank group: 4 straight steps with the eval hook at step 4,
    then 2 steps and an auto-resume to 4 in another work dir. Returns
    (the ranks' results, straight work dir, broken work dir)."""
    root = tmp_path_factory.mktemp("dist_runs")
    straight, broken = str(root / "straight"), str(root / "broken")
    evals = ["--eval-interval", "2", "--eval-mode", "0", "--eval-ann",
             data["val_ann"], "--eval-gt-dir", data["val_gt"],
             "--eval-cache-dir", data["val_cache"]]
    ranks = run_ranks("cli", 2, root, {"runs": [
        _argv(data, straight, STEPS, *evals),
        _argv(data, broken, 2),
        _argv(data, broken, STEPS, "--auto-resume")]})
    return ranks, straight, broken


def _rows(work, mode):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r["mode"] == mode]


def test_rank_zero_alone_writes(runs):
    (r0, r1), straight, broken = runs
    assert r0["steps"] == r1["steps"] == [STEPS, 2, STEPS]
    assert r0["writes"] == ["ckpt_00000002", "ckpt_00000004",
                            "ckpt_00000002", "ckpt_00000004"]
    assert r1["writes"] == []
    assert [r["step"] for r in _rows(straight, "train")] == [1, 2, 3, 4]
    assert [r["step"] for r in _rows(broken, "train")] == [1, 2, 3, 4]
    with open(os.path.join(straight, "train.log")) as f:
        log = f.read()
    assert log.count(f"step {STEPS}/{STEPS} ") == 1
    assert "global batch 4, 2 devices" in log
    with open(os.path.join(straight, "latest")) as f:
        assert f.read().strip().endswith("ckpt_00000004")


def test_each_rank_loads_its_shard(runs):
    (r0, r1), _, _ = runs
    assert r0["shards"] == [(0, 2)] * 3 and r1["shards"] == [(1, 2)] * 3


def test_gathered_eval_reports_once(runs):
    _, straight, _ = runs
    vals = _rows(straight, "val")
    assert [v["step"] for v in vals] == [STEPS]
    assert all(0 <= vals[0][k] <= 1 for k in ("easy", "medium", "hard"))


def test_two_rank_resume_is_bit_exact(runs):
    _, straight, broken = runs
    a = read_state(os.path.join(straight, "ckpt_00000004"))
    b = read_state(os.path.join(broken, "ckpt_00000004"))
    assert a["step"] == b["step"] == STEPS
    assert a["opt_count"] == b["opt_count"] == STEPS
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for x, y in zip(a["opt_trace"] + a["ema"], b["opt_trace"] + b["ema"]):
        assert torch.equal(x, y)
    want = [r["loss"] for r in _rows(straight, "train")[2:]]
    assert [r["loss"] for r in _rows(broken, "train")[2:]] == want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dist_train_sh_runs_two_ranks_on_the_cpu(tmp_path):
    work = str(tmp_path / "work")
    env = dict(os.environ, NPROC="2", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="2",
               PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    r = subprocess.run(
        [os.path.join(ROOT, "yunet_tpu_torch", "tools", "dist_train.sh"),
         "yunet_n", "--device", "cpu", "--smoke", "--max-steps", "2",
         "--work-dir", work, "--cfg-options", "data.img_size=96",
         "data.samples_per_device=2", "data.max_gts=8", "train.bf16=false",
         "train.log_interval=1"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = _rows(work, "train")
    assert [x["step"] for x in rows] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in rows)
    with open(os.path.join(work, "train.log")) as f:
        assert "global batch 4, 2 devices" in f.read()
    assert sorted(os.listdir(work)) == ["ckpt_00000002", "latest",
                                        "metrics.jsonl", "tb", "train.log"]
