"""The port's training CLI (python -m yunet_tpu_torch.tools.train) against
tools/train.py: the same options and defaults, the same --smoke data, a
--smoke run that trains and checkpoints on the CPU, the in-training eval
through the CLI's options, and --distributed's refusal without a group.
Both CLIs log through their fit; tests/test_torch_loop.py holds the two
fits' log lines equal."""

import argparse
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

TINY = ["--cfg-options", "data.img_size=96", "data.max_gts=8",
        "data.samples_per_device=2", "train.bf16=false",
        "train.log_interval=1"]


def _parser(parse_args, monkeypatch):
    """The ArgumentParser that ``parse_args`` builds."""
    seen = []
    orig = argparse.ArgumentParser.parse_args

    def spy(self, *a, **kw):
        seen.append(self)
        return orig(self, *a, **kw)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        parse_args(["yunet_n"])
    return seen[-1]


def test_parse_args_takes_every_jax_option(monkeypatch):
    import train as jax_cli
    from yunet_tpu_torch.tools import train as cli
    ours = {a.dest: a for a in _parser(cli.parse_args, monkeypatch)._actions}
    theirs = {a.dest: a for a in
              _parser(jax_cli.parse_args, monkeypatch)._actions}
    assert set(theirs) <= set(ours)
    for dest, a in theirs.items():
        b = ours[dest]
        assert (b.option_strings, b.nargs, b.default, b.type, b.const) == \
            (a.option_strings, a.nargs, a.default, a.type, a.const), dest
    # the port's own: the eval image cache, and where to train
    assert set(ours) - set(theirs) == {"eval_cache_dir", "device"}
    args = cli.parse_args(["yunet_s", "--auto-resume", "--eval-interval",
                           "2", "--cfg-options", "train.lr=0.02",
                           "data.workers=8"])
    assert (args.config, args.auto_resume, args.eval_interval,
            args.cfg_options) == ("yunet_s", True, 2,
                                  ["train.lr=0.02", "data.workers=8"])


def test_smoke_trains_and_checkpoints():
    """--smoke on the CPU trains, logs and checkpoints (the log lines are
    held to JAX's in tests/test_torch_loop.py, where both fits run)."""
    import tempfile
    from yunet_tpu_torch.tools import train as cli
    with tempfile.TemporaryDirectory() as ours:
        ts = cli.main(["yunet_n", "--smoke", "--max-steps", "2",
                       "--work-dir", ours] + TINY, device="cpu")
        assert ts.step == 2
        assert os.path.isdir(os.path.join(ours, "ckpt_00000002"))
        with open(os.path.join(ours, "ckpt_00000002", "meta.json")) as f:
            assert json.load(f)["step"] == 2
        with open(os.path.join(ours, "train.log")) as f:
            log = f.read()
        assert "epoch 0 step 2/2 loss" in log and "saved checkpoint" in log


def test_cli_eval_hook_on_the_cache(tmp_path):
    """--eval-interval on the smoke loader fires at the last step, reading
    the val images from --eval-cache-dir, device NMS in the sweep."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    from yunet_tpu_torch.tools import train as cli
    val = str(tmp_path / "val")
    gen.write_gt_mats(os.path.join(val, "gt"),
                      gen.generate_split(val, 2, 4))
    ann, cache = os.path.join(val, "labelv2.txt"), str(tmp_path / "cache")
    build_decoded_cache(ann, os.path.join(val, "images"), cache,
                        verbose=False)
    work = str(tmp_path / "work")
    cli.main(["yunet_n", "--smoke", "--max-steps", "2", "--work-dir", work,
              "--eval-interval", "1", "--eval-mode", "0",
              "--eval-device-nms", "--eval-ann", ann,
              "--eval-gt-dir", os.path.join(val, "gt"),
              "--eval-img-prefix", str(tmp_path / "no_images"),
              "--eval-cache-dir", cache] + TINY, device="cpu")
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    vals = [r for r in rows if r["mode"] == "val"]
    assert [r["step"] for r in vals] == [2]
    assert all(0 <= vals[0][k] <= 1 for k in ("easy", "medium", "hard"))


def test_distributed_raises(monkeypatch):
    """--distributed with neither a process group nor torchrun's
    environment raises, naming what is missing (2 ranks:
    tests/test_torch_dist_cli.py)."""
    from yunet_tpu_torch.tools import train as cli
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun.*RANK, WORLD_SIZE"):
        cli.main(["yunet_n", "--distributed", "--smoke"], device="cpu")


def test_module_entry_point_runs():
    r = subprocess.run([sys.executable, "-m", "yunet_tpu_torch.tools.train",
                        "--help"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--eval-cache-dir" in r.stdout and "--cfg-options" in r.stdout


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_loader_equals_jax(seed):
    """--smoke's data: the same numpy batch as tools/smoke_data.py's."""
    import dataclasses
    import numpy as np
    from smoke_data import SyntheticLoader as JaxSyntheticLoader
    from yunet_tpu.config import yunet_n as jax_yunet_n
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.tools.smoke_data import SyntheticLoader

    def small(cfg):
        return dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, img_size=96, max_gts=8))
    ours = SyntheticLoader(small(yunet_n()), batch_size=2, seed=seed)
    theirs = JaxSyntheticLoader(small(jax_yunet_n()), batch_size=2,
                                seed=seed)
    assert ours.steps_per_epoch == theirs.steps_per_epoch
    a, b = next(iter(ours)), next(iter(theirs))
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    ours.close()
