"""The port's rehearsal tool (yunet_tpu_torch/tools/run_rehearsal.py) on
the CPU:

  * a real SIGKILL and auto-resume of ``python -m
    yunet_tpu_torch.tools.train`` at 96^2 (device-aug bank, b2, a
    checkpoint every epoch, train images from the decoded cache, no eval:
    the card's phase_study runs the evals): rc 0, duplicated steps
    present and every one bit-exact, no trainer process left;
  * check_resume_bitexact against tools/misc/run_rehearsal.py's on the
    same files: a killed leg's truncated line is skipped, a mismatch is
    counted and fails the tool's gate;
  * the trainer's command line carries JAX's options plus the caches.
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tools", "misc"))

import run_rehearsal as jax_reh  # noqa: E402

from yunet_tpu_torch.tools import run_rehearsal as reh  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An 8-image hard-tier train split (make_synth_wider.py's layout) and
    its decoded cache."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    root = str(tmp_path_factory.mktemp("reh") / "data")
    gen.generate_split(os.path.join(root, "train"), 8, 3,
                       tier=gen.TIERS["hard"])
    build_decoded_cache(os.path.join(root, "train", "labelv2.txt"),
                        os.path.join(root, "train", "images"),
                        os.path.join(root, "train_cache"), verbose=False)
    return root


def _argv(data, work):
    return ["--data", data, "--work-dir", work, "--batch", "2",
            "--epochs", "2", "--eval-interval", "0", "--kill-at", "6",
            "--leg-timeout", "240",
            "--decoded-cache", os.path.join(data, "train_cache"),
            "--cfg-options", "data.img_size=96", "data.bank_size=96",
            "data.bank_canvas=160", "train.checkpoint_interval=1",
            "train.log_interval=1", "data.workers=0"]


def test_kill_and_resume_bitexact(data, tmp_path, capsys, monkeypatch):
    # the trainers on two threads each: the test shares the CPU with others
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    work = str(tmp_path / "work")
    assert reh.main(_argv(data, work), device="cpu") == 0
    out = capsys.readouterr().out
    assert "killing trainer at step >= 6" in out, out
    dup, exact = reh.check_resume_bitexact(
        os.path.join(work, "metrics.jsonl"))
    # the killed leg logged past the step-4 checkpoint; the resumed leg
    # logged those steps again, bit for bit
    assert dup >= 2 and exact == dup, (dup, exact)
    assert f"{dup} duplicated steps, {exact} bit-exact" in out
    assert os.path.isdir(os.path.join(work, "ckpt_00000008"))
    assert not _processes_naming(work)


def _processes_naming(text):
    """Pids of live processes whose command line contains text."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if text.encode() in f.read():
                    pids.append(int(pid))
        except OSError:
            continue
    return pids


def _metrics(path, lines):
    with open(path, "w") as f:
        f.write("".join(lines))
    return str(path)


def _train(step, loss):
    return json.dumps({"step": step, "mode": "train", "loss": loss}) + "\n"


@pytest.mark.parametrize("case", ["truncated", "mismatch", "clean"])
def test_check_resume_bitexact_matches_jax(tmp_path, case):
    lines = [_train(s, 1.0 / s) for s in range(1, 7)]
    lines.append(json.dumps({"step": 4, "mode": "val", "easy": 0.5}) + "\n")
    if case == "truncated":
        # the killed leg's last line, cut: the resumed leg's first line
        # (step 5) runs on after it, and the two are skipped together
        lines.append('{"step": 7, "mode": "tr')
    lines += [_train(s, 1.0 / s) for s in range(5, 9)]
    if case == "mismatch":
        lines[-3] = _train(6, 1.0 / 6 + 1e-12)
    path = _metrics(tmp_path / "metrics.jsonl", lines)
    got = reh.check_resume_bitexact(path)
    assert got == jax_reh.check_resume_bitexact(path)
    assert got == {"truncated": (1, 1), "mismatch": (2, 1),
                   "clean": (2, 2)}[case]


def test_mismatch_fails_the_rehearsal(tmp_path, monkeypatch, capsys):
    """main() returns 1 when a duplicated step's loss differs (the legs
    themselves are stubbed)."""
    _metrics(tmp_path / "metrics.jsonl",
             [_train(s, float(s)) for s in (1, 2, 3)] + [_train(2, 2.5)])
    monkeypatch.setattr(reh, "run_leg", lambda *a, **kw: (0, True))
    assert reh.main(["--data", "d", "--work-dir", str(tmp_path),
                     "--kill-at", "2"], device="cpu") == 1
    assert "FAIL: resume not bit-exact" in capsys.readouterr().out


def test_train_cmd_has_jax_options_and_caches(tmp_path):
    args = reh.parse_args(["--data", "d", "--work-dir", "w", "--lr", "0.02",
                           "--decoded-cache", "tc", "--eval-cache-dir", "vc",
                           "--eval-both-params", "--cfg-options", "a.b=1"])
    cmd = reh.train_cmd(args, "cuda")
    assert cmd[1:4] == ["-m", "yunet_tpu_torch.tools.train", "yunet_n"]
    for opt in ("--auto-resume", "--eval-both-params"):
        assert opt in cmd
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--eval-mode") + 1] == "2"
    assert cmd[cmd.index("--eval-cache-dir") + 1] == os.path.abspath("vc")
    d = os.path.abspath("d")
    for want in (f"data.train_ann={d}/train/labelv2.txt",
                 f"data.val_ann={d}/val/labelv2.txt",
                 f"data.gt_dir={d}/val/gt/", "data.device_aug=true",
                 "data.samples_per_device=128", "train.max_epochs=600",
                 "train.ema_momentum=0.0002", "train.lr=0.02",
                 f"data.decoded_cache={os.path.abspath('tc')}", "a.b=1"):
        assert want in cmd, want
