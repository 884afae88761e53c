"""Training dress rehearsal — counterpart of
``tools/misc/run_rehearsal.py`` over ``python -m
yunet_tpu_torch.tools.train``.

Runs the recipe end to end on a synthetic WIDER-shaped dataset
(``make_synth_wider.py``'s layout): the trainer at --batch, the
device-side augmentation bank (default), EMA on, the WIDER eval hook every
--eval-interval epochs. It SIGKILLs the trainer once metrics.jsonl
crosses --kill-at, relaunches it with --auto-resume, and checks that the
resumed leg reproduces the killed leg's post-checkpoint losses bit for
bit (the reference's resume_from contract).

  python -m yunet_tpu_torch.tools.run_rehearsal \\
      --data data/synth_wider_hard --work-dir work_dirs/rehearsal \\
      --epochs 600 --kill-at 1620 \\
      --decoded-cache data/synth_wider_hard/train_cache \\
      --eval-cache-dir data/synth_wider_hard/val_cache

On a host without OpenCV (the card host) the train images come from
--decoded-cache and the eval images from --eval-cache-dir (decoded .npy
caches, data/cache.py). The trainer is a child process that leads its
own process group: the kill goes to the whole group, so no forked
loader worker outlives it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def train_cmd(args, device):
    """The trainer's command line. Paths are made absolute: the trainer
    runs from the repository root."""
    d = os.path.abspath(args.data)
    cmd = [
        sys.executable, "-m", "yunet_tpu_torch.tools.train",
        args.config,
        "--work-dir", os.path.abspath(args.work_dir),
        "--seed", str(args.seed),
        "--auto-resume",
        "--device", str(device),
        "--eval-interval", str(args.eval_interval),
        "--eval-mode", "2",
        "--cfg-options",
        f"data.train_ann={d}/train/labelv2.txt",
        f"data.train_img_prefix={d}/train/images/",
        f"data.val_ann={d}/val/labelv2.txt",
        f"data.val_img_prefix={d}/val/images/",
        f"data.gt_dir={d}/val/gt/",
        f"data.device_aug={'true' if args.device_aug else 'false'}",
        f"data.samples_per_device={args.batch}",
        f"train.max_epochs={args.epochs}",
        f"train.ema_momentum={args.ema_momentum}",
    ]
    if args.lr is not None:
        cmd.append(f"train.lr={args.lr}")
    if args.decoded_cache:
        cmd.append("data.decoded_cache="
                   + os.path.abspath(args.decoded_cache))
    cmd += args.cfg_options
    if args.eval_both_params:
        cmd.append("--eval-both-params")
    if args.eval_device_nms:
        cmd.append("--eval-device-nms")
    if args.eval_cache_dir:
        cmd += ["--eval-cache-dir", os.path.abspath(args.eval_cache_dir)]
    return cmd


# seconds between reads of metrics.jsonl while a leg runs: a step on the
# card takes ~0.1 s, and the kill must land before the next checkpoint
POLL_S = 0.05


class _StepWatch:
    """The highest train step in metrics.jsonl so far, read from where the
    last call stopped (whole lines only)."""

    def __init__(self, path):
        self.path, self.pos, self.last = path, 0, 0

    def __call__(self):
        if not os.path.exists(self.path):
            return self.last
        with open(self.path, "rb") as f:
            f.seek(self.pos)
            chunk = f.read()
        end = chunk.rfind(b"\n") + 1
        self.pos += end
        for ln in chunk[:end].splitlines():
            try:
                r = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if r.get("mode") == "train":
                self.last = max(self.last, r.get("step", 0))
        return self.last


def run_leg(cmd, log_path, metrics_path, kill_at=None, timeout=None):
    """Run one trainer leg; if kill_at, SIGKILL its process group once
    metrics.jsonl shows a train step >= kill_at. A leg still running
    after ``timeout`` seconds is killed the same way and raises. Returns
    (exit_code, killed)."""
    t0 = time.monotonic()
    last_step = _StepWatch(metrics_path)
    with open(log_path, "a") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=REPO, start_new_session=True)
        try:
            while proc.poll() is None:
                time.sleep(POLL_S)
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"trainer still running after "
                                       f"{timeout} s")
                if kill_at is None or last_step() < kill_at:
                    continue
                print(f"[rehearsal] killing trainer at step >= {kill_at} "
                      f"(pid {proc.pid})", flush=True)
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                return proc.returncode, True
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return proc.returncode, False


def check_resume_bitexact(metrics_path):
    """The resumed leg re-logs steps after the restored checkpoint; any
    step logged by both legs must carry the identical loss. Returns
    (duplicated steps, bit-exact ones)."""
    by_step = {}
    dup, exact = 0, 0
    with open(metrics_path) as f:
        for ln in f:
            try:
                r = json.loads(ln)
            except json.JSONDecodeError:
                # a SIGKILLed leg 1 can leave a truncated trailing line
                # that leg 2 then appends after: skip it
                continue
            if r.get("mode") != "train":
                continue
            s = r["step"]
            if s in by_step:
                dup += 1
                if by_step[s] == r["loss"]:
                    exact += 1
                else:
                    print(f"[rehearsal] MISMATCH step {s}: "
                          f"{by_step[s]} vs {r['loss']}", flush=True)
            else:
                by_step[s] = r["loss"]
    return dup, exact


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Training dress rehearsal: "
                                "kill, auto-resume, bit-exact check")
    p.add_argument("--config", default="yunet_n")
    p.add_argument("--data", default="data/synth_wider_hard")
    p.add_argument("--work-dir", default="work_dirs/rehearsal")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--eval-interval", type=int, default=250)
    p.add_argument("--ema-momentum", type=float, default=0.0002)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kill-at", type=int, default=0,
                   help="SIGKILL the first leg at this train step, then "
                        "auto-resume (0 = single uninterrupted leg)")
    p.add_argument("--device-aug", dest="device_aug", action="store_true",
                   default=True,
                   help="card-staged bank + on-device aug (default)")
    p.add_argument("--no-device-aug", dest="device_aug",
                   action="store_false",
                   help="host loader pipeline instead (the path for "
                        "datasets the bank's capacity guard rejects)")
    p.add_argument("--decoded-cache", default=None,
                   help="decoded-image cache dir of the train split "
                        "(data/cache.py; the card host's only image source)")
    p.add_argument("--eval-cache-dir", default=None,
                   help="decoded-image cache dir of the val split, passed "
                        "to the trainer's --eval-cache-dir")
    p.add_argument("--eval-both-params", action="store_true",
                   help="evaluate BOTH EMA and raw params each interval "
                        "(raw_* metrics) — in-run EMA A/B")
    p.add_argument("--eval-device-nms", action="store_true",
                   help="the eval sweep's NMS on the device (the trainer's "
                        "--eval-device-nms)")
    p.add_argument("--leg-timeout", type=float, default=None,
                   help="kill a leg still running after this many seconds "
                        "and fail")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="extra dotted overrides appended to the trainer's")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    """Run the rehearsal; returns 0 on success, 1 on a failed leg or a
    resume that is not bit-exact. ``device``: the trainer's --device (the
    tests pass the CPU)."""
    args = parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    log_path = os.path.join(args.work_dir, "train.log")
    metrics = os.path.join(args.work_dir, "metrics.jsonl")
    cmd = train_cmd(args, device)
    print("[rehearsal] " + " ".join(cmd), flush=True)

    t0 = time.time()
    legs = dict(timeout=args.leg_timeout)
    if args.kill_at:
        code, killed = run_leg(cmd, log_path, metrics, kill_at=args.kill_at,
                               **legs)
        if not killed:
            print(f"[rehearsal] WARNING: leg 1 exited (code {code}) before "
                  f"the kill point", flush=True)
    code, _ = run_leg(cmd, log_path, metrics, **legs)
    if code != 0:
        print(f"[rehearsal] FAIL: trainer exited {code}", flush=True)
        return 1

    if args.kill_at:
        dup, exact = check_resume_bitexact(metrics)
        print(f"[rehearsal] resume overlap: {dup} duplicated steps, "
              f"{exact} bit-exact", flush=True)
        if dup == 0 or exact != dup:
            print("[rehearsal] FAIL: resume not bit-exact", flush=True)
            return 1

    vals = []
    with open(metrics) as f:
        for ln in f:
            try:
                r = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if r.get("mode") == "val":
                vals.append(r)
    print(f"[rehearsal] done in {time.time() - t0:.0f}s; val records:",
          flush=True)
    for v in vals:
        print("  " + json.dumps(v), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
