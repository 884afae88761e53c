"""Rank processes for the port's data-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_dist_cli.py).

``run_ranks(job, world, tmp_dir, args)`` starts ``world`` processes of
this file, each joining one gloo process group through a FileStore in
``tmp_dir`` (no port, so parallel test workers cannot collide), runs
``JOBS[job](mesh, args)`` on the CPU and returns each rank's result. A
rank imports torch and yunet_tpu_torch, never the JAX package. The call
has a timeout that bounds every rank; a rank that fails or overruns
fails the call with every rank's output.

    python tests/torch_dist_worker.py JOB RANK WORLD STORE OUT ARGS_JSON
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
RANK_TIMEOUT_S = 120


def run_ranks(job, world, tmp_dir, args, timeout=RANK_TIMEOUT_S):
    import torch
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    tag = f"{job}-{time.monotonic_ns()}"
    store = os.path.join(tmp_dir, f"{tag}.store")
    outs = [os.path.join(tmp_dir, f"{tag}.rank{r}.pt") for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         store, outs[r], json.dumps(args)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs, failed = [], False
    deadline = time.monotonic() + timeout
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\n[rank {r} passed its {timeout} s timeout]"
            failed = True
        logs.append(f"--- rank {r} (rc {p.returncode}) ---\n{out}")
        failed |= p.returncode != 0
    if failed:
        raise AssertionError(f"{job}: a rank failed\n" + "\n".join(logs))
    # files this test's own ranks wrote
    return [torch.load(o, weights_only=False) for o in outs]


# -- jobs (run in the rank processes) ---------------------------------------

def _cfg(args):
    """yunet_n at args' image size, per-rank batch and GT slots, f32, with
    args["train"] on top."""
    import dataclasses
    from yunet_tpu_torch.config import yunet_n
    cfg = yunet_n()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_size=args["img"],
                                 samples_per_device=args["batch"],
                                 max_gts=args.get("max_gts", 128),
                                 **args.get("data", {})),
        train=dataclasses.replace(cfg.train, **{"bf16": False,
                                                **args.get("train", {})}))


def _r04_state(cfg, total_batch):
    from yunet_tpu_torch.train import init_train_state
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, cfg.model))
    return init_train_state(cfg, steps_per_epoch=10,
                            total_batch=total_batch, device="cpu",
                            state_dict=sd)


def _train(cfg, mesh, batches, world, perturb=False):
    """Steps from r04 on this rank's rows of each global batch: {metrics
    per step, model state dict, EMA shadow, momentum trace}. ``perturb``:
    the ranks past 0 start from other parameters and BN statistics (the
    step's first call must replace them with rank 0's)."""
    import torch
    from yunet_tpu_torch.parallel import shard_batch
    from yunet_tpu_torch.train import make_train_step
    ts, opt = _r04_state(cfg, cfg.data.samples_per_device * world)
    if perturb and mesh.rank > 0:
        with torch.no_grad():
            for t in ts.model.state_dict().values():
                if t.is_floating_point():
                    t.mul_(1.5)
    step = make_train_step(cfg, ts.model, opt, img_size=cfg.data.img_size,
                           mesh=mesh)
    metrics = []
    for batch in batches:
        ts, m = step(ts, shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": ts.model.state_dict(),
            "ema": ts.ema, "trace": opt.trace, "step": ts.step}


def job_step(mesh, args):
    """args["steps"] global batches from the npz args["batches"]; with
    args["plain"], the same steps with mesh=None beside (a world of one)."""
    import numpy as np
    data = np.load(args["batches"])
    keys = ("image", "gt_bboxes", "gt_labels", "gt_kps", "gt_valid")
    batches = [{k: data[f"{k}{i}"] for k in keys}
               for i in range(args["steps"])]
    cfg = _cfg(args)
    out = {"mesh": _train(cfg, mesh, batches, mesh.size,
                          args.get("perturb", False))}
    if args.get("plain"):
        out["plain"] = _train(cfg, None, batches, 1)
    return out


def job_device_aug_step(mesh, args):
    """fit's default loader (train/loop.py:build_loader) with
    data.device_aug and data.bank_sharded: this rank's bank and its first
    args["steps"] batches, and the steps on them from r04."""
    from yunet_tpu_torch.train import make_train_step
    from yunet_tpu_torch.train.loop import build_loader
    cfg = _cfg(args)
    loader = build_loader(cfg, mesh=mesh)
    try:
        it = iter(loader)
        batches = [next(it) for _ in range(args["steps"])]
    finally:
        loader.close()
    bank = loader.bank.to_device("cpu")
    ts, opt = _r04_state(cfg, cfg.data.samples_per_device * mesh.size)
    step = make_train_step(cfg, ts.model, opt, img_size=cfg.data.img_size,
                           mesh=mesh)
    metrics = []
    for b in batches:
        b = {k: v for k, v in b.items() if k != "num_overflow"}
        ts, m = step(ts, {**b, "bank": bank})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"bank": loader.bank.images, "records": [
        r.filename for r in loader.bank.records], "batches": batches,
        "metrics": metrics, "state": ts.model.state_dict()}


def job_gather(mesh, args):
    """The rank's round-robin shard of seeded per-image detections (some
    images with none) through _gather_sharded_detections."""
    from yunet_tpu_torch.eval.eval_hook import _gather_sharded_detections
    dets = detections(args["n"], args["seed"])
    return _gather_sharded_detections(dets[mesh.rank::mesh.size], args["n"],
                                      mesh.size, mesh.rank)


def detections(n, seed):
    """n seeded (k, 5) f32 arrays, k in 0..6 (every third image has none)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 500, (0 if i % 3 == 1 else rng.randint(1, 7),
                                 5)).astype(np.float32) for i in range(n)]


def job_hook(mesh, args):
    """The WIDER eval hook in f32 on r04 over args' split; the APs (None
    off rank 0)."""
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.eval.eval_hook import (make_wider_eval_hook,
                                                widerface_eval_mode)
    cfg = _cfg({"img": 640, "batch": 1,
                "train": {"ema_momentum": args.get("ema", 0.0)}})
    ts, _ = _r04_state(cfg, 1)
    hook = make_wider_eval_hook(
        cfg, device="cpu", mode=widerface_eval_mode(args["mode"]),
        ann=args["ann"], gt_dir=args["gt"], cache_dir=args["cache"],
        img_prefix=args["cache"], mesh=mesh, dtype=torch.float32,
        use_device_nms=args.get("device_nms", False),
        also_raw=args.get("also_raw", False))
    return hook(ts, 1)


def job_cli(mesh, args):
    """yunet_tpu_torch.tools.train's main(argv, device="cpu") for each
    argv of args["runs"], in this group; each run's final step and
    checkpoint writes, and the rank's loader shard."""
    from yunet_tpu_torch.tools import train as cli
    from yunet_tpu_torch.train import checkpoint, loop
    writes, shards = [], []
    write, build = checkpoint._write, loop.build_loader

    def counted_write(*a, **kw):
        writes.append(os.path.basename(a[1]))
        return write(*a, **kw)

    def recorded_build(*a, **kw):
        loader = build(*a, **kw)
        shards.append((loader.process_index, loader.process_count))
        return loader

    checkpoint._write, loop.build_loader = counted_write, recorded_build
    try:
        steps = [cli.main(argv, device="cpu").step for argv in args["runs"]]
    finally:
        checkpoint._write, loop.build_loader = write, build
    return {"steps": steps, "writes": writes, "shards": shards}


JOBS = {"step": job_step, "device_aug_step": job_device_aug_step,
        "gather": job_gather, "hook": job_hook, "cli": job_cli}


def main():
    job, rank, world, store, out, args = sys.argv[1:]
    rank, world, args = int(rank), int(world), json.loads(args)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from yunet_tpu_torch.parallel import make_mesh
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = JOBS[job](make_mesh("cpu", always=True), args)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()
    # jax may come in only with TensorFlow (metrics.jsonl's TensorBoard
    # writer imports it where it is installed), never through the port
    if "yunet_tpu" in sys.modules or ("jax" in sys.modules
                                      and "tensorflow" not in sys.modules):
        raise SystemExit("a rank imported jax or yunet_tpu")


if __name__ == "__main__":
    main()
