"""The port's data parallelism (yunet_tpu_torch/parallel/, the step, fit's
loaders and the eval hook with a ``mesh``) on the CPU, ranks as gloo
processes joined through a FileStore (tests/torch_dist_worker.py):

  * 2 ranks at b2 a rank against JAX's step on a 2-device ``dp`` mesh on
    the same global batches, f32, 3 steps from r04 with EMA and clipping;
    the tolerances are JAX's own for a mesh against one device
    (tests/test_train_step.py:55-90,357-397): losses rtol 1e-4, num_pos
    exact, params and EMA rtol 1e-3 / atol 3e-5, BN statistics rtol 1e-4
    / atol 1e-6;
  * the GhostBN identity in the port: the 2 ranks against one process at
    b4 with bn_group=2, under the same tolerances;
  * a world of one: torch.equal to mesh=None after 3 steps;
  * fit's loaders: rank r's TrainLoader batches equal to JAX's
    TrainLoader(process_index=r, process_count=2) and to rows [2r, 2r+2)
    of the one-process loader at b4; rank r's DeviceAugLoader bank and
    batches equal to JAX's; a 2-rank device-aug step against JAX's
    2-device mesh step on the concatenated banks, sharded P("dp");
  * the eval hook's gather restores the record order bit for bit, and
    the 2-rank hook's APs (rank 0; None on rank 1) equal the one-process
    hook's within 1e-6 at f32.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from test_torch_data import make_train_split
from test_torch_train_step import METRICS, _as_jax_tree, _leafwise
from test_train_step import _batch
from torch_dist_worker import _cfg, _train, detections, run_ranks
from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.data.dataset import SampleSpec as JaxSpec
from yunet_tpu.data.device_aug import DeviceAugLoader as JaxDeviceAugLoader
from yunet_tpu.data.loader import TrainLoader as JaxTrainLoader
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.train import init_train_state as jax_init
from yunet_tpu.train import make_train_step as jax_make_step
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.parallel import Mesh, shard_batch
from yunet_tpu_torch.train.loop import build_loader
from yunet_tpu_torch.utils.jax_params import jax_from_state_dict, load_flat_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")

IMG, B, STEPS, WORLD = 96, 2, 3, 2
TRAIN = {"ema_momentum": 0.9, "grad_clip": 1.0}
LOSS_RTOL, PARAM_TOL, STAT_TOL = 1e-4, (1e-3, 3e-5), (1e-4, 1e-6)
AP_TOL = 1e-6
CPU = torch.device("cpu")


def _jax_cfg(**data):
    j = jax_yunet_n()
    return dataclasses.replace(
        j, model=dataclasses.replace(j.model, composed_dp=False),
        data=dataclasses.replace(j.data, img_size=IMG, **data),
        train=dataclasses.replace(j.train, bf16=False, **TRAIN))


def _global_batches():
    return [{k: np.asarray(v) for k, v in _batch(WORLD * B, IMG,
                                                 seed=20 + i).items()}
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def batches_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp") / "batches.npz")
    np.savez(path, **{f"{k}{i}": v for i, b in enumerate(_global_batches())
                      for k, v in b.items()})
    return path


def _args(batches_file, **kw):
    return {"img": IMG, "batch": B, "steps": STEPS, "train": TRAIN,
            "batches": batches_file, **kw}


@pytest.fixture(scope="module")
def two_ranks(batches_file, tmp_path_factory):
    return [r["mesh"] for r in run_ranks(
        "step", WORLD, tmp_path_factory.mktemp("ranks"),
        _args(batches_file))]


@pytest.fixture(scope="module")
def jax_mesh_run():
    """JAX's step on a 2-device dp mesh: (TrainState, metrics per step)."""
    jcfg = _jax_cfg()
    params, state = load_flat_npz(FIXTURE, yunet_n().model)
    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=WORLD * B,
                       params=params, state=state)
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]), ("dp",))
    step = jax_make_step(jcfg, JaxYuNet(jcfg.model), tx, img_size=IMG,
                         mesh=mesh)
    metrics = []
    for b in _global_batches():
        jts, m = step(jts, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jts, metrics


def _model():
    from yunet_tpu_torch.models.detector import YuNet
    return YuNet(yunet_n().model, device="cpu")


def _assert_close_to(got, want_metrics, want_state, want_ema):
    """One rank's run against a reference run under the mesh
    tolerances."""
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        assert g["num_pos"] == w["num_pos"], f"num_pos, step {i}"
        for k in METRICS[:-1]:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"{k}, step {i}")
    p, s = jax_from_state_dict(got["state"], yunet_n().model)
    wp, ws = want_state
    _leafwise(p, wp, rtol=PARAM_TOL[0], atol=PARAM_TOL[1])
    _leafwise(s, ws, rtol=STAT_TOL[0], atol=STAT_TOL[1])
    names = [n for n, _ in _model().named_parameters()]
    ema = _as_jax_tree(_model(), zip(names, got["ema"]))
    _leafwise(ema, want_ema, rtol=PARAM_TOL[0], atol=PARAM_TOL[1])


def test_two_ranks_match_jax_dp_mesh(two_ranks, jax_mesh_run):
    jts, jm = jax_mesh_run
    assert all(m["num_pos"] > 0 for m in jm)
    for rank in two_ranks:
        assert rank["step"] == STEPS
        _assert_close_to(rank, jm, (jts.params, jts.state), jts.ema_params)


def test_ranks_hold_one_state(two_ranks):
    a, b = two_ranks
    assert a["metrics"] == b["metrics"]
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    for x, y in zip(a["ema"] + a["trace"], b["ema"] + b["trace"]):
        assert torch.equal(x, y)


def test_two_ranks_equal_one_process_ghost_bn(two_ranks):
    """2 ranks at b2 == one process at b4 with bn_group=2 (the GhostBN
    identity of tests/test_train_step.py:357-397, in the port)."""
    cfg = _cfg({"img": IMG, "batch": WORLD * B,
                "train": {**TRAIN, "bn_group": B}})
    ghost = _train(cfg, None, _global_batches(), 1)
    p, s = jax_from_state_dict(ghost["state"], yunet_n().model)
    names = [n for n, _ in _model().named_parameters()]
    ema = _as_jax_tree(_model(), zip(names, ghost["ema"]))
    for rank in two_ranks:
        _assert_close_to(rank, ghost["metrics"], (p, s), ema)


def test_first_step_takes_rank_zeros_state(two_ranks, batches_file,
                                           tmp_path):
    """Rank 1 starting from other parameters and BN statistics (as with
    --diff-seed's init) trains exactly as if it had started from rank
    0's: the step's first call broadcasts rank 0's state."""
    perturbed = [r["mesh"] for r in run_ranks(
        "step", WORLD, tmp_path, _args(batches_file, perturb=True))]
    for got, want in zip(perturbed, two_ranks):
        assert got["metrics"] == want["metrics"]
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), k


def test_world_of_one_equals_no_mesh(batches_file, tmp_path):
    (one,) = run_ranks("step", 1, tmp_path, _args(batches_file, plain=True))
    mesh, plain = one["mesh"], one["plain"]
    assert mesh["metrics"] == plain["metrics"]
    for k, v in mesh["state"].items():
        assert torch.equal(v, plain["state"][k]), k
    for x, y in zip(mesh["ema"] + mesh["trace"],
                    plain["ema"] + plain["trace"]):
        assert torch.equal(x, y)


def test_shard_batch_takes_the_ranks_rows():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    got = shard_batch(batch, Mesh(2, 3, CPU))
    np.testing.assert_array_equal(got["a"], [[8, 9], [10, 11]])
    assert got["b"].tolist() == [4, 5]
    assert shard_batch(batch, None) is batch
    with pytest.raises(ValueError, match="split"):
        shard_batch({"a": np.zeros(5)}, Mesh(0, 2, CPU))


def test_a_mesh_needs_its_process_group():
    from yunet_tpu_torch.parallel import make_mesh
    assert make_mesh("cpu") is None
    with pytest.raises(ValueError, match="process group"):
        make_mesh("cpu", always=True)
    with pytest.raises(ValueError, match="process group"):
        Mesh(0, 2, CPU).check()


# -- loaders ------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """An 8-image make_synth_wider --tier hard train split and its cache."""
    return make_train_split(str(tmp_path_factory.mktemp("dp_split")))


def _loader_cfg(split, batch, **data):
    ann, prefix, cache = split
    return _cfg({"img": IMG, "batch": batch, "max_gts": 16, "data": dict(
        train_ann=ann, train_img_prefix=prefix, decoded_cache=cache,
        workers=0, **data)})


def _take(loader, n):
    try:
        it = iter(loader)
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def test_rank_train_loaders_equal_jax_and_one_process_rows(split):
    ann, prefix, _ = split
    one = _take(build_loader(_loader_cfg(split, WORLD * B)), 3)
    for r in range(WORLD):
        loader = build_loader(_loader_cfg(split, B), mesh=Mesh(r, WORLD, CPU))
        assert (loader.process_index, loader.process_count) == (r, WORLD)
        assert loader.steps_per_epoch == 2
        got = _take(loader, 3)
        want = _take(JaxTrainLoader(
            ann, prefix, batch_size=B, spec=JaxSpec(img_size=IMG,
                                                    max_gts=16),
            num_workers=0, process_index=r, process_count=WORLD), 3)
        for i, (g, w, o) in enumerate(zip(got, want, one)):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} {i}")
                np.testing.assert_array_equal(g[k], o[k][r * B:(r + 1) * B],
                                              err_msg=f"{k} {i}")


def test_rank_device_aug_loaders_equal_jax(split):
    ann, prefix, _ = split
    cfg = _loader_cfg(split, B, device_aug=True, bank_sharded=True,
                      bank_size=IMG, bank_canvas=192)
    for r in range(WORLD):
        loader = build_loader(cfg, mesh=Mesh(r, WORLD, CPU))
        jloader = JaxDeviceAugLoader(
            ann, prefix, batch_size=B, spec=JaxSpec(img_size=IMG,
                                                    max_gts=16),
            process_index=r, process_count=WORLD, bank_size=IMG,
            bank_canvas=192, device_shards=1)
        assert len(loader.bank) == len(jloader.bank) == 4
        assert loader.device_shards == 1
        np.testing.assert_array_equal(loader.bank.images,
                                      jloader.bank.images)
        for i, (g, w) in enumerate(zip(_take(loader, 3),
                                       _take(jloader, 3))):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} {i}")
    replicated = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, bank_sharded=False))
    with pytest.raises(ValueError, match="bank_sharded"):
        build_loader(replicated, mesh=Mesh(0, WORLD, CPU))


def _pad_gts(arrays):
    """Concatenate the ranks' GT arrays, padded to the widest wire width
    (the step re-pads every rank to max_gts the same way)."""
    width = max(a.shape[1] for a in arrays)
    return np.concatenate([np.pad(a, [(0, 0), (0, width - a.shape[1])]
                                  + [(0, 0)] * (a.ndim - 2))
                           for a in arrays])


def test_two_rank_device_aug_step_matches_jax_mesh(split, tmp_path):
    ann, prefix, cache = split
    data = dict(train_ann=ann, train_img_prefix=prefix, decoded_cache=cache,
                workers=0, device_aug=True, bank_sharded=True,
                bank_size=IMG, bank_canvas=192)
    ranks = run_ranks("device_aug_step", WORLD, tmp_path, {
        "img": IMG, "batch": B, "steps": 2, "data": data, "train": TRAIN})
    jcfg = _jax_cfg(max_gts=128, **{k: v for k, v in data.items()
                                    if k not in ("decoded_cache",
                                                 "workers")})
    params, state = load_flat_npz(FIXTURE, yunet_n().model)
    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=WORLD * B,
                       params=params, state=state)
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]), ("dp",))
    step = jax_make_step(jcfg, JaxYuNet(jcfg.model), tx, img_size=IMG,
                         mesh=mesh)
    bank = jnp.asarray(np.concatenate([r["bank"] for r in ranks]))
    recs = [r["records"] for r in ranks]
    assert len(recs[0]) == len(recs[1]) == 4 and not set(recs[0]) & set(
        recs[1])
    for i in range(2):
        shards = [r["batches"][i] for r in ranks]
        batch = {k: jnp.asarray(np.concatenate([s[k] for s in shards]))
                 for k in ("aug_idx", "aug_y0", "aug_x0", "aug_side",
                           "aug_flip")}
        batch.update({k: jnp.asarray(_pad_gts([s[k] for s in shards]))
                      for k in ("gt_bboxes", "gt_labels", "gt_kps",
                                "gt_valid")})
        jts, jm = step(jts, {**batch, "bank": bank})
        for r in ranks:
            g = r["metrics"][i]
            assert g["num_pos"] == float(jm["num_pos"]) > 0
            for k in METRICS[:-1]:
                np.testing.assert_allclose(g[k], float(jm[k]),
                                           rtol=LOSS_RTOL,
                                           err_msg=f"{k}, step {i}")
    for r in ranks:
        p, _ = jax_from_state_dict(r["state"], yunet_n().model)
        _leafwise(p, jts.params, rtol=PARAM_TOL[0], atol=PARAM_TOL[1])


# -- the eval hook ------------------------------------------------------------

@pytest.mark.parametrize("world,n", [(2, 7), (3, 7)])
def test_gather_restores_the_record_order(world, n, tmp_path):
    got = run_ranks("gather", world, tmp_path, {"n": n, "seed": 4})
    want = detections(n, 4)
    assert all(g is None for g in got[1:])
    assert len(got[0]) == n and any(len(w) == 0 for w in want)
    for g, w in zip(got[0], want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.fixture(scope="module")
def val(tmp_path_factory):
    """Five hard-tier val images: labelv2.txt, GT mats, decoded cache."""
    import make_synth_wider as gen
    from yunet_tpu_torch.data.cache import build_decoded_cache
    root = tmp_path_factory.mktemp("dp_val")
    split = str(root / "val")
    per_event = gen.generate_split(split, 5, 12, tier=gen.TIERS["hard"])
    gen.write_gt_mats(os.path.join(split, "gt"), per_event)
    ann = os.path.join(split, "labelv2.txt")
    assert build_decoded_cache(ann, os.path.join(split, "images"),
                               str(root / "cache"), verbose=False) == 5
    return {"ann": ann, "gt": os.path.join(split, "gt"),
            "cache": str(root / "cache")}


@pytest.mark.parametrize("also_raw", [False, True])
def test_two_rank_hook_equals_one_process_hook(val, also_raw, tmp_path):
    """Mode 0, f32, r04; with also_raw an EMA shadow (equal to r04 at
    step 0) is swept and the raw parameters too, as raw_*."""
    from yunet_tpu_torch.eval.eval_hook import make_wider_eval_hook
    from torch_dist_worker import _r04_state
    ema = 0.5 if also_raw else 0.0
    args = {"mode": 0, "ema": ema, "also_raw": also_raw, **val}
    got = run_ranks("hook", WORLD, tmp_path, args)
    assert got[1] is None
    cfg = _cfg({"img": 640, "batch": 1, "train": {"ema_momentum": ema}})
    ts, _ = _r04_state(cfg, 1)
    want = make_wider_eval_hook(
        cfg, device="cpu", mode=(640, 640), ann=val["ann"],
        gt_dir=val["gt"], cache_dir=val["cache"], img_prefix=val["cache"],
        dtype=torch.float32, also_raw=also_raw)(ts, 1)
    keys = ["easy", "hard", "medium"]
    assert sorted(got[0]) == sorted(want) == sorted(
        keys + [f"raw_{k}" for k in keys] if also_raw else keys)
    for k in want:
        np.testing.assert_allclose(got[0][k], want[k], rtol=0, atol=AP_TOL,
                                   err_msg=k)
    assert all(0 < v <= 1 for v in want.values())
