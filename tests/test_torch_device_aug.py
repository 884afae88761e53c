"""The port's card-staged dataset and on-card augmentation
(yunet_tpu_torch/data/device_aug.py, ops/resize.py:resize_area) against
yunet_tpu's, on the CPU, on make_synth_wider splits:

  * resize_area is byte-equal to cv2.resize(..., INTER_AREA) on uint8:
    down, up, exactly 2x, 3x and 4x, mixed, and 1-pixel shapes;
  * the port's ImageBank, from the decoded .npy cache or from the JPEGs,
    equals JAX's (images, dims, ratios);
  * sample_crop_geometry, make_aug_sample and DeviceAugLoader batches
    equal JAX's for one seed, with start_step, a step past 4294 and
    device_shards=2 indices;
  * device_resample against JAX's on the cases of tests/test_device_aug.py
    (out-of-canvas crops, flips), dense and tiled: f32 within RESAMPLE_ATOL
    (ulps of 255: a product's rounding and the GEMM's fused multiply-adds),
    bf16 equal after a cast to f32, and dense equal to tiled in bf16;
  * the capacity guard's cases; the training CLI with data.device_aug;
  * one train step with a bank against JAX's (f32, 96^2), and fit with
    data.device_aug against JAX's fit (losses within LOSS_RTOL, the step
    log), then kill-and-resume bit-exact within the port.

The fits start from the r04 weights, not from a random init: JAX's jitted
resample, which its train step runs, is further from its own op-by-op
one than the port is (test_device_resample_on_a_loader_batch_equals_jax
prints both gaps), and the first steps from a random init, which swing
the losses by 3x, amplify that gap past LOSS_RTOL within a few steps.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import make_train_split
from test_torch_loop import (LOSS_RTOL, METRICS, _Collect, _masked,
                             metrics_rows, tiny_cfg)
from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.data import device_aug as jda
from yunet_tpu.data.dataset import SampleSpec as JaxSpec
from yunet_tpu.data.labelv2 import parse_labelv2 as jax_parse
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.train import init_train_state as jax_init
from yunet_tpu.train import make_train_step as jax_make_step
from yunet_tpu.train.loop import fit as jax_fit
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.data import device_aug as tda
from yunet_tpu_torch.data.dataset import SampleSpec
from yunet_tpu_torch.data.labelv2 import parse_labelv2
from yunet_tpu_torch.ops.resize import resize_area
from yunet_tpu_torch.train import init_train_state, make_train_step
from yunet_tpu_torch.train.checkpoint import read_state
from yunet_tpu_torch.train.loop import fit
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")

# f32 device_resample against JAX's: values reach 255, whose ulp is 1.5e-5
RESAMPLE_ATOL = 1e-4
IMG, BANK, CANVAS = 96, 96, 192

AREA_CASES = [
    # (source (h, w), destination (w, h)), what the case covers
    ((700, 1024), (936, 640)),      # WIDER-like bank images, down
    ((1365, 1024), (640, 853)),
    ((3000, 1024), (393, 1152)),    # long side capped by the canvas
    ((1024, 768), (640, 480)),
    ((400, 1024), (1638, 640)),     # short side under 640: up
    ((639, 1024), (1026, 640)),     # up by a hair
    ((500, 700), (896, 640)),
    ((300, 200), (100, 150)),       # exactly 2x
    ((90, 90), (30, 30)),           # exactly 3x
    ((120, 160), (30, 40)),         # exactly 4x
    ((100, 100), (25, 50)),         # 4x by 2x
    ((301, 200), (100, 150)),       # 2x on one axis, not the other
    ((100, 150), (200, 50)),        # mixed: x up, y down
    ((100, 150), (60, 300)),        # mixed: x down, y up
    ((1, 9), (4, 1)),               # 1-pixel high
    ((70, 1), (1, 30)),             # 1-pixel wide
    ((20, 20), (1, 1)),             # a 1-pixel destination
    ((1, 1), (5, 5)),               # a single pixel up
    ((37, 53), (37, 53)),           # the identity
]


@pytest.mark.parametrize("channels", [3, None])
@pytest.mark.parametrize("src,dsize", AREA_CASES)
def test_resize_area_equals_cv2(src, dsize, channels):
    shape = src if channels is None else (*src, channels)
    img = np.random.RandomState(sum(src) + sum(dsize)).randint(
        0, 256, shape).astype(np.uint8)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
    got = resize_area(torch.from_numpy(img), dsize)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_resize_area_random_shapes_equal_cv2(seed):
    """Seeded shapes from 1 to 400 pixels a side, every route among them,
    in one and three channels."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(6):
        sh, sw, dh, dw = (int(v) for v in rng.randint(1, 400, 4))
        for shape in ((sh, sw), (sh, sw, 3)):
            img = rng.randint(0, 256, shape).astype(np.uint8)
            want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
            got = resize_area(torch.from_numpy(img), (dw, dh)).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{shape} -> {dh, dw}")


def test_resize_area_rejects_bad_input():
    with pytest.raises(TypeError):
        resize_area(torch.zeros((4, 4, 3)), (2, 2))
    with pytest.raises(ValueError):
        resize_area(torch.zeros((4, 4, 3), dtype=torch.uint8), (0, 2))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """An 8-image make_synth_wider --tier hard train split and its cache:
    (labelv2 path, image prefix, cache dir)."""
    return make_train_split(str(tmp_path_factory.mktemp("devaug_split")))


def _banks(split, decoded_cache):
    ann, prefix, cache = split
    want = jda.ImageBank(jax_parse(ann), prefix, bank_size=BANK,
                         canvas=CANVAS)
    got = tda.ImageBank(parse_labelv2(ann), prefix, bank_size=BANK,
                        canvas=CANVAS,
                        decoded_cache=cache if decoded_cache else None)
    return got, want


@pytest.mark.parametrize("decoded_cache", [True, False])
def test_image_bank_equals_jax(split, decoded_cache):
    got, want = _banks(split, decoded_cache)
    assert len(got) == len(want) == 8
    for k in ("images", "dims", "ratios"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_image_bank_at_full_size_equals_jax(split):
    """yunet_n's bank (short side 640 on a 1152 canvas), where the split's
    images are scaled up and down."""
    ann, prefix, cache = split
    got = tda.ImageBank(parse_labelv2(ann), prefix, decoded_cache=cache)
    want = jda.ImageBank(jax_parse(ann), prefix)
    for k in ("images", "dims", "ratios"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert (got.ratios > 1).any() and (got.ratios < 1).any()


def test_crop_geometry_equals_jax():
    rng = np.random.RandomState(0)
    for seed in range(40):
        h, w = (int(v) for v in rng.randint(60, 700, 2))
        n = int(rng.randint(1, 6))
        xy = rng.uniform(0, [w - 10, h - 10], (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 80, (n, 2))],
                               1).astype(np.float32)
        choice = [(0.5, 0.7, 0.9, 1.1, 1.3, 1.5), (0.3, 0.45, 0.6, 0.8, 1.0),
                  (0.5,)][seed % 3]
        rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        pt, mt = tda.sample_crop_geometry(h, w, boxes, choice, rt)
        pj, mj = jda.sample_crop_geometry(h, w, boxes, choice, rj)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(mt, mj)
        assert rt.randint(2 ** 31) == rj.randint(2 ** 31)


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("flip_ratio", [0.0, 0.5, 1.0])
def test_make_aug_sample_equals_jax(split, flip_ratio):
    got, want = _banks(split, True)
    spec = SampleSpec(img_size=IMG, max_gts=8, flip_ratio=flip_ratio)
    jspec = JaxSpec(img_size=IMG, max_gts=8, flip_ratio=flip_ratio)
    for i in range(len(got)):
        for wire in (None, 8):
            _assert_samples_equal(
                tda.make_aug_sample(got, i, np.random.RandomState(7 + i),
                                    spec, wire_gts=wire),
                jda.make_aug_sample(want, i, np.random.RandomState(7 + i),
                                    jspec, wire_gts=wire))


def _loaders(split, max_gts=16, **kw):
    ann, prefix, cache = split
    spec = dict(img_size=IMG, max_gts=max_gts)
    common = dict(batch_size=4, seed=11, bank_size=BANK, bank_canvas=CANVAS,
                  **kw)
    return (tda.DeviceAugLoader(ann, prefix, spec=SampleSpec(**spec),
                                decoded_cache=cache, **common),
            jda.DeviceAugLoader(ann, prefix, spec=JaxSpec(**spec), **common))


def _first(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


@pytest.mark.parametrize("kw", [
    {}, {"start_step": 3}, {"start_step": 6000}, {"device_shards": 2},
    {"process_count": 2, "process_index": 1}],
    ids=["start", "resume", "past_4294", "shards", "process"])
def test_loader_batches_equal_jax(split, kw):
    got_loader, want_loader = _loaders(split, **kw)
    assert got_loader.steps_per_epoch == want_loader.steps_per_epoch
    assert got_loader.shard_len == want_loader.shard_len
    assert got_loader.wire_gts == want_loader.wire_gts
    assert [r.filename for r in got_loader.bank.records] == \
        [r.filename for r in want_loader.bank.records]
    np.testing.assert_array_equal(got_loader.bank.images,
                                  want_loader.bank.images)
    got, want = _first(got_loader, 3), _first(want_loader, 3)
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)
    if kw.get("device_shards"):
        # slots 0-1 sample sub-shard 0 and 2-3 sub-shard 1, by local index
        assert got_loader.shard_len == 4
        assert all(b["aug_idx"].max() < 4 for b in got)


def test_loader_raises_a_producer_error(split, monkeypatch):
    """An exception in the producer thread is raised by the iterator
    (JAX's producer dies and its iterator waits forever)."""
    ann, prefix, cache = split

    def fail(*a, **kw):
        raise KeyError("no geometry")
    monkeypatch.setattr(tda, "make_aug_sample", fail)
    loader = tda.DeviceAugLoader(ann, prefix, batch_size=4,
                                 spec=SampleSpec(img_size=IMG, max_gts=16),
                                 bank_size=BANK, bank_canvas=CANVAS,
                                 decoded_cache=cache)
    try:
        with pytest.raises(KeyError, match="no geometry"):
            next(iter(loader))
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def _resample_cases():
    """tests/test_device_aug.py:test_resample_matches_host_pipeline's
    bank and geometry (crops past the image's top-left edge, flips) and
    crops past the canvas on every side."""
    rng = np.random.RandomState(0)
    H = W = 160
    canvas, n = 288, 4
    bank = np.full((n, canvas, canvas, 3), 128, np.uint8)
    for i in range(n):
        small = rng.randint(0, 256, (H // 8, W // 8, 3)).astype(np.uint8)
        bank[i, :H, :W] = cv2.resize(small, (W, H))
    cases = []
    for i in range(n):
        side = int(rng.choice([80, 120, 160, 200]))
        y0 = int(rng.randint(-40, H - side // 2))
        x0 = int(rng.randint(-40, W - side // 2))
        cases.append((i, y0, x0, side, bool(rng.rand() < 0.5)))
    cases += [(1, 230, 250, 200, True), (2, -150, 100, 200, False),
              (3, 120.5, -60.25, 96.75, True), (0, 0, 0, 288, False)]
    cols = list(zip(*cases))
    geo = (np.asarray(cols[0], np.int32), np.asarray(cols[1], np.float32),
           np.asarray(cols[2], np.float32), np.asarray(cols[3], np.float32),
           np.asarray(cols[4], bool))
    return bank, geo


@pytest.mark.parametrize("route", ["dense", "tiled"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_device_resample_equals_jax(route, dtype):
    bank, geo = _resample_cases()
    # max side 288 / out 96 -> bound 3.0; a tile of 32 reads a strip of
    # 104 rows < 288, so the tiling is real
    kw = dict(out_size=96)
    if route == "tiled":
        kw.update(max_scale=3.0, tile=32)
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jda.device_resample(
        jnp.asarray(bank), *map(jnp.asarray, geo), dtype=jdt,
        **kw).astype(jnp.float32))
    got = tda.device_resample(torch.from_numpy(bank),
                              *map(torch.from_numpy, geo), dtype=tdt, **kw)
    assert got.dtype == (tdt or torch.float32) and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)
    # the crops past the canvas blend to gray; the full canvas keeps it
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 255


def test_device_resample_on_a_loader_batch_equals_jax(split, capsys):
    """The step's route (f32, tiled) on a DeviceAugLoader batch: within
    RESAMPLE_ATOL of JAX's op-by-op device_resample. JAX's jitted one,
    which its train step runs, is printed beside it: XLA's fusion moves
    it further from the op-by-op result than the port is."""
    import functools
    import jax
    got_loader, want_loader = _loaders(split)
    batch = _first(got_loader, 1)[0]
    want_loader.close()
    bank = got_loader.bank.images
    geo = [batch[k] for k in tda.AUG_KEYS]
    kw = dict(out_size=IMG, max_scale=1.5 * BANK / IMG)
    eager = np.asarray(jda.device_resample(
        jnp.asarray(bank), *map(jnp.asarray, geo), dtype=jnp.float32, **kw))
    jit = np.asarray(jax.jit(functools.partial(
        jda.device_resample, dtype=jnp.float32, **kw))(
            jnp.asarray(bank), *map(jnp.asarray, geo)))
    got = tda.device_resample(torch.from_numpy(bank),
                              *map(torch.from_numpy, geo),
                              dtype=torch.float32, **kw).numpy()
    port_gap = float(np.abs(got - eager).max())
    with capsys.disabled():
        print(f"\nresample on a loader batch, max |x - JAX op-by-op|: port "
              f"{port_gap}, JAX jitted {float(np.abs(jit - eager).max())}")
    assert port_gap <= RESAMPLE_ATOL


def test_device_resample_dense_equals_tiled_in_bf16():
    bank, geo = _resample_cases()
    args = (torch.from_numpy(bank), *map(torch.from_numpy, geo))
    dense = tda.device_resample(*args, out_size=96, dtype=torch.bfloat16)
    tiled = tda.device_resample(*args, out_size=96, dtype=torch.bfloat16,
                                max_scale=3.0, tile=32)
    assert torch.equal(dense, tiled)
    # and the default tile (96 rows: strip 296 > 288 rows, so dense)
    auto = tda.device_resample(*args, out_size=96, dtype=torch.bfloat16,
                               max_scale=3.0)
    assert torch.equal(dense, auto)


def test_device_resample_out_of_canvas_is_gray():
    got = tda.device_resample(
        torch.zeros((1, 64, 64, 3), dtype=torch.uint8), torch.tensor([0]),
        torch.tensor([-200.0]), torch.tensor([-200.0]), torch.tensor([64.0]),
        torch.tensor([False]), out_size=32)
    np.testing.assert_allclose(got.numpy(), 128.0, atol=1e-3)


def _bank_stub():
    bank = tda.ImageBank.__new__(tda.ImageBank)
    bank.images = np.zeros((8, 64, 64, 3), np.uint8)    # 96 KiB
    bank.canvas = 64
    return bank


def test_bank_capacity_guard():
    """tests/test_device_aug.py:test_bank_capacity_guard's budgets: over
    budget raises with the arithmetic and the alternatives, JAX's too;
    no accounting (the CPU) and a comfortable budget pass."""
    bank = _bank_stub()
    jbank = jda.ImageBank.__new__(jda.ImageBank)
    jbank.images, jbank.canvas = bank.images, bank.canvas
    nbytes = bank.images.nbytes
    tight = {"bytes_limit": nbytes, "bytes_in_use": nbytes // 2}
    with pytest.raises(RuntimeError) as ei:
        bank._check_capacity("cuda", _stats=tight)
    msg = str(ei.value)
    assert "bank_sharded" in msg and "GB" in msg and "device_aug=false" in msg
    with pytest.raises(RuntimeError):
        jbank._check_capacity(None, _stats=tight)
    bank._check_capacity("cuda", _stats={})
    bank._check_capacity("cpu")
    bank._check_capacity("cuda", _stats={"bytes_limit": nbytes * 100,
                                         "bytes_in_use": 0})
    # on the CPU the staged bank is the host array, uncopied
    staged = bank.to_device("cpu")
    assert staged.data_ptr() == bank.images.ctypes.data


def _step_cfgs():
    """(JAX config, port config) for a 96^2 f32 bank step, yunet_n's
    ConvDPUnit factored in both."""
    data = dict(img_size=IMG, max_gts=128, device_aug=True, bank_size=BANK,
                bank_canvas=CANVAS)
    j, t = jax_yunet_n(), yunet_n()
    j = dataclasses.replace(
        j, data=dataclasses.replace(j.data, **data),
        model=dataclasses.replace(j.model, composed_dp=False),
        train=dataclasses.replace(j.train, bf16=False))
    t = dataclasses.replace(t, data=dataclasses.replace(t.data, **data),
                            train=dataclasses.replace(t.train, bf16=False))
    return j, t


def test_step_with_bank_matches_jax(split):
    """One step with a bank, from the r04 weights, on a DeviceAugLoader
    batch whose wire GTs (96) are fewer than max_gts (128): the step resamples
    (tiled, as max_scale gives it) and re-pads."""
    jcfg, tcfg = _step_cfgs()
    got_loader, want_loader = _loaders(split, max_gts=128)
    batch = _first(got_loader, 1)[0]
    want_loader.close()
    batch.pop("num_overflow")
    assert batch["gt_bboxes"].shape[1] < tcfg.data.max_gts
    params, state = load_flat_npz(FIXTURE, tcfg.model)
    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=4,
                       params=params, state=state)
    jstep = jax_make_step(jcfg, JaxYuNet(jcfg.model), tx, img_size=IMG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["bank"] = jnp.asarray(got_loader.bank.images)
    _, jm = jstep(jts, jbatch)
    ts, opt = init_train_state(tcfg, steps_per_epoch=10, total_batch=4,
                               device="cpu",
                               state_dict=state_dict_from_jax(params, state))
    step = make_train_step(tcfg, ts.model, opt, img_size=IMG)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["bank"] = got_loader.bank.to_device("cpu")
    ts, m, aux = step(ts, tbatch, return_aux=True)
    assert aux["targets"]["fg"].shape == (4, sum(
        (IMG // s) ** 2 for s in (8, 16, 32)))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert float(m["num_pos"]) > 0
    # a bank on another device than the model's is refused, not moved
    meta = dict(tbatch, bank=torch.empty((1, 8, 8, 3), dtype=torch.uint8,
                                         device="meta"))
    with pytest.raises(ValueError, match="to_device"):
        step(ts, meta)


@pytest.fixture(scope="module")
def r04_pth(tmp_path_factory):
    """The r04 EMA weights as a reference-style .pth."""
    path = str(tmp_path_factory.mktemp("r04") / "r04.pth")
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, yunet_n().model))
    torch.save({"state_dict": sd}, path)
    return path


def _aug_cfg(mod, split, **train):
    ann, prefix, cache = split
    cfg = tiny_cfg(mod, **train)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, train_ann=ann, train_img_prefix=prefix,
        decoded_cache=cache, device_aug=True, bank_size=BANK,
        bank_canvas=CANVAS, workers=0))


def test_fit_device_aug_matches_jax(split, r04_pth, tmp_path):
    """fit with data.device_aug=true from the same .pth: the per-step
    metrics agree with JAX's fit within LOSS_RTOL, and the log lines,
    the staging line among them, match JAX's."""
    from yunet_tpu.utils.logging import get_logger
    jcfg = _aug_cfg(jax_yunet_n, split)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, composed_dp=False))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_log, collect = get_logger(), _Collect()
    jax_log.addHandler(collect)
    try:
        jax_fit(jcfg, work_dir=jdir, max_steps=3, load_pth=r04_pth)
    finally:
        jax_log.removeHandler(collect)
    ts = fit(_aug_cfg(None, split), device="cpu", work_dir=tdir,
             max_steps=3, load_pth=r04_pth)
    assert ts.step == 3
    got, want = metrics_rows(tdir), metrics_rows(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"{k} at step {w['step']}")
    assert len({r["loss"] for r in got}) == 3
    with open(os.path.join(tdir, "train.log")) as f:
        lines = [line.split(" - INFO - ", 1)[1] for line in f
                 if " - INFO - " in line]
    assert _masked(lines) == _masked(collect.msgs)
    assert any(m.startswith("staged 8 images (0.00 GB) into device HBM")
               for m in lines)


def test_train_cli_runs_device_aug(split, tmp_path):
    """python -m yunet_tpu_torch.tools.train with --cfg-options
    data.device_aug=true, through main() on the CPU."""
    from yunet_tpu_torch.tools.train import main
    ann, prefix, cache = split
    work = str(tmp_path / "cli")
    ts = main(["yunet_n", "--work-dir", work, "--max-steps", "2",
               "--cfg-options", f"data.train_ann={ann}",
               f"data.train_img_prefix={prefix}",
               f"data.decoded_cache={cache}", "data.device_aug=true",
               f"data.img_size={IMG}", f"data.bank_size={BANK}",
               f"data.bank_canvas={CANVAS}", "data.samples_per_device=2",
               "train.log_interval=1", "train.bf16=false"], device="cpu")
    assert ts.step == 2
    rows = metrics_rows(work)
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    with open(os.path.join(work, "train.log")) as f:
        assert "staged 8 images" in f.read()


def test_fit_device_aug_kill_and_resume_is_bit_exact(split, r04_pth,
                                                    tmp_path):
    cfg = _aug_cfg(None, split, ema_momentum=0.01, warmup_iters=3)
    straight, broken = str(tmp_path / "straight"), str(tmp_path / "broken")
    ts = fit(cfg, device="cpu", work_dir=straight, max_steps=4,
             load_pth=r04_pth)
    fit(cfg, device="cpu", work_dir=broken, max_steps=2, load_pth=r04_pth)
    ts2 = fit(cfg, device="cpu", work_dir=broken, max_steps=4,
              load_pth=r04_pth, auto_resume=True)
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
    rows_a, rows_b = metrics_rows(straight), metrics_rows(broken)
    assert [r["step"] for r in rows_b] == [1, 2, 3, 4]
    for ra, rb in zip(rows_a[2:], rows_b[2:]):
        for k in METRICS:
            assert ra[k] == rb[k], (k, ra["step"])
