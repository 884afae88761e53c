"""yunet_tpu_torch/tools/validate_training.py on the CPU, against the JAX
package's tools/validate_training.py:

  * tests/fixtures/validate_training_160.npz equals both make_datasets
    (8 images at 160^2 from RandomState(0), 8 GT slots): the card host,
    which has no OpenCV, trains on the fixture;
  * the overfit run's config and batch, from the same initial parameters
    (the r04 weights through utils/jax_params.py, as the step tests
    start), f32: the first 3 steps' losses within 1e-5 relative of JAX's
    and num_pos equal (JAX with model.composed_dp=false, as the step
    tests hold it). From JAX's seeded random init (a loss near 170) the
    first step agrees as closely, the second's loss_cls by 5.7e-4, and in
    the third a SimOTA positive flips (num_pos 25 against 24), so the
    comparison starts from trained weights;
  * a 5-step run from the r04 weights returns a finite recall and
    keypoint error, and the CLI's gate fails below recall 0.9.
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest

from yunet_tpu_torch.tools import validate_training as vt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
R04 = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
METRICS = ("loss", "loss_cls", "loss_obj", "loss_bbox", "loss_kps")


def test_fixture_equals_both_make_datasets(tmp_path):
    import validate_training as jax_vt
    data = vt.load_data()
    port = vt.make_dataset(8, 160, np.random.RandomState(0), vt.MAX_GTS)
    jax_ = jax_vt.make_dataset(8, 160, np.random.RandomState(0), 8)
    for a, b, c in zip(data, port, jax_):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert data[0].shape == (8, 160, 160, 3) and data[3].sum() > 8
    vt.save_data(str(tmp_path / "d.npz"), port)
    for a, b in zip(vt.load_data(str(tmp_path / "d.npz")), port):
        np.testing.assert_array_equal(a, b)


def test_first_steps_losses_equal_jax():
    import jax.numpy as jnp
    from yunet_tpu.config import yunet_n as jax_yunet_n
    from yunet_tpu.models import YuNet as JaxYuNet
    from yunet_tpu.train import init_train_state as jax_init
    from yunet_tpu.train import make_train_step as jax_make_step
    from yunet_tpu_torch.train import init_train_state, make_train_step
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    r04 = load_flat_npz(R04, yunet_n().model)
    data = vt.load_data()
    n, img = data[0].shape[:2]
    # the JAX tool's run() config, f32, factored ConvDPUnits
    jcfg = jax_yunet_n()
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, composed_dp=False),
        data=dataclasses.replace(jcfg.data, img_size=img, max_gts=8),
        train=dataclasses.replace(jcfg.train, lr=0.005, warmup_iters=100,
                                  lr_decay_epochs=(10 ** 9,), bf16=False))
    cfg = vt.train_config(img)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             bf16=False))
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(jcfg.train)
    assert dataclasses.asdict(cfg.data) == dataclasses.asdict(jcfg.data)
    jts, jtx = jax_init(jcfg, steps_per_epoch=10 ** 6, total_batch=n,
                        params=r04[0], state=r04[1])
    jstep = jax_make_step(jcfg, JaxYuNet(jcfg.model), jtx, img_size=img)
    ts, opt = init_train_state(cfg, steps_per_epoch=10 ** 6, total_batch=n,
                               device="cpu", state_dict=state_dict_from_jax(
                                   *r04))
    step = make_train_step(cfg, ts.model, opt, img_size=img)
    batch = vt.train_batch(data, "cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for i in range(3):
        jts, jm = jstep(jts, jbatch)
        ts, m = step(ts, batch)
        for k in METRICS:
            want, got = float(jm[k]), float(m[k])
            assert got == pytest.approx(want, rel=1e-5), (i, k, got, want)
        assert float(m["num_pos"]) == float(jm["num_pos"]) > 0


def test_short_run_and_gate(capsys):
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    sd = state_dict_from_jax(*load_flat_npz(R04, yunet_n().model))
    recall, kp_err = vt.run(steps=5, data=vt.load_data(), device="cpu",
                            verbose=False, state_dict=sd)
    assert 0 < recall <= 1 and math.isfinite(kp_err) and kp_err >= 0
    # from the seeded init, 2 steps detect nothing: the CLI's gate fails
    with pytest.raises(SystemExit, match="FAIL: recall"):
        vt.main(["--steps", "2", "--data", vt.FIXTURE], device="cpu")
    assert "overfit recall@IoU0.5: 0.000" in capsys.readouterr().out
