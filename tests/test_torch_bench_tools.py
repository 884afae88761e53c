"""The port's bench and profile tools on the CPU at a small size, against
the JAX package's tools where they share a function:

  * bench_train_step.make_batch equals JAX's make_batch from one seed;
  * bench_train_step, profile_train_step (shipped and device-aug) and
    profile_serve run their main() with device="cpu" at batch 2, 96^2
    (profile_serve at its 320^2 canvas), one iteration: the JSON of
    interleaved windows, or the profile tools' stated no-device error (a
    CPU run's trace has no device lane);
  * bench_input_pipeline.make_dataset writes JAX's labelv2 text and
    JPEGs, and main() returns the three configurations' rates.
"""

import json
import os
import sys

import numpy as np
import pytest

from yunet_tpu_torch.tools import (bench_input_pipeline, bench_train_step,
                                   profile_serve, profile_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools", "misc"))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_make_batch_equals_jax(dtype):
    from bench_train_step import make_batch as jax_make_batch
    want = jax_make_batch(np.random.RandomState(3), 2, 96, 16, dtype)
    got = bench_train_step.make_batch(np.random.RandomState(3), 2, 96, 16,
                                      dtype)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert got[k].numpy().dtype == np.asarray(v).dtype, k


def test_bench_train_step_cpu(capsys):
    out = bench_train_step.main(
        ["--batch", "2", "--img-size", "96", "--iters", "1", "--windows",
         "2", "--simota", "folded,xla", "--bn-bias", "keep", "--dtype",
         "uint8"], device="cpu")
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert list(out) == [
        f"dtype=uint8,simota={s},bn_bias=keep,bn_group=0"
        for s in ("folded", "xla")]
    for v in out.values():
        assert len(v["windows"]) == 2 and v["device"] == "cpu"
        assert v["imgs_per_s_best"] >= v["imgs_per_s_median"] > 0


def test_bn_bias_keep_gives_bias_gradients():
    import torch
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.models import layers
    from yunet_tpu_torch.models.detector import YuNet
    model = YuNet(yunet_n().model, device="cpu",
                  generator=torch.Generator().manual_seed(0)).train()
    conv = model.backbone.model0.conv1
    for mode, grad in (("skip", False), ("keep", True)):
        with bench_train_step.bn_bias(mode):
            assert layers.bn_covered_bias(conv).requires_grad == grad
    assert not layers.bn_covered_bias(conv).requires_grad
    with pytest.raises(ValueError):
        with bench_train_step.bn_bias("drop"):
            pass


NO_DEVICE = "holds no device event"


@pytest.mark.parametrize("extra", [[], ["--device-aug", "--ema"]])
def test_profile_train_step_cpu(extra, tmp_path, capsys):
    out = profile_train_step.main(
        ["--batch", "2", "--img-size", "96", "--steps", "1", "--out",
         str(tmp_path)] + extra, device="cpu")
    assert out is None
    assert NO_DEVICE in capsys.readouterr().out
    assert list(tmp_path.glob("*.pt.trace.json.gz"))


def test_profile_serve_cpu(tmp_path, capsys):
    out = profile_serve.main(["--batch", "2", "--iters", "1", "--out",
                              str(tmp_path)], device="cpu")
    assert out is None
    assert NO_DEVICE in capsys.readouterr().out
    out = profile_serve.main(["--batch", "1", "--iters", "1", "--config",
                              "yunet_s", "--out", str(tmp_path)],
                             device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "yunet_s: no weights given; a seeded random init"
    assert NO_DEVICE in lines[-1]


def test_bench_input_pipeline(tmp_path):
    from bench_input_pipeline import make_dataset as jax_make_dataset
    got = bench_input_pipeline.make_dataset(str(tmp_path / "port"), 3,
                                            np.random.RandomState(0))
    want = jax_make_dataset(str(tmp_path / "jax"), 3,
                            np.random.RandomState(0))
    with open(got[0], "rb") as a, open(want[0], "rb") as b:
        assert a.read() == b.read()
    for j in range(3):
        name = os.path.join("0--Ev", f"img{j}.jpg")
        with open(os.path.join(got[1], name), "rb") as a, \
                open(os.path.join(want[1], name), "rb") as b:
            assert a.read() == b.read()
    res = bench_input_pipeline.main(["--images", "3", "--rounds", "4",
                                     "--root", str(tmp_path / "main")])
    assert list(res) == ["jpeg_full_decode", "jpeg_reduced_decode",
                         "decoded_cache_mmap"]
    assert all(v > 0 for v in res.values())
