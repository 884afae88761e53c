"""The port's small CLIs on the CPU, each against the JAX package's CLI of
the same name on the same inputs:

  * tools/test.py (VOC mAP@0.5): the r04 weights (as a reference-layout
    .pth), a make_synth_wider.py --tier hard split, f32 Detectors on both
    sides: mAP within 1e-4 (JAX's own gate, tests/test_cli_widerface.py),
    the pickled detections within 1e-4 too; the port from the JPEGs
    (cv2) and from the decoded cache alike;
  * print_config: equal JSON for yunet_n and yunet_s with --cfg-options
    train.lr=0.02 (no field is only on one side);
  * subset_labelv2: equal output bytes;
  * get_image_metas: equal pickles;
  * build_decoded_cache: equal .npy files;
  * browse_dataset: the same JPEG files, byte-equal (the port's uint8
    resize equals cv2's).
"""

import functools
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tools", "misc"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Four hard-tier synthetic images (JPEGs) with labelv2.txt, the port's
    decoded cache of them, and the r04 weights as a .pth."""
    import make_synth_wider as gen
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.data.cache import build_decoded_cache
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    root = tmp_path_factory.mktemp("clis")
    val = str(root / "val")
    gen.generate_split(val, 4, 11, tier=gen.TIERS["hard"])
    ann = os.path.join(val, "labelv2.txt")
    cache = str(root / "cache")
    build_decoded_cache(ann, os.path.join(val, "images"), cache,
                        verbose=False)
    pth = str(root / "r04.pth")
    torch.save({"meta": {"epoch": 0}, "state_dict": state_dict_from_jax(
        *load_flat_npz(FIXTURE, yunet_n().model))}, pth)
    return {"root": root, "ann": ann, "images": os.path.join(val, "images"),
            "cache": cache, "pth": pth}


def _jax_tools_test():
    """tools/test.py, loaded by path: ``import test`` may find the
    standard library's test package."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_tools_test", os.path.join(ROOT, "tools", "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_test_cli_map_equals_jax(split, tmp_path, monkeypatch, capsys):
    import yunet_tpu.eval
    jax_cli = _jax_tools_test()
    from yunet_tpu_torch.tools import test as cli
    monkeypatch.setattr(yunet_tpu.eval, "Detector", functools.partial(
        yunet_tpu.eval.Detector, bf16=False))
    monkeypatch.setattr(cli, "Detector", functools.partial(
        cli.Detector, dtype=torch.float32))
    common = ["yunet_n", split["pth"], "--ann", split["ann"],
              "--mode", "(320, 320)"]
    jax_cli.main(common + ["--img-prefix", split["images"], "--out",
                           str(tmp_path / "jax.pkl")])
    want = capsys.readouterr().out.splitlines()
    maps = []
    for src in (["--img-prefix", split["images"]],
                ["--cache-dir", split["cache"]]):
        out = str(tmp_path / "port.pkl")
        maps.append(cli.main(common + src + ["--out", out], device="cpu"))
        got = capsys.readouterr().out.splitlines()
        assert got[0] == f"wrote {out}"
        assert got[-1].startswith("mAP@0.5: ")
        assert abs(float(got[-1].split()[-1])
                   - float(want[-1].split()[-1])) <= 1e-4
        with open(out, "rb") as f, open(tmp_path / "jax.pkl", "rb") as g:
            pd, jd = pickle.load(f), pickle.load(g)
        assert len(pd) == len(jd) == 4
        for a, b in zip(pd, jd):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert maps[0] == maps[1] > 0.1
    cli.main(common + ["--cache-dir", split["cache"], "--eval", "none",
                       "--limit", "2"], device="cpu")
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit, match="missing"):
        cli.main(common + ["--cache-dir", str(tmp_path)], device="cpu")


@pytest.mark.parametrize("name", ["yunet_n", "yunet_s"])
def test_print_config_equals_jax(name, capsys):
    import print_config as jax_cli
    from yunet_tpu_torch.tools import print_config as cli
    argv = [name, "--cfg-options", "train.lr=0.02"]
    jax_cli.main(argv)
    want = capsys.readouterr().out
    got = cli.main(argv)
    assert capsys.readouterr().out == want
    assert got["train"]["lr"] == 0.02

    def fields(d, prefix=""):
        return {f for k, v in d.items() for f in (
            fields(v, f"{prefix}{k}.") if isinstance(v, dict)
            else {prefix + k})}
    # every field of one config is a field of the other: none to name
    only_jax = fields(json.loads(want)) - fields(got)
    only_port = fields(got) - fields(json.loads(want))
    assert only_jax == only_port == set()


@pytest.mark.parametrize("every,offset", [(2, 0), (3, 1)])
def test_subset_labelv2_equals_jax(split, tmp_path, monkeypatch, capsys,
                                   every, offset):
    import subset_labelv2 as jax_cli
    from yunet_tpu_torch.tools import subset_labelv2 as cli
    tail = ["--every", str(every), "--offset", str(offset)]
    monkeypatch.setattr(sys, "argv", ["subset_labelv2.py", split["ann"],
                                      "--out", str(tmp_path / "j.txt")]
                        + tail)
    jax_cli.main()
    cli.main([split["ann"], "--out", str(tmp_path / "p.txt")] + tail)
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == lines[0].replace("j.txt", "p.txt")
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "p.txt").read_bytes().startswith(b"#")


@pytest.mark.parametrize("split_name", ["val", "train"])
def test_get_image_metas_equals_jax(split, tmp_path, split_name):
    import get_image_metas as jax_cli
    from yunet_tpu_torch.tools import get_image_metas as cli
    tail = ["--split", split_name, "--ann", split["ann"]]
    jax_cli.main(["yunet_n", "--out", str(tmp_path / "j.pkl")] + tail)
    metas = cli.main(["yunet_n", "--out", str(tmp_path / "p.pkl")] + tail)
    assert (tmp_path / "p.pkl").read_bytes() == \
        (tmp_path / "j.pkl").read_bytes()
    assert len(metas) == 4


def test_build_decoded_cache_equals_jax(split, tmp_path, capsys):
    import build_decoded_cache as jax_cli
    from yunet_tpu_torch.tools import build_decoded_cache as cli
    tail = ["--ann", split["ann"], "--img-prefix", split["images"],
            "--workers", "1"]
    jax_cli.main(["yunet_n", "--cache-dir", str(tmp_path / "j")] + tail)
    assert cli.main(["yunet_n", "--cache-dir", str(tmp_path / "p")]
                    + tail) == 4
    assert cli.main(["yunet_n", "--cache-dir", str(tmp_path / "p")]
                    + tail) == 0                       # idempotent
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == lines[0].replace(str(tmp_path / "j"),
                                        str(tmp_path / "p"))
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.npy"))
    assert len(files) == 4
    assert files == sorted(p.relative_to(tmp_path / "p")
                           for p in (tmp_path / "p").rglob("*.npy"))
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


def test_browse_dataset_equals_jax(split, tmp_path):
    import browse_dataset as jax_cli
    from yunet_tpu_torch.tools import browse_dataset as cli
    tail = ["-n", "5", "--seed", "3", "--ann", split["ann"],
            "--img-prefix", split["images"]]
    jax_cli.main(["yunet_n", "--output-dir", str(tmp_path / "j")] + tail)
    assert cli.main(["yunet_n", "--output-dir", str(tmp_path / "p")]
                    + tail) == 5
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 5
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


def test_new_tools_import_no_jax_no_cv2():
    """Importing the new modules pulls in neither jax, yunet_tpu nor cv2
    (cv2 is imported only inside the functions that decode or draw)."""
    mods = ", ".join(f"yunet_tpu_torch.{m}" for m in (
        "utils.profiling", "utils.trace_profile",
        "tools.verify_device_kernels", "tools.bench_train_step",
        "tools.profile_train_step", "tools.profile_serve",
        "tools.bench_input_pipeline", "tools.test",
        "tools.validate_training", "tools.print_config",
        "tools.subset_labelv2", "tools.get_image_metas",
        "tools.build_decoded_cache", "tools.browse_dataset"))
    code = ("import sys; before = set(sys.modules); "
            f"import {mods}; "
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'yunet_tpu', 'cv2')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
