"""The frozen yunet_n weight file equals what the port reads from the
r04 fixture."""

import os

import numpy as np

from portbench.reference.model import param_shapes
from portbench import harness

ROOT = harness.ROOT


def test_weight_file_equals_the_ports_read_of_the_fixture():
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    sd = state_dict_from_jax(*load_flat_npz(
        os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz"),
        yunet_n().model))
    cfg = harness.Bench().config("yunet_n")
    with np.load(os.path.join(ROOT, cfg["weights"])) as blob:
        assert sorted(blob.files) == sorted(
            k for k in sd if not k.endswith("num_batches_tracked"))
        for k in blob.files:
            assert blob[k].dtype == np.float32
            np.testing.assert_array_equal(blob[k], sd[k].numpy(), err_msg=k)
    assert sorted(n for n, _ in param_shapes(cfg["model"])) == \
        sorted(blob.files)
