"""yunet_tpu_torch model forward == yunet_tpu YuNet.forward_flat
(train=False), f32 on the CPU. Tolerance rtol 1e-4 / atol 1e-4: the same
f32 convolutions summed in a different order."""

import os

import jax
import numpy as np
import pytest
import torch

from yunet_tpu import config as jcfg
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu_torch import config as tcfg
from yunet_tpu_torch.models.detector import YuNet
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")


def _params(name, source):
    cfg = getattr(jcfg, name)()
    if source == "r04":
        return load_flat_npz(FIXTURE, getattr(tcfg, name)().model)
    return jax.tree.map(np.asarray,
                        JaxYuNet(cfg.model).init(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("name,source", [("yunet_n", "random"),
                                         ("yunet_s", "random"),
                                         ("yunet_n", "r04")])
def test_forward_flat_matches_jax(name, source):
    params, state = _params(name, source)
    jmodel = JaxYuNet(getattr(jcfg, name)().model)
    x = np.random.RandomState(2).uniform(
        0, 255, (2, 64, 96, 3)).astype(np.float32)
    want = jax.jit(lambda p, s, x: jmodel.forward_flat(
        p, s, x, train=False)[0])(params, state, x)

    model = YuNet(getattr(tcfg, name)().model, device=torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(params, state))
    with torch.no_grad():
        got = model.forward_flat(torch.from_numpy(x).permute(0, 3, 1, 2))
        feats = model.feature_test(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape == \
            (2, 8 * 12 + 4 * 6 + 2 * 3, want[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # feature_test: per-level maps in the reference export order
    sizes = [8 * 12, 4 * 6, 2 * 3]
    for i, k in enumerate(("cls", "obj", "bbox", "kps")):
        split = torch.split(got[k], sizes, dim=1)
        for lvl in range(3):
            assert torch.equal(feats[3 * i + lvl], split[lvl])
