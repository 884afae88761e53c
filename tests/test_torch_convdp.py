"""yunet_tpu_torch fused ConvDPUnit (plain version, on the CPU) ==
yunet_tpu fused_conv_dp (Pallas, interpret mode), and the BN-folded fused
forward == JAX's fused forward and the unfolded model."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu import config as jcfg
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.models.fused import fold_inference_params as jax_fold
from yunet_tpu.models.fused import fused_forward as jax_fused_forward
from yunet_tpu.ops.convdp_pallas import fused_conv_dp as jax_fused_conv_dp
from yunet_tpu_torch import config as tcfg
from yunet_tpu_torch.models.detector import YuNet
from yunet_tpu_torch.models.fused import (fold_inference_params,
                                          fused_forward)
from yunet_tpu_torch.ops.convdp import fused_conv_dp, fused_conv_dp_plain
from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")


def _unit_params(ci, co, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 1, ci, co).astype(np.float32) * 0.2,
            rng.randn(co).astype(np.float32) * 0.2,
            rng.randn(3, 3, 1, co).astype(np.float32) * 0.2,
            rng.randn(co).astype(np.float32) * 0.2)


# the shapes of tests/test_fused_kernels.py:27-29 (ragged 37x45, Cin=3)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,rb", [((2, 37, 45, 16, 64), 16),
                                      ((1, 20, 20, 64, 64), 40),
                                      ((1, 33, 64, 3, 16), 8)])
def test_fused_conv_dp_matches_jax(shape, rb, relu):
    n, h, w, ci, co = shape
    x = np.random.RandomState(0).randn(n, h, w, ci).astype(np.float32)
    args = _unit_params(ci, co, 1)
    want = np.asarray(jax_fused_conv_dp(
        jnp.asarray(x), *(jnp.asarray(a) for a in args), relu=relu,
        row_block=rb))
    got = fused_conv_dp(torch.from_numpy(x),
                        *(torch.from_numpy(a) for a in args), relu=relu)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_conv_dp_weight_layouts_and_bf16():
    """(Cin, Cout)/(9, Cout) weights give the same result as the JAX
    (1,1,Cin,Cout)/(3,3,1,Cout) ones; a bf16 input returns bf16 rounded
    once from the f32 result."""
    w1, b1, wd, bd = (torch.from_numpy(a) for a in _unit_params(16, 8, 2))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        1, 9, 11, 16).astype(np.float32))
    a = fused_conv_dp(x, w1, b1, wd, bd)
    b = fused_conv_dp(x, w1.reshape(16, 8), b1, wd.reshape(9, 8), bd)
    assert torch.equal(a, b)
    xb = x.to(torch.bfloat16)
    got = fused_conv_dp(xb, w1, b1, wd, bd)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fused_conv_dp_plain(xb.float(), w1, b1, wd,
                                                bd).to(torch.bfloat16))


def test_fused_conv_dp_no_silent_fallback():
    """A tensor on a device with no kernel raises instead of running the
    plain version."""
    w1, b1, wd, bd = (torch.from_numpy(a) for a in _unit_params(4, 4, 0))
    with pytest.raises(ValueError):
        fused_conv_dp(torch.zeros(1, 4, 4, 4, device="meta"), w1, b1, wd,
                      bd)


@pytest.fixture(scope="module")
def r04():
    params, state = load_flat_npz(FIXTURE, tcfg.yunet_n().model)
    model = YuNet(tcfg.yunet_n().model, device=torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(params, state))
    return params, state, model


def test_fold_inference_params_matches_jax(r04):
    """BN folding is bit-equal to the JAX fold (same f32 formula)."""
    params, state, model = r04
    want = jax_fold(params, state, jcfg.yunet_n().model)
    got = fold_inference_params(model, tcfg.yunet_n().model)
    np.testing.assert_array_equal(
        got["backbone"]["stem_conv"]["w"].permute(2, 3, 1, 0).numpy(),
        np.asarray(want["backbone"]["stem_conv"]["w"]))
    units = [(got["backbone"][k], want["backbone"][k])
             for k in want["backbone"] if k != "stem_conv"]
    units += [(got["neck"][k], want["neck"][k]) for k in want["neck"]]
    for lvl in want["head"]:
        g, w = got["head"][lvl], want["head"][lvl]
        units += list(zip(g["share"], w["share"]))
        units += [(g[k], w[k]) for k in ("cls", "bbox", "obj", "kps")]
    assert len(units) == 1 + 10 + 3 + 3 + 12
    for g, w in units:
        np.testing.assert_array_equal(
            g.w1.numpy(), np.asarray(w["w1"]).reshape(g.w1.shape))
        np.testing.assert_array_equal(
            g.wd.numpy(), np.asarray(w["wd"]).reshape(g.wd.shape))
        np.testing.assert_array_equal(g.b1.numpy(), np.asarray(w["b1"]))
        np.testing.assert_array_equal(g.bd.numpy(), np.asarray(w["bd"]))
        assert g.relu == w["relu"]


def test_fused_forward_matches_jax_and_unfolded(r04):
    params, state, model = r04
    cfg = jcfg.yunet_n().model
    x = np.random.RandomState(5).randint(
        0, 256, (1, 64, 96, 3)).astype(np.float32)
    want = jax_fused_forward(jax_fold(params, state, cfg), jnp.asarray(x),
                             cfg, use_pallas=True)
    ref, _ = JaxYuNet(cfg).forward(params, state, jnp.asarray(x),
                                   train=False)
    folded = fold_inference_params(model, tcfg.yunet_n().model)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        unfolded = model(xt)
        for use_kernel in (True, False):
            got = fused_forward(folded, xt, tcfg.yunet_n().model,
                                use_kernel=use_kernel)
            for k in ("cls", "bbox", "obj", "kps"):
                for lvl in range(3):
                    g = got[k][lvl].permute(0, 2, 3, 1).numpy()
                    msg = f"{k}{lvl} use_kernel={use_kernel}"
                    np.testing.assert_allclose(
                        g, np.asarray(want[k][lvl]), rtol=1e-4, atol=1e-4,
                        err_msg=msg)
                    np.testing.assert_allclose(
                        g, np.asarray(ref[k][lvl]), rtol=1e-4, atol=1e-4,
                        err_msg=msg)
                    np.testing.assert_allclose(
                        got[k][lvl].numpy(), unfolded[k][lvl].numpy(),
                        rtol=1e-4, atol=1e-4, err_msg=msg)
