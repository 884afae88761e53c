"""yunet_tpu_torch fused ConvDPUnit (plain version, on the CPU) ==
yunet_tpu fused_conv_dp (Pallas, interpret mode), and the BN-folded fused
forward == JAX's fused forward and the unfolded model.

The bf16 CUDA route's arithmetic (csrc/convdp.cu, convdp_mma_kernel:
exact products of bf16 x with w1 split into three bf16 parts, f32 sums in
its own order) is emulated here in f32 torch ops and held to the plain
version and to JAX under the check chip_smoke.py applies to the kernel on
the card (ops/convdp.py:bf16_excess). The same emulation with w1 split in
two (hi + lo) must fail that check: it shows that the check separates
K4's function from a 16-bit w1.
"""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yunet_tpu import config as jcfg
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.models.fused import fold_inference_params as jax_fold
from yunet_tpu.models.fused import fused_forward as jax_fused_forward
from yunet_tpu.ops.convdp_pallas import fused_conv_dp as jax_fused_conv_dp
from yunet_tpu_torch import config as tcfg
from yunet_tpu_torch.models.detector import YuNet
from yunet_tpu_torch.models import fused as fused_module
from yunet_tpu_torch.models.fused import (fold_inference_params,
                                          fused_forward)
from yunet_tpu_torch.ops.convdp import (BF16_EXCESS_LIMIT, bf16_excess,
                                        fused_conv_dp, fused_conv_dp_plain)
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


def _w1_parts(w1, n_parts):
    """f32 w1 as n_parts bf16 parts (as f32), hi first: each part rounds
    what the earlier ones left. Three parts sum to w1 exactly."""
    parts, rest = [], w1
    for _ in range(n_parts):
        p = rest.to(torch.bfloat16).float()
        parts.append(p)
        rest = rest - p
    return parts


def _emulate_mma(x, w1, b1, wd, bd, relu, n_parts=3):
    """The bf16 route in f32 torch ops: bf16 x times w1's parts (the hi
    product, plus the smaller parts' products summed lo first), + b1, zero
    outside the image, the 9 taps in order, + bd, ReLU, one rounding."""
    n, h, w, cin = x.shape
    w1 = w1.reshape(cin, -1).float()
    cout = w1.shape[1]
    xf = x.to(torch.bfloat16).float().reshape(-1, cin)
    hi, *rest = _w1_parts(w1, n_parts)
    small = sum(xf @ p for p in reversed(rest))
    y1 = F.pad((xf @ hi + small + b1).reshape(n, h, w, cout),
               (0, 0, 1, 1, 1, 1))
    wd = wd.reshape(9, cout).float()
    acc = torch.zeros(n, h, w, cout)
    for t in range(9):
        ty, tx = divmod(t, 3)
        acc = acc + y1[:, ty:ty + h, tx:tx + w] * wd[t]
    acc = acc + bd
    return (F.relu(acc) if relu else acc).to(torch.bfloat16)


@pytest.fixture(scope="module")
def mma_excess_320(r04):
    """For each of the 29 ConvDPUnits of a 320^2 b1 fused forward (r04
    weights, shapes recorded from fused_forward itself; x seeded
    uniform(0, 3) in bf16): the three-part and the two-part emulation's
    bf16_excess against the plain version."""
    _, _, model = r04
    folded = fold_inference_params(model, tcfg.yunet_n().model)
    calls = []

    def record(y, w1, b1, wd, bd, *, relu):
        calls.append((tuple(y.shape), w1, b1, wd, bd, relu))
        return fused_conv_dp(y, w1, b1, wd, bd, relu=relu)

    with mock.patch.object(fused_module, "fused_conv_dp", record), \
            torch.no_grad():
        fused_forward(folded, torch.zeros(1, 3, 320, 320),
                      tcfg.yunet_n().model, use_kernel=True)
    rng = np.random.RandomState(1)
    out = []
    for shape, w1, b1, wd, bd, relu in calls:
        x = torch.from_numpy(rng.uniform(0, 3, shape).astype(np.float32)
                             ).to(torch.bfloat16)
        want = fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu)
        out.append({parts: bf16_excess(
            _emulate_mma(x, w1, b1, wd, bd, relu, parts), want, x, w1, b1,
            wd) for parts in (3, 2)})
    return out


@pytest.mark.parametrize("unit", range(29))
def test_mma_emulation_within_bf16_check(mma_excess_320, unit):
    """The three-part split at each unit of a 320^2 forward: within the
    check (at most 0.29 units of 2^-24 * S here)."""
    assert len(mma_excess_320) == 29
    assert mma_excess_320[unit][3] <= BF16_EXCESS_LIMIT


def test_hi_lo_emulation_fails_bf16_check(mma_excess_320):
    """w1 as hi + lo (16 bits) misses the check at some unit (by 9.99
    units of 2^-24 * S here, against the limit's 2)."""
    assert max(e[2] for e in mma_excess_320) > BF16_EXCESS_LIMIT


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,rb", [((2, 37, 45, 16, 64), 16),
                                      ((1, 33, 64, 3, 16), 8)])
def test_mma_emulation_matches_jax(shape, rb, relu):
    """The bf16 route's arithmetic against JAX's fused_conv_dp on the same
    bf16 x (Pallas in interpret mode), at the ragged shapes."""
    n, h, w, ci, co = shape
    x = np.random.RandomState(4).uniform(0, 3, (n, h, w, ci)).astype(
        np.float32)
    args = _unit_params(ci, co, 5)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_fused_conv_dp(xb, *(jnp.asarray(a) for a in args), relu=relu,
                             row_block=rb)
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = [torch.from_numpy(a) for a in args]
    got = _emulate_mma(xt, *wt, relu)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.shape == want.shape
    assert bf16_excess(got, want, xt, *wt[:3]) <= BF16_EXCESS_LIMIT
