"""yunet_tpu_torch's trainable fused ConvDPUnit (ops/convdp_train.py, plain
backward on the CPU) == yunet_tpu's fused_pw_dw (Pallas forward and
backward, interpret mode), and ConvDPUnit(fused=True) == fused=False in
training.

Tolerances, as shares of each gradient's largest magnitude:
  * f32: every gradient within 2e-6 (measured: at most 8.8e-7; sums taken
    in another order).
  * bf16: the four parameter gradients within 2e-6 (measured: at most
    4.6e-7), and dx, which both round once to bf16, within one bf16 ulp
    elementwise (sums in another order may round the other way). A variant
    that keeps the recomputed y1 in f32 instead of rounding it to bf16, as
    JAX does, misses JAX's dwd by 1.6e-3 to 3.2e-3 of its scale on these
    three shapes (checked once by hand): the bf16 tolerance is three
    orders of magnitude tighter than that gap.

The bf16 CUDA kernel's split-product arithmetic (csrc/convdp_bwd.cu) is
emulated here in f32 torch ops and held to the plain version under the
tolerances chip_smoke.py applies to the kernel on the card. The emulation
does not model the kernel's re-summing of y1 near a bf16 rounding
boundary; its y1 is rounded from CPU f32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu.ops.convdp_train_pallas import fused_pw_dw as jax_fused_pw_dw
from yunet_tpu_torch.models.detector import YuNet
from yunet_tpu_torch.models.layers import ConvDPUnit
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.ops.convdp_train import (fused_pw_dw, fused_pw_dw_bwd,
                                              fused_pw_dw_bwd_plain)

NAMES = ("dx", "dw1", "db1", "dwd", "dbd")
# the shapes of tests/test_fused_kernels.py:42-44
SHAPES = [((2, 21, 19, 8, 16), 8), ((1, 40, 40, 16, 64), 40),
          ((2, 20, 20, 3, 16), 10)]


def _unit_params(ci, co, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 1, ci, co).astype(np.float32) * 0.2,
            rng.randn(co).astype(np.float32) * 0.2,
            rng.randn(3, 3, 1, co).astype(np.float32) * 0.2,
            rng.randn(co).astype(np.float32) * 0.2)


def _grads(shape, rb, jdt, tdt):
    """(port grads, JAX grads) of sum(z * dz) for the same x, dz and
    weights; x and dz in the given dtype, weights f32."""
    n, h, w, ci, co = shape
    rng = np.random.RandomState(2)
    x = rng.randn(n, h, w, ci).astype(np.float32)
    dz = rng.randn(n, h, w, co).astype(np.float32)
    ps = _unit_params(ci, co, 3)
    dzj = jnp.asarray(dz, jdt).astype(jnp.float32)
    want = jax.grad(lambda a: (jax_fused_pw_dw(*a, rb).astype(jnp.float32)
                               * dzj).sum())(
        (jnp.asarray(x, jdt),) + tuple(jnp.asarray(p) for p in ps))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in ps]
    z = fused_pw_dw(xt, *pt)
    assert z.dtype == tdt and z.shape == (n, h, w, co)
    got = torch.autograd.grad(z, [xt] + pt, torch.from_numpy(dz).to(tdt))
    return got, [np.asarray(g.astype(jnp.float32)) for g in want]


@pytest.mark.parametrize("shape,rb", SHAPES)
def test_fused_pw_dw_grads_match_jax_f32(shape, rb):
    got, want = _grads(shape, rb, jnp.float32, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = float(np.abs(w).max()) + 1e-9
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=2e-6,
                                   rtol=0, err_msg=name)


def _bf16_ulp(a):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("shape,rb", SHAPES)
def test_fused_pw_dw_grads_match_jax_bf16(shape, rb):
    got, want = _grads(shape, rb, jnp.bfloat16, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    dx, dx_want = got[0].float().numpy(), want[0]
    assert np.all(np.abs(dx - dx_want)
                  <= _bf16_ulp(np.maximum(np.abs(dx), np.abs(dx_want))))
    for name, g, w in zip(NAMES[1:], got[1:], want[1:]):
        assert g.dtype == torch.float32, name
        scale = float(np.abs(w).max()) + 1e-9
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=2e-6,
                                   rtol=0, err_msg=name)


def test_fused_pw_dw_bwd_rounds_y1_to_x_dtype():
    """In bf16 the recompute rounds y1 (and w1) to bf16: dwd differs from
    an f32 recompute on the same bf16 values, while dw1, db1 and dbd do
    not depend on y1."""
    ci, co = 8, 16
    w1, b1, wd, _ = (torch.from_numpy(p) for p in _unit_params(ci, co, 5))
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 9, 7, ci).astype(np.float32)).to(
        torch.bfloat16)
    dz = torch.from_numpy(rng.randn(2, 9, 7, co).astype(np.float32)).to(
        torch.bfloat16)
    low = fused_pw_dw_bwd(x, w1, b1, wd, dz)
    high = fused_pw_dw_bwd_plain(x.float(), w1, b1, wd, dz.float())
    assert low[0].dtype == torch.bfloat16 and high[0].dtype == torch.float32
    assert not torch.equal(low[3], high[3])
    for i in (1, 2, 4):
        torch.testing.assert_close(low[i], high[i], rtol=1e-6, atol=1e-6)


def test_fused_unit_in_model_path():
    """ConvDPUnit(fused=True) == fused=False in train mode, outputs, BN
    running statistics and all parameter gradients (the port's twin of
    tests/test_fused_kernels.py:test_fused_unit_in_model_path)."""
    units = []
    for _ in range(2):
        u = ConvDPUnit(16, 64, with_bn=True)
        u.to_empty(device="cpu")
        u.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            u.bn.running_mean.uniform_(-0.1, 0.1,
                                       generator=torch.Generator()
                                       .manual_seed(1))
        units.append(u.train())
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 24, 24)
                         .astype(np.float32))
    ys = [u(x, 0, fused) for u, fused in zip(units, (False, True))]
    torch.testing.assert_close(ys[1], ys[0], rtol=1e-4, atol=1e-5)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(units[1].bn, name),
                                   getattr(units[0].bn, name), rtol=1e-5,
                                   atol=1e-6)
    dy = torch.from_numpy(np.random.RandomState(5).randn(*ys[0].shape)
                          .astype(np.float32))
    grads = [dict(zip([n for n, _ in u.named_parameters()],
                      torch.autograd.grad(y, list(u.parameters()), dy,
                                          allow_unused=True)))
             for u, y in zip(units, ys)]
    assert grads[1]["conv2.bias"] is None  # BN-covered: detached
    for name, g in grads[0].items():
        if g is None:
            assert grads[1][name] is None, name
            continue
        scale = float(g.abs().max())
        torch.testing.assert_close(grads[1][name] / scale, g / scale,
                                   rtol=0, atol=1e-5, msg=name)


def test_fused_trunk_stays_channels_last():
    """The fused training forward from a channels-last input gives every
    ConvDPUnit an x whose NHWC view is already contiguous: no layout copy
    at any of the 29 units of yunet_n."""
    cfg = yunet_n().model
    model = YuNet(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0)).train()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(
            args[0].permute(0, 2, 3, 1).is_contiguous()))
        for m in model.modules() if isinstance(m, ConvDPUnit)]
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 64, 64, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    flat = model.forward_flat(x, 0, True)
    for h in hooks:
        h.remove()
    assert len(seen) == 29 and all(seen), seen
    assert flat["cls"].shape == (2, 84, 1)


def test_fused_pw_dw_no_silent_fallback():
    """A tensor on a device with no kernel raises instead of running the
    plain version, and mismatched shapes raise."""
    w1, b1, wd, _ = (torch.from_numpy(p) for p in _unit_params(4, 8, 0))
    with pytest.raises(ValueError, match="no kernel"):
        fused_pw_dw_bwd(torch.zeros(1, 4, 4, 4, device="meta"), w1, b1, wd,
                        torch.zeros(1, 4, 4, 8, device="meta"))
    with pytest.raises(ValueError, match="shapes disagree"):
        fused_pw_dw_bwd(torch.zeros(1, 4, 4, 4), w1, b1, wd,
                        torch.zeros(1, 4, 4, 4))


# the tolerances chip_smoke.py holds the bf16 kernel to on the card
BWD_TOL = 1e-4


def _split(v):
    """v = hi + lo + O(2^-16 v), hi and lo bf16 values (kept in f32)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mma(pairs):
    """sum_i a_i @ b_i for bf16-valued f32 operands, as the tensor cores
    take it: exact products, f32 sums, the k-steps of 16 one after another,
    every pair of a step into one accumulator."""
    out = 0.0
    for k in range(0, pairs[0][0].shape[1], 16):
        for a, b in pairs:
            out = out + a[:, k:k + 16] @ b[k:k + 16]
    return out


def _emulated_mma_bwd(x, w1, b1, wd, dz):
    """The bf16 route of csrc/convdp_bwd.cu in f32 torch ops: y1 from bf16
    operands, rounded to bf16; dy1 and the 9-tap sums in f32; dx from the
    hi/lo halves of dy1 and w1 (lo.hi + hi.lo + hi.hi); dw1 = x.lo +
    x.hi."""
    n, h, w, cin = x.shape
    cout = w1.shape[-1]
    xf, dzf = x.float().reshape(-1, cin), dz.float()
    w1, wd = w1.reshape(cin, cout), wd.reshape(9, cout)
    y1 = (_mma([(xf, w1.to(torch.bfloat16).float())]) + b1).to(
        torch.bfloat16).float().reshape(n, h, w, cout)
    pad = (0, 0, 1, 1, 1, 1)
    y1p, dzp = torch.nn.functional.pad(y1, pad), torch.nn.functional.pad(
        dzf, pad)
    dy1 = torch.zeros_like(dzf)
    dwd = []
    for t in range(9):
        ty, tx = divmod(t, 3)
        dy1 = dy1 + wd[t] * dzp[:, 2 - ty:2 - ty + h, 2 - tx:2 - tx + w]
        dwd.append((y1p[:, ty:ty + h, tx:tx + w] * dzf).sum((0, 1, 2)))
    dy1 = dy1.reshape(-1, cout)
    hi, lo = _split(dy1)
    wh, wl = _split(w1)
    dx = _mma([(lo, wh.t()), (hi, wl.t()), (hi, wh.t())])
    dw1 = _mma([(xf.t(), lo), (xf.t(), hi)])
    return (dx.reshape(n, h, w, cin).to(torch.bfloat16), dw1, dy1.sum(0),
            torch.stack(dwd), dzf.sum((0, 1, 2)))


@pytest.mark.parametrize("shape", [(2, 16, 32, 64, 64), (2, 16, 32, 16, 64),
                                   (2, 21, 19, 16, 64), (2, 21, 19, 64, 10)])
def test_split_product_numerics_match_plain(shape):
    """The bf16 kernel's arithmetic, emulated on the CPU, against
    fused_pw_dw_bwd_plain within chip_smoke.py's tolerances: each gradient
    within BWD_TOL of its largest magnitude, dx within one bf16 ulp plus
    BWD_TOL of its largest magnitude (measured here: at most 4.0e-6 beyond
    the ulp, and 3.5e-6 for the others).

    Why dx and dw1 take dy1 (and w1) as hi/lo bf16 pairs: a single bf16
    pass, dy1 and w1 each rounded to bf16 once, misses the plain dx by
    2.0e-3 to 2.9e-3 of its largest magnitude beyond the ulp on these
    shapes, and dw1 by 1.6e-3 to 1.9e-3: over ten times the tolerance."""
    n, h, w, ci, co = shape
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.uniform(0, 3, (n, h, w, ci)).astype(
        np.float32)).to(torch.bfloat16)
    dz = torch.from_numpy(rng.randn(n, h, w, co).astype(np.float32)).to(
        torch.bfloat16)
    w1, b1, wd, _ = (torch.from_numpy(p) for p in _unit_params(ci, co, 9))
    got = _emulated_mma_bwd(x, w1, b1, wd, dz)
    want = fused_pw_dw_bwd_plain(x, w1, b1, wd, dz)
    for name, g, wt in zip(NAMES, got, want):
        assert g.shape == wt.shape and g.dtype == wt.dtype, name
        a, b = g.float(), wt.float()
        d = (a - b).abs()
        if name == "dx":
            d = (d - torch.from_numpy(_bf16_ulp(np.maximum(
                a.abs().numpy(), b.abs().numpy())))).clamp_min(0)
        assert float(d.max() / b.abs().max()) <= BWD_TOL, name
