"""yunet_tpu_torch's channels-major fused ConvDPUnit (ops/convdp_cm.py,
plain version on the CPU) == yunet_tpu's fused_conv_dp_cm_impl (Pallas,
interpret mode), and its parity with the NHWC unit (ops/convdp.py) on the
transposed data, which the JAX package does not test.

Tolerances: f32 rtol/atol 1e-5 (sums in another order). bf16 against JAX:
one bf16 ulp of the output (both round y1 to bf16 and the output once;
an f32 sum in another order can round either way). bf16 against the NHWC
unit, which keeps y1 in f32: the y1 rounding, at most half a bf16 ulp of
each channel's largest |y1| through the nine taps, plus one ulp of the
output.

The bf16 tensor-core route of csrc/convdp_cm.cu cannot run here; its
arithmetic is emulated in numpy (_emulate_mma) and held to JAX's Pallas
kernel and to the plain version with the check chip_smoke.py applies to
the kernel: one bf16 ulp of the channel's largest |y1| times sum|wd|
(y1 may round the other way after another sum order), plus one ulp of
the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu.ops.convdp_cm_pallas import fused_conv_dp_cm_impl
from yunet_tpu_torch.ops.convdp import fused_conv_dp_plain
from yunet_tpu_torch.ops.convdp_cm import (fused_conv_dp_cm,
                                           fused_conv_dp_cm_plain)

N = 128
# (H, W, Cin, Cout, row_block, wcol_block): blocks ragged in H and in W
SHAPES = [(10, 6, 8, 16, 4, 4), (9, 5, 3, 8, 2, 2)]


def _inputs(h, w, ci, co, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(h, ci, w * N).astype(np.float32),
            rng.randn(1, 1, ci, co).astype(np.float32) * 0.3,
            rng.randn(co).astype(np.float32) * 0.2,
            rng.randn(3, 3, 1, co).astype(np.float32) * 0.3,
            rng.randn(co).astype(np.float32) * 0.2)


def _ulp(a):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,ci,co,rb,wb", SHAPES)
def test_fused_conv_dp_cm_matches_jax(h, w, ci, co, rb, wb, dtype, relu):
    x, w1, b1, wd, bd = _inputs(h, w, ci, co, 0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(fused_conv_dp_cm_impl(
        jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(wd), jnp.asarray(bd), w=w, n=N, relu=relu, row_block=rb,
        wcol_block=wb).astype(jnp.float32))
    got = fused_conv_dp_cm(torch.from_numpy(x).to(tdt),
                           *(torch.from_numpy(a) for a in (w1, b1, wd, bd)),
                           w=w, n=N, relu=relu)
    assert got.dtype == tdt and got.shape == (h, co, w * N)
    assert got.is_contiguous()
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want)
                      <= _ulp(np.maximum(np.abs(got), np.abs(want))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_conv_dp_cm_matches_nhwc_unit(dtype):
    """The channels-major unit == the NHWC unit on the same data laid out
    as (N, H, W, C), and any N is taken (here 37)."""
    h, w, ci, co, n = 11, 7, 16, 24, 37
    rng = np.random.RandomState(1)
    xn = rng.randn(n, h, w, ci).astype(np.float32)
    w1, b1, wd, bd = (torch.from_numpy(a) for a in (
        rng.randn(ci, co).astype(np.float32) * 0.3,
        rng.randn(co).astype(np.float32) * 0.2,
        rng.randn(9, co).astype(np.float32) * 0.3,
        rng.randn(co).astype(np.float32) * 0.2))
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(xn).to(tdt)
    cm = x.permute(1, 3, 2, 0).reshape(h, ci, w * n).contiguous()
    got = fused_conv_dp_cm(cm, w1, b1, wd, bd, w=w, n=n, relu=False)
    ref = fused_conv_dp_plain(x, w1, b1, wd, bd, relu=False)
    want = ref.permute(1, 3, 2, 0).reshape(h, co, w * n)
    got, want = got.float().numpy(), want.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    y1 = (x.float() @ w1.to(tdt).float() + b1).abs().amax((0, 1, 2))
    y1_err = (0.5 * _ulp(y1.numpy())[None, :, None]
              * wd.abs().sum(0).numpy()[None, :, None])
    diff = np.abs(got - want)
    assert np.all(diff <= y1_err + _ulp(np.maximum(np.abs(got),
                                                    np.abs(want))))
    assert diff.max() > 0  # the rounding of y1 shows


def test_fused_conv_dp_cm_shape_and_device_checks():
    x, w1, b1, wd, bd = (torch.from_numpy(a) for a in _inputs(4, 3, 8, 8, 2))
    with pytest.raises(ValueError, match="is not"):
        fused_conv_dp_cm(x, w1, b1, wd, bd, w=4, n=N)
    with pytest.raises(ValueError, match="no kernel"):
        fused_conv_dp_cm(x.to("meta"), w1, b1, wd, bd, w=3, n=N)
    assert torch.equal(
        fused_conv_dp_cm(x, w1, b1, wd, bd, w=3, n=N, relu=True),
        fused_conv_dp_cm_plain(x, w1, b1, wd, bd, w=3, n=N, relu=True))


def test_bench_twin_has_no_cpu_path():
    """The bench twin refuses to run without a CUDA device."""
    from yunet_tpu_torch.tools import bench_convdp_cm
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_convdp_cm.run()


def _bf16(a):
    """f32 -> the nearest bf16 (ties to even), as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _emulate_mma(x, w1, b1, wd, bd, *, w, n, relu):
    """The bf16 route of csrc/convdp_cm.cu in numpy, x (H, Cin, W*N) ->
    (H, Cout, W*N), bf16 values as f32. y1: one chained mma.sync per
    16-deep k-step, each adding the step's exact bf16 x bf16(w1) products
    to the f32 accumulator with one rounding; + b1 in f32, rounded to
    bf16, zero outside the image. Then the nine taps in order t = 0..8 as
    f32 fmaf (the bf16 x f32 product is exact in f64), + bd, ReLU, one
    rounding to bf16."""
    h, cin = x.shape[:2]
    w1 = w1.reshape(cin, -1)
    cout = w1.shape[1]
    xb = _bf16(x).reshape(h, cin, w, n).astype(np.float64)
    w1b = _bf16(w1).astype(np.float64)
    acc = np.zeros((h, cout, w, n), np.float32)
    for k in range(0, cin, 16):
        part = np.einsum("ic,hiwn->hcwn", w1b[k:k + 16], xb[:, k:k + 16])
        acc = (acc + part).astype(np.float32)
    y1 = _bf16(acc + b1.astype(np.float32).reshape(1, cout, 1, 1))
    y1 = np.pad(y1, ((1, 1), (0, 0), (1, 1), (0, 0))).astype(np.float64)
    wd = wd.reshape(9, cout).astype(np.float64)
    out = np.zeros((h, cout, w, n), np.float32)
    for t in range(9):
        ty, tx = divmod(t, 3)
        out = (out + y1[ty:ty + h, :, tx:tx + w]
               * wd[t].reshape(1, cout, 1, 1)).astype(np.float32)
    out = out + bd.astype(np.float32).reshape(1, cout, 1, 1)
    if relu:
        out = np.maximum(out, 0.0)
    return _bf16(out).reshape(h, cout, w * n)


def _cm_tolerance(x, w1, b1, wd, got, want):
    """One bf16 ulp of each channel's largest |y1| through sum|wd|, plus
    one ulp of the output (chip_smoke.py:_check_convdp_cm)."""
    cin = x.shape[1]
    w1 = w1.reshape(cin, -1)
    xf = _bf16(x).transpose(0, 2, 1).reshape(-1, cin)
    y1 = np.abs(xf @ _bf16(w1) + b1).max(0)
    return ((_ulp(y1) * np.abs(wd).reshape(9, -1).sum(0))[None, :, None]
            + _ulp(np.maximum(np.abs(got), np.abs(want))))


# (H, W, Cin, Cout, N, row_block, wcol_block): SHAPES at N = 128, a
# 64 -> 64 unit (the bench's widths) at a small H x W, and N = 37 (JAX takes
# N % 128 == 0 only, so it runs at N = 128 with the other images zero)
MMA_CASES = [s[:4] + (N,) + s[4:] for s in SHAPES] + [
    (6, 5, 64, 64, N, 4, 4), (11, 7, 16, 24, 37, 4, 4)]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w,ci,co,n,rb,wb", MMA_CASES)
def test_mma_emulation_matches_jax(h, w, ci, co, n, rb, wb, relu):
    """The bf16 route's arithmetic against JAX's fused_conv_dp_cm_impl
    (Pallas, interpret mode) and the plain version, on the same bf16 x."""
    rng = np.random.RandomState(3)
    x = rng.randn(h, ci, w * n).astype(np.float32)
    w1, b1, wd, bd = (rng.randn(ci, co).astype(np.float32) * 0.3,
                      rng.randn(co).astype(np.float32) * 0.2,
                      rng.randn(9, co).astype(np.float32) * 0.3,
                      rng.randn(co).astype(np.float32) * 0.2)
    got = _emulate_mma(x, w1, b1, wd, bd, w=w, n=n, relu=relu)
    assert got.shape == (h, co, w * n) and np.all(np.isfinite(got))
    xj = np.zeros((h, ci, w, 128), np.float32)
    xj[..., :n] = x.reshape(h, ci, w, n)
    want = np.asarray(fused_conv_dp_cm_impl(
        jnp.asarray(xj.reshape(h, ci, w * 128), jnp.bfloat16),
        jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(wd), jnp.asarray(bd),
        w=w, n=128, relu=relu, row_block=rb, wcol_block=wb
    ).astype(jnp.float32)).reshape(h, co, w, 128)[..., :n]
    want = want.reshape(h, co, w * n)
    plain = fused_conv_dp_cm_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        *(torch.from_numpy(a) for a in (w1, b1, wd, bd)), w=w, n=n,
        relu=relu).float().numpy()
    for ref in (want, plain):
        diff = np.abs(got - ref)
        assert np.all(diff <= _cm_tolerance(x, w1, b1, wd, got, ref))
