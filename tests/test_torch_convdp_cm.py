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
