"""yunet_tpu_torch box ops and loss primitives == yunet_tpu's, f32 on the
CPU: values elementwise at rtol 1e-6 (the same expressions, op for op;
the 1e-6 leaves room for one ulp where torch's CPU log1p/exp and XLA's
differ), gradients against jax.grad at rtol 1e-5 (the backward formulas
are autodiff's on both sides, but may group a product differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunet_tpu.ops import boxes as jboxes
from yunet_tpu.ops import losses as jlosses
from yunet_tpu_torch.ops import boxes as tboxes
from yunet_tpu_torch.ops import losses as tlosses


def _xyxy(rng, shape, lo=0.0, hi=100.0):
    c = rng.uniform(lo + 10, hi - 10, shape + (2,))
    wh = rng.uniform(0.5, 40, shape + (2,))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _inputs(name, rng):
    """Positional numpy inputs and keyword options of each function."""
    if name == "bce_with_logits":
        return (rng.randn(6, 50).astype(np.float32) * 4,
                rng.uniform(0, 1, (6, 50)).astype(np.float32)), {}
    if name == "bce_probs":
        p = rng.uniform(0, 1, (6, 50)).astype(np.float32)
        p[0, :3] = (0.0, 1.0, 1e-30)          # both -100 log clamps
        return (p, (rng.uniform(size=(6, 50)) < 0.5).astype(np.float32)), {}
    if name == "smooth_l1":
        return (rng.randn(6, 50).astype(np.float32) * 0.3,
                rng.randn(6, 50).astype(np.float32) * 0.3), {"beta": 1 / 9}
    if name == "eiou":
        pred = _xyxy(rng, (300,))
        tgt = pred + rng.normal(0, 6, (300, 4)).astype(np.float32)
        tgt[::3] = _xyxy(rng, (100,))          # disjoint pairs too
        return (pred, tgt), {"smooth_point": 0.1, "eps": 1e-6}
    if name == "kps_encode":
        pri = np.concatenate([rng.uniform(0, 100, (40, 2)),
                              np.full((40, 2), 16.0)], -1).astype(np.float32)
        return (pri, rng.uniform(0, 100, (3, 40, 10)).astype(np.float32)), {}
    if name == "aligned_iou":
        a = _xyxy(rng, (200,))
        b = a + rng.normal(0, 8, (200, 4)).astype(np.float32)
        b[:20] = a[:20]                         # identical boxes
        b[20:25, 2:] = b[20:25, :2] - 1         # inverted: zero area
        return (a, b), {}
    if name == "pairwise_iou":
        return (_xyxy(rng, (2, 30)), _xyxy(rng, (2, 12))), {}
    raise KeyError(name)


FUNCS = {"bce_with_logits": (jlosses, tlosses), "bce_probs": (jlosses, tlosses),
         "smooth_l1": (jlosses, tlosses), "eiou": (jlosses, tlosses),
         "kps_encode": (jboxes, tboxes), "aligned_iou": (jboxes, tboxes),
         "pairwise_iou": (jboxes, tboxes)}
# bce_probs' targets and the priors of kps_encode carry no gradient here
DIFF_ARGS = {"bce_probs": (0,), "kps_encode": (1,)}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_values_and_grads_match_jax(name):
    jmod, tmod = FUNCS[name]
    rng = np.random.RandomState(sorted(FUNCS).index(name))
    args, kw = _inputs(name, rng)
    jfn = getattr(jmod, name)
    tfn = getattr(tmod, name)
    want = np.asarray(jfn(*map(jnp.asarray, args), **kw))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tfn(*targs, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)

    weights = rng.randn(*want.shape).astype(np.float32)
    which = DIFF_ARGS.get(name, tuple(range(len(args))))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a, **kw) * weights),
                      argnums=which)(*map(jnp.asarray, args))
    (got * torch.from_numpy(weights)).sum().backward()
    for i, g in zip(which, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"d/d arg {i}")


def test_iou_eps_and_aligned_equals_pairwise_diagonal():
    assert tboxes.IOU_EPS == jboxes.IOU_EPS
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(_xyxy(rng, (40,))) for _ in range(2))
    full = tboxes.pairwise_iou(a, b)
    assert torch.equal(torch.diagonal(full), tboxes.aligned_iou(a, b))


def test_eiou_sign_is_detached():
    """The smooth-L1 branch selector carries no gradient, as JAX's
    stop_gradient: the gradient is that of the selected branch alone."""
    pred = torch.tensor([[10.0, 10.0, 30.0, 30.0], [0.0, 0.0, 5.0, 5.0]],
                        requires_grad=True)
    tgt = torch.tensor([[11.0, 10.0, 30.0, 31.0], [20.0, 20.0, 40.0, 40.0]])
    out = tlosses.eiou(pred, tgt)
    out.sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jlosses.eiou(p, jnp.asarray(
        tgt.numpy()))))(jnp.asarray(pred.detach().numpy()))
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    # first pair: x < 0.1 (quadratic branch); second: linear branch
    assert float(out[0].detach()) < 0.05 and float(out[1].detach()) > 0.9
