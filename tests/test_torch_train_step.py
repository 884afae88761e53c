"""yunet_tpu_torch's training step == yunet_tpu's, on the CPU, from the
same r04 EMA weights (tests/fixtures/r04_ema.npz) on the same seeded
64x64 batches. The port runs its factored ConvDPUnit and the streamed
SimOTA (plain version); JAX runs its dense SimOTA off the TPU, which the
streamed one equals (tests/test_torch_assign.py).

Tolerances, f32:
  * losses: rtol 1e-5 (the same f32 expressions; convolutions and sums
    taken in another order);
  * gradients: rtol 1e-3 per element plus 1e-4 of the leaf's largest
    magnitude. The elementwise atol 1e-6 first planned fails by up to 17x:
    summed in another order, the f32 convolution gradients carry noise of
    ~1e-5 of each leaf's scale on its near-zero elements (measured on
    these inputs), while the losses agree to 1e-6;
  * params and BN running statistics after 3 steps: rtol 5e-4 / atol 5e-6;
    against JAX's composed ConvDPUnit (model.composed_dp), JAX's own
    composed-vs-factored tolerance (tests/test_train_step.py:271-280);
  * fg_mask: equal in every step.
The bf16 step is held to JAX's bf16 step within BF16_LOSS_BAND.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train_step import _batch
from yunet_tpu.config import yunet_n as jax_yunet_n
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.ops.boxes import bbox_decode as jax_decode
from yunet_tpu.ops.priors import grid_priors
from yunet_tpu.train import init_train_state as jax_init
from yunet_tpu.train import make_train_step as jax_make_step
from yunet_tpu.train.lr import lr_schedule as jax_lr_schedule
from yunet_tpu.train.step import loss_fn as jax_loss_fn
from yunet_tpu.train.targets import build_targets_batched as jax_targets
from yunet_tpu_torch.config import yunet_n
from yunet_tpu_torch.train import (init_train_state, loss_fn,
                                   make_train_step)
from yunet_tpu_torch.train.lr import lr_schedule
from yunet_tpu_torch.train.step import SGDMomentum
from yunet_tpu_torch.utils.jax_params import (_leaves, jax_from_state_dict,
                                              load_flat_npz,
                                              state_dict_from_jax)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "r04_ema.npz")
IMG = 64
# |port - JAX| / JAX of each loss part after one bf16 step. Measured over
# batch seeds 4-6: up to 0.74% on the total and 1.65% on a part (bf16
# rounds at other places in the two trunks: torch's convs add the bias
# inside, XLA's after, and JAX's default composes pw*dw into one conv)
BF16_LOSS_BAND = 3e-2
METRICS = ("loss", "loss_cls", "loss_obj", "loss_bbox", "loss_kps",
           "num_pos")


def _cfgs(composed=False, **train):
    """(JAX config, port config): f32 unless train says otherwise."""
    train = {"bf16": False, **train}
    j, t = jax_yunet_n(), yunet_n()
    j = dataclasses.replace(
        j, model=dataclasses.replace(j.model, composed_dp=composed),
        train=dataclasses.replace(j.train, **train))
    return j, dataclasses.replace(t, train=dataclasses.replace(t.train,
                                                               **train))


@pytest.fixture(scope="module")
def r04():
    return load_flat_npz(FIXTURE, yunet_n().model)


def _np_batch(b, seed):
    return {k: np.array(v) for k, v in _batch(b, IMG, seed=seed).items()}


def _port_state(tcfg, r04, b):
    return init_train_state(tcfg, steps_per_epoch=10, total_batch=b,
                            device="cpu", state_dict=state_dict_from_jax(*r04))


def _as_jax_tree(model, named):
    """Port tensors by parameter name -> a JAX params tree (buffers fill
    the state half, which is dropped)."""
    sd = dict(named)
    sd.update({n: b for n, b in model.named_buffers()})
    return jax_from_state_dict(sd, model.cfg)[0]


def _leafwise(got_tree, want_tree, *, rtol, atol, scale_atol=0.0):
    pairs = list(zip(_leaves(jax.tree.map(np.asarray, want_tree)),
                     _leaves(got_tree)))
    assert pairs
    for (path, want), (_, got) in pairs:
        want = np.asarray(want)
        tol = atol + scale_atol * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=rtol, atol=tol,
                                   err_msg="/".join(path))


def _jax_fg_fn(jcfg, priors):
    """JAX's fg_mask for (params, state, batch), as its loss_fn builds it."""
    model = JaxYuNet(jcfg.model)

    @jax.jit
    def fg(params, state, batch):
        flat, _ = model.forward_flat(params, state, batch["image"],
                                     train=True, bn_group=jcfg.train.bn_group)
        dec = jax_decode(priors, flat["bbox"])
        return jax_targets(
            flat["cls"], flat["obj"][..., 0], priors, dec,
            batch["gt_bboxes"], batch["gt_labels"], batch["gt_kps"],
            batch["gt_valid"], num_classes=1, kps_num=5, center_radius=2.5,
            candidate_topk=10, iou_weight=3.0, cls_weight=1.0,
            use_pallas=False)["fg"]
    return fg


def _priors():
    return grid_priors([(IMG // s, IMG // s) for s in (8, 16, 32)],
                       (8, 16, 32), 0.0)


def test_loss_and_grads_match_jax(r04):
    jcfg, tcfg = _cfgs()
    batch = _np_batch(2, 0)
    priors = _priors()
    jmodel = JaxYuNet(jcfg.model)
    (jl, (jstate, jm)), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jmodel, jcfg, p, r04[1], batch,
                              jnp.asarray(priors)), has_aux=True))(r04[0])
    ts, _ = _port_state(tcfg, r04, 2)
    model = ts.model
    total, m, aux = loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in
                                          batch.items()},
                            torch.from_numpy(priors))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(m["num_pos"]) > 0
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True)
    # the BN-covered biases are detached: no gradient (JAX: exactly 0)
    covered = {n for n, g in zip(names, grads) if g is None}
    assert len(covered) >= 8
    assert all(n.endswith("conv2.bias") or n == "backbone.model0.conv1.bias"
               for n in covered)
    _leafwise(_as_jax_tree(model, [
        (n, torch.zeros_like(p) if g is None else g)
        for n, p, g in zip(names, model.parameters(), grads)]), jg,
        rtol=1e-3, atol=0.0, scale_atol=1e-4)
    # the running statistics updated in place == JAX's new_state
    _leafwise(jax_from_state_dict(model.state_dict(), tcfg.model)[1],
              jstate, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("composed", [False, True])
def test_three_steps_match_jax(r04, composed):
    jcfg, tcfg = _cfgs(composed=composed)
    batch = _np_batch(2, 1)
    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=2,
                       params=r04[0], state=r04[1])
    jstep = jax_make_step(jcfg, JaxYuNet(jcfg.model), tx, img_size=IMG)
    jfg = _jax_fg_fn(jcfg, jnp.asarray(_priors()))
    ts, opt = _port_state(tcfg, r04, 2)
    step = make_train_step(tcfg, ts.model, opt, img_size=IMG)
    rtol_loss = 1e-4 if composed else 1e-5
    for i in range(3):
        want_fg = np.asarray(jfg(jts.params, jts.state, batch))
        jts, jm = jstep(jts, batch)
        ts, m, aux = step(ts, batch, return_aux=True)
        np.testing.assert_array_equal(aux["targets"]["fg"].numpy(), want_fg,
                                      err_msg=f"step {i}")
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=rtol_loss, err_msg=f"{k}, {i}")
    assert ts.step == 3 and opt.count == 3
    p, s = jax_from_state_dict(ts.model.state_dict(), tcfg.model)
    tol = dict(rtol=5e-3, atol=5e-5) if composed else dict(rtol=5e-4,
                                                           atol=5e-6)
    _leafwise(p, jts.params, **tol)
    _leafwise(s, jts.state, **tol)


def test_ghost_bn_ema_and_clip_steps_match_jax(r04):
    """GhostBN bn_group=2 at b4, the EMA shadow and global-norm clipping
    (clip 1.0, below the gradient norm here) for 2 steps."""
    jcfg, tcfg = _cfgs(bn_group=2, ema_momentum=0.9, grad_clip=1.0)
    batch = _np_batch(4, 2)
    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=4,
                       params=r04[0], state=r04[1])
    jstep = jax_make_step(jcfg, JaxYuNet(jcfg.model), tx, img_size=IMG)
    ts, opt = _port_state(tcfg, r04, 4)
    step = make_train_step(tcfg, ts.model, opt, img_size=IMG)
    for i in range(2):
        jts, jm = jstep(jts, batch)
        ts, m = step(ts, batch)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k}, {i}")
    p, s = jax_from_state_dict(ts.model.state_dict(), tcfg.model)
    _leafwise(p, jts.params, rtol=5e-4, atol=5e-6)
    _leafwise(s, jts.state, rtol=5e-4, atol=5e-6)
    names = [n for n, _ in ts.model.named_parameters()]
    ema = _as_jax_tree(ts.model, zip(names, ts.ema))
    _leafwise(ema, jts.ema_params, rtol=5e-4, atol=5e-6)
    # the EMA moved off the initial params, and not onto the new ones
    first = dict(ts.model.named_parameters())
    assert any(not torch.equal(e, first[n]) for n, e in zip(names, ts.ema))


@pytest.mark.parametrize("auto_scale", [False, True])
def test_lr_schedule_matches_jax(auto_scale):
    """The plain-Python schedule (float64) == JAX's (float32) at sampled
    steps, rtol 2e-5: at the start of warmup JAX's float32
    1 - (1 - frac) * (1 - ratio) cancels down to 0.001 and keeps only
    ~1.3e-5 of relative precision (measured at step 0)."""
    kw = dict(steps_per_epoch=100, warmup_iters=1500, warmup_ratio=0.001,
              decay_epochs=(400, 544), decay_factor=0.1)
    base = 0.01 * (128 / 32 if auto_scale else 1)
    port, jx = lr_schedule(base, **kw), jax_lr_schedule(base, **kw)
    for s in (0, 1, 7, 750, 1499, 1500, 1501, 39_999, 40_000, 54_399,
              54_400, 63_999):
        np.testing.assert_allclose(port(s), float(jx(s)), rtol=2e-5,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("kind", ["exp", "linear"])
def test_ema_momentum_matches_jax(kind):
    """The EMA momentum warmups (plain Python, float64) == JAX's (float32)
    at sampled steps, rtol 1e-6."""
    from yunet_tpu.train import ema as jax_ema
    from yunet_tpu_torch.train import ema
    port = getattr(ema, f"{kind}_momentum")(0.9998)
    jx = getattr(jax_ema, f"{kind}_momentum")(0.9998)
    for s in (0, 1, 10, 99, 100, 1999, 5000):
        np.testing.assert_allclose(port(s), float(jx(jnp.float32(s))),
                                   rtol=1e-6, err_msg=f"step {s}")


def test_bn_covered_biases_are_still_decayed(r04):
    """A detached BN-covered bias takes a zero gradient in the update: with
    no momentum yet, p <- p + (0 + wd*p) * -lr(0), exactly."""
    # lr 1 without warmup: lr*wd*p must not round away in f32
    _, tcfg = _cfgs(lr=1.0, warmup_iters=0)
    ts, opt = _port_state(tcfg, r04, 2)
    step = make_train_step(tcfg, ts.model, opt, img_size=IMG)
    params = dict(ts.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    ts, _ = step(ts, _np_batch(2, 3))
    lr0 = opt.schedule(0)
    for n in ("backbone.model0.conv1.bias", "backbone.model1.conv1.conv2.bias",
              "neck.lateral_convs.0.conv2.bias"):
        p0 = before[n]
        want = p0 + (torch.zeros_like(p0) + 5e-4 * p0) * -lr0
        assert torch.equal(params[n].detach(), want), n
        assert not torch.equal(params[n].detach(), p0), n


def test_sgd_momentum_trace_and_clip():
    """The optax chain by hand on one tensor: clip to norm 1, add wd*p,
    trace m = g + 0.9 m, p -= lr m."""
    p = torch.tensor([1.0, -2.0])
    opt = SGDMomentum(lambda c: 0.1 * (c + 1), momentum=0.9,
                      weight_decay=0.5, grad_clip=1.0)
    opt.update([p], [torch.tensor([3.0, 4.0])])
    g1 = torch.tensor([0.6, 0.8]) + 0.5 * torch.tensor([1.0, -2.0])
    p1 = torch.tensor([1.0, -2.0]) - 0.1 * g1
    torch.testing.assert_close(p, p1, rtol=1e-6, atol=1e-7)
    opt.update([p], [None])
    m2 = 0.5 * p1 + 0.9 * g1
    torch.testing.assert_close(p, p1 - 0.2 * m2, rtol=1e-6, atol=1e-7)


def test_bf16_step_matches_jax_within_band(r04):
    """One step of the shipped bf16 config (JAX with its default composed
    ConvDPUnit) on the same batch: every loss part within the band."""
    jcfg, tcfg = _cfgs(composed=True, bf16=True)
    batch = _np_batch(2, 4)
    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=2,
                       params=r04[0], state=r04[1])
    jstep = jax_make_step(jcfg, JaxYuNet(jcfg.model), tx, img_size=IMG)
    ts, opt = _port_state(tcfg, r04, 2)
    step = make_train_step(tcfg, ts.model, opt, img_size=IMG)
    _, jm = jstep(jts, batch)
    _, m = step(ts, batch)
    assert float(m["num_pos"]) == float(jm["num_pos"])
    for k in ("loss", "loss_cls", "loss_obj", "loss_bbox", "loss_kps"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=BF16_LOSS_BAND, err_msg=k)


def test_fused_step_matches_jax(r04):
    """The fused-kernel path (train.fused_kernels: every ConvDPUnit through
    the fused forward and its hand-written backward, here their plain
    versions) against JAX's fused step (Pallas in interpret mode), f32,
    64^2 b2: losses at rtol 1e-5, gradients and the params after one step
    under the tolerances of the unfused tests above."""
    jcfg, tcfg = _cfgs(fused_kernels=True)
    batch = _np_batch(2, 0)
    priors = _priors()
    jmodel = JaxYuNet(jcfg.model)
    (_, (_, jm)), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jmodel, jcfg, p, r04[1], batch,
                              jnp.asarray(priors)), has_aux=True))(r04[0])
    ts, opt = _port_state(tcfg, r04, 2)
    model = ts.model
    total, m, _ = loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in
                                        batch.items()},
                          torch.from_numpy(priors))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True)
    _leafwise(_as_jax_tree(model, [
        (n, torch.zeros_like(p) if g is None else g)
        for n, p, g in zip(names, model.parameters(), grads)]), jg,
        rtol=1e-3, atol=0.0, scale_atol=1e-4)

    jts, tx = jax_init(jcfg, steps_per_epoch=10, total_batch=2,
                       params=r04[0], state=r04[1])
    jts, jm = jax_make_step(jcfg, jmodel, tx, img_size=IMG)(jts, batch)
    ts, opt = _port_state(tcfg, r04, 2)
    ts, m = make_train_step(tcfg, ts.model, opt, img_size=IMG)(ts, batch)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    p, s = jax_from_state_dict(ts.model.state_dict(), tcfg.model)
    _leafwise(p, jts.params, rtol=5e-4, atol=5e-6)
    _leafwise(s, jts.state, rtol=5e-4, atol=5e-6)


def test_validate_config_matches_jax():
    """validate_config raises on the same configs as JAX's, with the same
    message, and passes the rest (the cases of
    tests/test_aux.py:test_validate_config_rejects_parked_flags)."""
    from yunet_tpu.config import validate_config as jax_validate
    from yunet_tpu_torch.config import validate_config

    def both(section, **kw):
        j, t = jax_yunet_n(), yunet_n()
        return tuple(dataclasses.replace(c, **{section: dataclasses.replace(
            getattr(c, section), **kw)}) for c in (j, t))

    cases = [(both("train"), None, None),
             (both("train", fused_kernels=True), "fused_kernels", True),
             (both("model", remat_stages=(0, 1)), "remat_stages", True),
             (both("data", bank_sharded=True), "bank_sharded", False),
             (both("train", bn_group=5), "bn_group", False),
             (both("train", bn_group=-1), "bn_group", False),
             (both("data", device_aug=True, bank_canvas=600),
              "bank_canvas", False),
             (both("train", bn_group=16), None, None)]
    for (jc, tc), match, forcible in cases:
        if match is None:
            assert validate_config(tc) is tc
            jax_validate(jc)
            continue
        with pytest.raises(ValueError, match=match) as want:
            jax_validate(jc)
        with pytest.raises(ValueError, match=match) as got:
            validate_config(tc)
        assert str(got.value) == str(want.value)
        if forcible:
            assert validate_config(tc, force_experimental=True) is tc
            jax_validate(jc, force_experimental=True)
        else:
            with pytest.raises(ValueError, match=match):
                validate_config(tc, force_experimental=True)


def test_seeded_init_trains_and_unported_options_raise():
    _, tcfg = _cfgs()
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    ts, opt = init_train_state(tcfg, steps_per_epoch=10, total_batch=2,
                               device="cpu", generator=gen())
    again, _ = init_train_state(tcfg, steps_per_epoch=10, total_batch=2,
                                device="cpu", generator=gen())
    for a, b in zip(ts.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    assert ts.model.training and ts.ema is None
    step = make_train_step(tcfg, ts.model, opt, img_size=IMG)
    batch = _np_batch(2, 0)
    losses = [float(step(ts, batch)[1]["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # a bank batch trains: crops resampled from the bank (one inside the
    # image, one flipped and past its edge), GT slots re-padded
    rng = np.random.RandomState(5)
    bank = torch.from_numpy(rng.randint(0, 256, (2, 96, 96, 3)).astype(
        np.uint8))
    aug = {"bank": bank, "aug_idx": np.array([0, 1], np.int32),
           "aug_y0": np.array([8.0, -20.0], np.float32),
           "aug_x0": np.array([0.0, 40.0], np.float32),
           "aug_side": np.array([IMG, 1.5 * IMG], np.float32),
           "aug_flip": np.array([False, True]),
           **{k: batch[k][:, :4] for k in ("gt_bboxes", "gt_labels",
                                           "gt_kps", "gt_valid")}}
    ts, m, aux = step(ts, aug, return_aux=True)
    assert np.isfinite(float(m["loss"])) and ts.step == 9
    assert aux["targets"]["fg"].shape[0] == 2
    # a mesh with no process group behind it (2 ranks:
    # tests/test_torch_parallel.py)
    from yunet_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match="process group"):
        make_train_step(tcfg, ts.model, opt, img_size=IMG,
                        mesh=Mesh(0, 2, torch.device("cpu")))


def test_train_path_imports_without_jax_and_reads_no_jax_file():
    """The training modules import neither jax nor yunet_tpu, and no
    module of the port names a file of the JAX package."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; before = set(sys.modules); "
            "import yunet_tpu_torch.train, yunet_tpu_torch.ops.assign; "
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'yunet_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    pkg = os.path.join(root, "yunet_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert '"yunet_tpu"' not in fh.read(), f
