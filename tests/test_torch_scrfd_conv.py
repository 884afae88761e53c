"""SCRFD's conv with its epilogue (``yunet_tpu_torch/ops/conv_epi.py``) on
the CPU: the plain version against the composition it replaces (conv +
bias, + the shortcut or its nearest 2x upsample, + ReLU) in f32, the
packed weights against the OIHW ones, the kernel's GEMM view of the
packed weights (K tap-major, each tap's channels padded to a multiple of
8) emulated in f32 torch ops, the block tiles the wrapper picks for each
of SCRFD-10GF-KPS's 58 convs, and the folded trunk in its new order
(each residual made before the conv that adds it) against the old one.
The kernel itself runs only on the card (``chip_smoke.py:phase_scrfd``).
"""

import dataclasses
import itertools

import pytest
import torch
import torch.nn.functional as F

from portbench import harness
from portbench.weights.make_scrfd_10g_bnkps import draw
from portbench.yardstick import gen
from yunet_tpu_torch.config import get_config
from yunet_tpu_torch.eval.detect import Detector
from yunet_tpu_torch.models import scrfd as scrfd_module
from yunet_tpu_torch.models.head import flatten_level_outputs
from yunet_tpu_torch.models.scrfd import (SCRFD, fold_scrfd,
                                          normalize_input, scrfd_forward)
from yunet_tpu_torch.ops.conv_epi import (TILE_N, conv_epi, conv_epi_plain,
                                          pack_weights, padded_channels,
                                          tiles, unpack_weights)
from yunet_tpu_torch.utils import flops

CFG = get_config("scrfd_10g_bnkps")
SHAPES = list(itertools.product((1, 3), (1, 2), (3, 28, 88), (2, 20, 224)))


def _conv_inputs(k, stride, cin, cout, seed=0, hw=(8, 12)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cin, *hw, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
    b = torch.randn(cout, generator=g)
    ho, wo = (s // stride for s in hw)
    res = {None: None,
           1: torch.randn(2, cout, ho, wo, generator=g),
           2: torch.randn(2, cout, ho // 2, wo // 2, generator=g)}
    return x, w, b, res


@pytest.mark.parametrize("k,stride,cin,cout", SHAPES,
                         ids=[f"k{k}s{s}c{ci}o{co}"
                              for k, s, ci, co in SHAPES])
def test_plain_equals_the_composition_it_replaces(k, stride, cin, cout):
    """f32, the same operations in the same order: equal bit for bit, for
    no shortcut, one at the output's size and one upsampled 2x, each with
    and without the ReLU."""
    x, w, b, res = _conv_inputs(k, stride, cin, cout)
    for up, relu in itertools.product(res, (False, True)):
        want = F.conv2d(x, w, b, stride, k // 2)
        if up is not None:
            want = want + (res[up] if up == 1 else F.interpolate(
                res[up], size=want.shape[2:], mode="nearest"))
        if relu:
            want = F.relu(want)
        kw = dict(stride=stride, relu=relu, residual=res[up],
                  upsample=up or 1)
        got = conv_epi_plain(x, w, b, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        # a CPU tensor takes the plain version through the wrapper too
        torch.testing.assert_close(conv_epi(x, w, pack_weights(w), b, **kw),
                                   want, rtol=0, atol=0)


@pytest.mark.parametrize("k,cin", list(itertools.product((1, 3),
                                                         (3, 28, 56, 224))))
def test_packed_weights_unpack_to_the_oihw_weights(k, cin):
    w = torch.randn(20, cin, k, k).contiguous(
        memory_format=torch.channels_last)
    wp = pack_weights(w)
    cp = padded_channels(cin)
    assert cp % 8 == 0 and cin <= cp < cin + 8
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert tuple(wp.shape) == (20, k * k * cp)
    torch.testing.assert_close(unpack_weights(wp, cin, k),
                               w.to(torch.bfloat16).float(), rtol=0, atol=0)
    # each tap's padding channels are zero
    assert not wp.reshape(20, k * k, cp)[..., cin:].any()


def _emulated_kernel(x, wp, b, k, stride, relu, residual, upsample):
    """The kernel's arithmetic in f32 torch ops, bf16 in: the A tile's
    gather of k = t * cp + c (tap t = ky * k + kx, channel c; zero past
    Cin and outside the image), the product with the packed rows, then the
    epilogue (+ bias, + the shortcut read at (y // up, x // up), ReLU),
    rounded once to bf16."""
    n, cin, h, w = x.shape
    cp = padded_channels(cin)
    xp = F.pad(x.float(), (k // 2,) * 4)
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, \
        (w + 2 * (k // 2) - k) // stride + 1
    cols = []
    for ky, kx in itertools.product(range(k), range(k)):
        tap = xp[:, :, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride]
        cols.append(F.pad(tap.permute(0, 2, 3, 1), (0, cp - cin)))
    a = torch.cat(cols, dim=-1).reshape(n * ho * wo, k * k * cp)
    y = (a @ wp.float().t() + b).reshape(n, ho, wo, -1)
    if residual is not None:
        r = residual.float().permute(0, 2, 3, 1)
        iy = torch.arange(ho) // upsample
        ix = torch.arange(wo) // upsample
        y = y + r[:, iy][:, :, ix]
    if relu:
        y = y.clamp_min(0)
    return y.to(torch.bfloat16).permute(0, 3, 1, 2)


@pytest.mark.parametrize("k,stride,cin,cout",
                         [(3, 2, 3, 28), (3, 1, 28, 56), (1, 1, 88, 56),
                          (3, 1, 80, 20), (3, 2, 56, 224)])
def test_the_kernels_gemm_view_is_the_conv(k, stride, cin, cout):
    """The emulated kernel against the plain version in f32 on the same
    bf16 inputs: within one bf16 rounding of the output (2^-8 of its
    magnitude), plus 2^-16 of the largest output for the f32 sums' other
    order where an output cancels to near zero."""
    x, w, b, res = _conv_inputs(k, stride, cin, cout, seed=1, hw=(8, 8))
    x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
    for up, relu in itertools.product(res, (False, True)):
        r16 = None if res[up] is None else res[up].to(torch.bfloat16)
        want = conv_epi_plain(x16.float(), w16.float(), b, stride=stride,
                              relu=relu, residual=None if r16 is None
                              else r16.float(), upsample=up or 1)
        got = _emulated_kernel(x16, pack_weights(w), b, k, stride, relu,
                               r16, up or 1).float()
        tol = 2.0 ** -8 * want.abs() + 2.0 ** -16 * want.abs().max()
        assert ((got - want).abs() <= tol).all()


def test_tiles_for_every_scrfd_conv():
    """Every conv of a 640x640 detect (and of a batch of 16 at 320x320)
    gets a block the kernel is built for: n8 tiles of TILE_N whose block
    columns cover Cout, an output tile of 32 * wm pixels 8 or 16 wide, at
    most 8 warps, and input channel chunks of 16, 32 or 64 that waste less
    than a chunk."""
    for n, hw in ((1, 640), (16, 320)):
        for c in flops.scrfd_convs(CFG.model, hw, hw):
            oh, ow = c.out
            nt, wm, wk, tw, kc = tiles(n, oh, ow, c.cin, c.cout, c.k)
            assert nt in TILE_N and wm in (1, 2, 4, 8) and wk in (1, 2, 4, 8)
            assert wm * wk <= 8 and tw in (8, 16) and 32 * wm % tw == 0
            assert kc in (16, 32, 64)
            assert -(-padded_channels(c.cin) // kc) * kc \
                < padded_channels(c.cin) + kc
            cols = -(-c.cout // (8 * nt))
            assert 8 * nt * (cols - 1) < c.cout <= 8 * nt * cols


def test_plain_refuses_a_residual_of_another_size():
    x, w, b, res = _conv_inputs(3, 1, 28, 20)
    with pytest.raises(ValueError, match="residual"):
        conv_epi_plain(x, w, b, stride=1, relu=True, residual=res[2])
    with pytest.raises(ValueError, match="residual"):
        conv_epi_plain(x, w, b, stride=1, relu=True, residual=res[1],
                       upsample=2)


def _old_scrfd_forward(folded, x, cfg):
    """The folded trunk as it ran before the epilogue took the adds: each
    conv with its bias through F.conv2d, then the shortcut add and ReLU,
    the upsample and the FPN adds as passes of their own."""
    def conv(y, c, relu=None):
        y = F.conv2d(y, c.w, c.b.to(y.dtype), c.stride, c.w.shape[-1] // 2)
        return y.relu_() if (c.relu if relu is None else relu) else y

    y = normalize_input(x)
    for c in folded["stem"]:
        y = conv(y, c)
    y = F.max_pool2d(y, 2)
    feats = []
    for stage in folded["layers"]:
        for blk in stage:
            z = conv(conv(y, blk["conv1"]), blk["conv2"], relu=False)
            if blk["down"] is not None:
                y = conv(F.avg_pool2d(y, 2, 2, ceil_mode=True,
                                      count_include_pad=False), blk["down"])
            y = z.add_(y).relu_()
        feats.append(y)
    neck = folded["neck"]
    lat = [conv(f, c) for c, f in zip(neck["lateral"],
                                      feats[cfg.neck_start_level:])]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(
            lat[i], size=lat[i - 1].shape[2:], mode="nearest")
    inter = [conv(f, c) for c, f in zip(neck["fpn"], lat)]
    for i, c in enumerate(neck["downsample"]):
        inter[i + 1] = inter[i + 1] + conv(inter[i], c)
    feats = [inter[0]] + [conv(f, c) for c, f in zip(neck["pafpn"],
                                                      inter[1:])]
    out = {}
    for d, f in zip(folded["head"], feats):
        for c in d["tower"]:
            f = conv(f, c)
        for key in ("cls", "bbox", "kps"):
            if key in d:
                out.setdefault(key, []).append(conv(f, d[key]))
    return flatten_level_outputs(out, cfg.num_anchors)


@pytest.fixture(scope="module")
def model():
    m = dataclasses.asdict(CFG.model)
    frames = gen.frame_pool(5, 2, 96, 128, (1, 3), "cpu")
    sd = draw(m, frames, 5, 10, CFG.test.score_thr)
    net = SCRFD(CFG.model, device="cpu")
    net.load_state_dict(harness.port_state_dict(sd))
    return frames, net


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_reordered_trunk_equals_the_old_one(model, dtype):
    """The same operations on the CPU in the same order of sums (the
    bottom-up add's operands swapped, which IEEE addition does not
    notice): equal bit for bit, in f32 and in bf16."""
    frames, net = model
    x = torch.from_numpy(frames).to(dtype).permute(0, 3, 1, 2)
    folded = fold_scrfd(net, dtype)
    with torch.no_grad():
        got = scrfd_forward(folded, x, CFG.model)
        want = _old_scrfd_forward(folded, x, CFG.model)
    for k in want:
        assert got[k].dtype == dtype
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_a_detect_adds_16_shortcuts_and_36_relus_in_its_convs(
        model, monkeypatch):
    """Of a detect's 58 convs, 16 add a residual in their epilogue (12
    BasicBlock shortcuts, 2 bottom-up adds, 2 top-down adds of the level
    above, upsampled 2x) and 36 end in a ReLU: the counts the kernel's
    wrapper keeps on the card."""
    frames, net = model
    calls = []

    def plain(x, w, b, **kw):
        calls.append(kw)
        return conv_epi_plain(x, w, b, **kw)

    monkeypatch.setattr(scrfd_module, "conv_epi_plain", plain)
    det = Detector(CFG, net, device="cpu", dtype=torch.float32, fused=True)
    det.detect(frames[0], "AUTO", use_device_nms=True)
    assert len(calls) == 58
    assert sum(c["residual"] is not None for c in calls) == 16
    assert sum(c["residual"] is not None and c["upsample"] == 2
               for c in calls) == 2
    assert sum(c["relu"] for c in calls) == 36
