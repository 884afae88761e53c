"""A conv whose epilogue adds the bias, an optional shortcut and an
optional ReLU: SCRFD's and RetinaFace's folded convs
(``models/scrfd.py:scrfd_conv``, ``models/retinaface.py:retinaface_conv``).

``conv_epi(x, w, wp, b, stride=, relu=, residual=None, upsample=1,
post_add=False, out=None)`` takes x as (N, Cin, H, W) in channels-last
memory, w OIHW, its packed form wp (``pack_weights``) and the bias b in
f32, and returns ``[relu](conv2d(x, w, b, stride, padding=k // 2) +
up(residual))`` as (N, Cout, Ho, Wo) channels-last in x's dtype, where
``up`` repeats each pixel of a residual of (Ho / upsample, Wo / upsample)
upsample x upsample times (``F.interpolate``'s nearest mode at an integer
scale). With ``post_add`` the shortcut is added after the ReLU:
``[relu](conv2d(x, w, b, ...)) + up(residual)`` (RetinaFace's FPN adds
its laterals after their ReLU). ``out``, where given, is where the result
goes: an (N, Cout, Ho, Wo) view of a wider NHWC map, its channels
consecutive (a channel slice of a wider map, such as one branch of
RetinaFace's SSH concatenation, or a run of pixels of a longer one);
``out`` is then returned.

A CUDA tensor goes to the hand-written kernel of ``csrc/scrfd_conv.cu``
(bf16 only: an implicit-GEMM conv on the tensor cores from a staged input
halo, f32 sums, the epilogue before one rounding to bf16; its block tile
from ``tiles``, or for a wide conv the fastest of ``candidates``, timed on
the card at the shape's first call outside a graph capture); anything else
on CUDA raises. A CPU tensor goes to
``conv_epi_plain``, the same function in plain PyTorch in x's dtype (each
of the conv, the shortcut add and the ReLU rounded to it, as the library
route on the card rounds).

The kernel counts its launches in ``conv_epi.launches``, and those with a
shortcut, with a ReLU, with the shortcut after the ReLU and into a given
``out`` in ``.launches_residual``, ``.launches_relu``,
``.launches_post_add`` and ``.launches_sliced``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "scrfd_conv.cu")
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS,
    cuda_signatures(yunet_scrfd_conv_forward=[_P] * 5 + [_I] * 13
                    + [ctypes.c_longlong] + [_I] * 5 + [_P]))

SMS = 132                                  # an H100 SXM's multiprocessors
TILE_N = (1, 3, 4, 7, 8, 10, 11, 14, 16)   # n8 tiles a block, as built
BIG_MAP = 320 * 320     # output pixels from which a block takes all of Cout
MAX_SMEM = 200 * 1024   # csrc/scrfd_conv.cu's kMaxSmem
# the warps of a wide conv's candidate tiles: wm x wk, 4 or 8 in all
WARPS = [(wm, wk) for wm in (1, 2, 4, 8) for wk in (1, 2, 4, 8)
         if wm * wk in (4, 8)]
TUNE_REPS = 4           # launches a candidate tile is timed over
# device cycles spun before the timed launches (~5 ms), so that the host
# queues them all before the first runs and its pace does not time them
TUNE_SPIN = 10_000_000


def padded_channels(cin: int) -> int:
    """Each tap's channels in the packed weights: Cin rounded up to 8."""
    return -(-cin // 8) * 8


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights -> (Cout, k * k * cp) bf16, K-major rows an output
    channel: tap by tap (row-major over the kernel window), each tap's
    Cin channels zero-padded to cp = ``padded_channels(Cin)``."""
    cout, cin, kh, kw = w.shape
    taps = w.permute(0, 2, 3, 1).float()             # (O, kh, kw, I)
    taps = F.pad(taps, (0, padded_channels(cin) - cin))
    return taps.reshape(cout, -1).to(torch.bfloat16).contiguous()


def unpack_weights(wp: torch.Tensor, cin: int, k: int) -> torch.Tensor:
    """``pack_weights``' inverse: (Cout, k * k * cp) -> OIHW f32."""
    taps = wp.float().reshape(wp.shape[0], k, k, padded_channels(cin))
    return taps[..., :cin].permute(0, 3, 1, 2).contiguous()


def _out_hw(x: torch.Tensor, w: torch.Tensor, stride: int
            ) -> Tuple[int, int]:
    k = w.shape[-1]
    return tuple((s + 2 * (k // 2) - k) // stride + 1 for s in x.shape[2:])


def _check(x, w, b, stride, residual, upsample, post_add, out):
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1] \
            or w.shape[2] != w.shape[3] or w.shape[2] % 2 == 0:
        raise ValueError(f"conv_epi: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (N, Cin, H, W) and an "
                         "odd square OIHW kernel")
    if b.shape != (w.shape[0],):
        raise ValueError(f"conv_epi: bias {tuple(b.shape)} for "
                         f"{w.shape[0]} channels")
    ho, wo = _out_hw(x, w, stride)
    if residual is not None:
        want = (x.shape[0], w.shape[0], ho // upsample, wo // upsample)
        if ho % upsample or wo % upsample or tuple(residual.shape) != want:
            raise ValueError(f"conv_epi: residual {tuple(residual.shape)} "
                             f"is not {want} upsampled {upsample}x to the "
                             f"output's ({ho}, {wo})")
    elif post_add:
        raise ValueError("conv_epi: post_add without a residual")
    if out is not None and (
            tuple(out.shape) != (x.shape[0], w.shape[0], ho, wo)
            or out.dtype != x.dtype or out.device != x.device):
        raise ValueError(f"conv_epi: out {tuple(out.shape)} {out.dtype} is "
                         f"not ({x.shape[0]}, {w.shape[0]}, {ho}, {wo}) "
                         f"{x.dtype} on {x.device}")


def _out_pitch(out: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(pixel pitch, image pitch) in elements of an (N, C, H, W) view whose
    C channels are consecutive and whose pixels lie a fixed pitch apart,
    row after row; None for another layout."""
    n, c, h, w = out.shape
    sn, sc, sh, sw = out.stride()
    if (sc != 1 and c > 1) or sw < c or (h > 1 and sh != w * sw) \
            or (n > 1 and sn < h * w * sw):
        return None
    return sw, (sn if n > 1 else h * w * sw)


def conv_epi_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   stride: int, relu: bool,
                   residual: Optional[torch.Tensor] = None,
                   upsample: int = 1, post_add: bool = False,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``F.conv2d`` with w and b in x's dtype, + the
    residual (nearest-upsampled to the output's size), then ReLU (the
    ReLU first with post_add); copied into ``out`` where given."""
    _check(x, w, b, stride, residual, upsample, post_add, out)
    y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride, w.shape[-1] // 2)
    if residual is not None and upsample != 1:
        residual = F.interpolate(residual, size=y.shape[2:], mode="nearest")
    if residual is not None and not post_add:
        y.add_(residual)
    if relu:
        y.relu_()
    if residual is not None and post_add:
        y.add_(residual)
    return y if out is None else out.copy_(y)


def smem_bytes(nt: int, wm: int, wk: int, tw: int, kc: int, k: int,
               stride: int, cin: int) -> int:
    """The least shared memory a block of the kernel takes, in bytes
    (``csrc/scrfd_conv.cu:smem_bytes`` with a ring of two chunk stages, or
    one where the conv has one chunk)."""
    th = 32 * wm // tw
    hr, hc = (th - 1) * stride + k, (tw - 1) * stride + k
    stages = min(2, -(-padded_channels(cin) // kc))
    ring = stages * 2 * (hr * hc * (kc + 8) + 8 * nt * (k * k * kc + 8))
    red = wk * wm * 32 * 2 * nt * 4 * 4 if wk > 1 else 0
    row = 8 * nt + (16 if nt & 1 else 8)
    return (-(-hr * hc * 4 // 16) * 16 + 8 * nt * 4 + 32 * wm * row * 2
            + max(ring, red))


@functools.lru_cache(maxsize=None)
def tiles(n: int, ho: int, wo: int, cin: int, cout: int, k: int,
          stride: int = 1) -> Tuple[int, int, int, int, int]:
    """(nt, wm, wk, tw, kc) of the kernel's block for a conv of n images
    to ho x wo outputs, cin -> cout channels, k x k at ``stride``: 8 * nt
    output channels, an output tile of 32 * wm pixels tw wide, wm x wk
    warps (wk splitting the taps), input channel chunks of kc.

    A wide conv (``wide``: RetinaFace's) takes the rule of
    ``_wide_tiles``; on the card ``conv_epi`` times ``candidates`` in its
    place. Else (SCRFD-10GF-KPS's widths;
    stride unread): all of Cout up to 112 on a map of BIG_MAP pixels or
    more, elsewhere 32 where Cout has more, in as many block columns as
    it takes; a tile 8 wide up to 80 columns, 16 above; the largest tile
    that still gives about one block an SM; 8 warps; kc 64 for 33 to 64
    channels, 16 up to 16, else 32. Chosen by a sweep of every tile over
    SCRFD-10GF-KPS's convs at 640x640 on an H100."""
    if wide(cin, cout):
        return _wide_tiles(n, ho, wo, cin, cout, k, stride)
    cp = padded_channels(cin)
    kc = 16 if cp <= 16 else 64 if 32 < cp <= 64 else 32
    tw = 8 if wo <= 80 else 16
    need = -(-cout // 8)
    if ho * wo >= BIG_MAP and need <= 14:
        nt = next(t for t in (1, 3, 4, 7, 10, 11, 14) if t >= need)
    else:
        nt = 1 if cout <= 8 else 3 if cout <= 24 else 4
    return (nt, *_warps(n, ho, wo, cout, nt, tw, 3 * SMS // 4), tw, kc)


def wide(cin: int, cout: int) -> bool:
    """Whether a conv is wide: Cout a multiple of 64, or Cin 256 or more
    (RetinaFace's convs; none of SCRFD-10GF-KPS's, whose tiles ``tiles``'
    own rule keeps)."""
    return cout % 64 == 0 or cin >= 256


def candidates(n: int, ho: int, wo: int, cin: int, cout: int, k: int,
               stride: int = 1) -> list:
    """The tiles a wide conv is timed over: 8 * nt output channels a block
    column (nt 4, 8 or 16, no wider than Cout needs), the
    warps of WARPS, an output tile 8 or 16 pixels wide, input channel
    chunks of 32 or 64 (16 for an input of up to 16 channels), less those
    whose shared memory the kernel would refuse; the rule's tile
    (``tiles``) first."""
    rule = tiles(n, ho, wo, cin, cout, k, stride)
    nts = [t for t in (4, 8, 16) if 8 * t <= max(cout, 32)]
    kcs = (16,) if padded_channels(cin) <= 16 else (32, 64)
    out = [rule]
    for nt, (wm, wk), tw, kc in itertools.product(nts, WARPS, (8, 16), kcs):
        tile = (nt, wm, wk, tw, kc)
        if tile != rule and 32 * wm % tw == 0 and smem_bytes(
                nt, wm, wk, tw, kc, k, stride, cin) <= MAX_SMEM:
            out.append(tile)
    return out


def _warps(n: int, ho: int, wo: int, cout: int, nt: int, tw: int,
           blocks: int) -> Tuple[int, int]:
    """(wm, wk): the largest output tile (32 * wm pixels) that still gives
    at least ``blocks`` blocks, 8 warps in all."""
    cols = -(-cout // (8 * nt))
    for wm in (8, 4, 2, 1):
        tiles_ = -(-ho // (32 * wm // tw)) * -(-wo // tw)
        if 32 * wm >= tw and n * tiles_ * cols >= blocks:
            break
    return wm, 8 // wm


def _wide_tiles(n: int, ho: int, wo: int, cin: int, cout: int, k: int,
                stride: int) -> Tuple[int, int, int, int, int]:
    """A wide conv's tile where it is not timed (on the CPU, and at a
    first call inside a graph capture): 128 output channels a block column
    for a strided 1x1, else 32; 8 warps; a tile 8 wide up to 80 columns,
    16 above; the largest output tile (``_warps``) and then the next
    smaller ones, each with input channel chunks of 64, else 32 (16 for an
    input of up to 16 channels): the first that fits the shared memory.
    Its tiles sum to 1.729 ms a RetinaFace-R50 forward at 640x640 and
    1.534 at 480x640 on an H100, where the timed picks sum to 1.500 and
    1.374 (PERF.md); a rule fitted to one canvas's sweep lost 23% at the
    other."""
    nt = 16 if k == 1 and stride > 1 else 4
    tw = 8 if wo <= 80 else 16
    wm = _warps(n, ho, wo, cout, nt, tw, 3 * SMS // 4)[0]
    while wm:
        for kc in (16,) if padded_channels(cin) <= 16 else (64, 32):
            if smem_bytes(nt, wm, 8 // wm, tw, kc, k, stride,
                          cin) <= MAX_SMEM:
                return nt, wm, 8 // wm, tw, kc
        wm //= 2
    raise ValueError(f"conv_epi: no block of the kernel fits a {k}x{k}/"
                     f"{stride} conv {cin} -> {cout}")


def conv_epi(x: torch.Tensor, w: torch.Tensor, wp: torch.Tensor,
             b: torch.Tensor, *, stride: int, relu: bool,
             residual: Optional[torch.Tensor] = None,
             upsample: int = 1, post_add: bool = False,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (N, Cin, H, W) channels-last -> (N, Cout, Ho, Wo) channels-last
    in x's dtype, or ``out``."""
    if x.device.type == "cpu":
        return conv_epi_plain(x, w, b, stride=stride, relu=relu,
                              residual=residual, upsample=upsample,
                              post_add=post_add, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"conv_epi: no kernel for {x.device}")
    _check(x, w, b, stride, residual, upsample, post_add, out)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv_epi: x must be bf16, not {x.dtype}")
    n, cin, h, wd = x.shape
    cout, k = w.shape[0], w.shape[-1]
    kdim = k * k * padded_channels(cin)
    cl = torch.channels_last
    checks = [("x", x, torch.bfloat16, x.is_contiguous(memory_format=cl)),
              ("wp", wp, torch.bfloat16, wp.is_contiguous()
               and tuple(wp.shape) == (cout, kdim)),
              ("b", b, torch.float32, b.is_contiguous())]
    if residual is not None:
        checks.append(("residual", residual, torch.bfloat16,
                       residual.is_contiguous(memory_format=cl)))
    ho, wo = _out_hw(x, w, stride)
    sliced = out is not None
    if not sliced:
        out = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device,
                          memory_format=cl)
        pitch = (cout, ho * wo * cout)
    else:
        pitch = _out_pitch(out)
        checks.append(("out", out, torch.bfloat16, pitch is not None))
    for name, t, dt, ok in checks:
        if t.device != x.device or t.dtype != dt or not ok \
                or t.data_ptr() % 16:
            raise ValueError(f"conv_epi: {name} must be {dt}, contiguous "
                             f"(x and residual channels-last; wp "
                             f"({cout}, {kdim}); out a view of an NHWC map "
                             f"with its channels consecutive) and 16-byte "
                             f"aligned on {x.device}")
    if out.numel():
        lib = LIB.get()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream

            def launch(tile):
                return lib.yunet_scrfd_conv_forward(
                    x.data_ptr(), wp.data_ptr(), b.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    out.data_ptr(), n, h, wd, cin, k, stride, ho, wo, cout,
                    upsample, int(relu), int(post_add), *pitch, *tile,
                    stream)

            code = launch(_pick_tile(x.device.index,
                                     (n, ho, wo, cin, cout, k, stride),
                                     launch))
        check_cuda_status(lib, code, "conv_epi")
        conv_epi.launches += 1
        conv_epi.launches_residual += int(residual is not None)
        conv_epi.launches_relu += int(relu)
        conv_epi.launches_post_add += int(post_add)
        conv_epi.launches_sliced += int(sliced)
    return out


# a wide conv's tile on the card, by (device, shape), from its first call
_TUNED = {}


def _pick_tile(device: int, shape: tuple, launch) -> tuple:
    """The block tile for a conv of ``shape`` (n, ho, wo, cin, cout, k,
    stride) on CUDA device ``device``, where ``launch(tile)`` issues it on
    the current stream and returns the kernel's status: ``tiles``' for a
    conv that is not wide; for a wide one, the fastest of ``candidates``
    (``_tune``) at the shape's first call, then that tile again. Inside a
    graph capture an untimed shape takes ``tiles``' and is timed later
    (a capture cannot be synchronized)."""
    if not wide(shape[3], shape[4]):
        return tiles(*shape)
    tile = _TUNED.get((device, shape))
    if tile is None:
        if torch.cuda.is_current_stream_capturing():
            return tiles(*shape)
        tile = _TUNED[(device, shape)] = _tune(candidates(*shape), launch)
    return tile


def _tune(tiles_: list, launch) -> tuple:
    """The fastest of ``tiles_`` on the card: behind a spin of the device
    (TUNE_SPIN cycles), each tile launched once and then TUNE_REPS times
    between two CUDA events, all read after one synchronize. A tile the
    kernel refuses is skipped. The launches write the conv's output each
    time, which the call's own launch then writes again."""
    marks = []
    torch.cuda._sleep(TUNE_SPIN)
    for tile in tiles_:
        if launch(tile):
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TUNE_REPS):
            launch(tile)
        end.record()
        marks.append((tile, start, end))
    torch.cuda.synchronize()
    if not marks:                   # the call's own launch reports why
        return tiles_[0]
    return min(marks, key=lambda m: m[1].elapsed_time(m[2]))[0]


# every launch, and those with a shortcut, with a ReLU, with the shortcut
# after the ReLU, and into a given out
conv_epi.launches = 0
conv_epi.launches_residual = 0
conv_epi.launches_relu = 0
conv_epi.launches_post_add = 0
conv_epi.launches_sliced = 0
