"""YuNet building blocks as nn.Modules (NCHW / OIHW) — counterpart of
``yunet_tpu/models/layers.py``.

ConvDPUnit is a 1x1 pointwise conv with bias, then a 3x3 *depthwise* conv
with bias, then optional BatchNorm + ReLU (reference
mmdet/models/utils/yunet_layer.py:4-36). Submodule names equal the
reference checkpoint keys, so a reference ``state_dict`` loads as it is.

Precision follows the JAX package: each conv runs in the input's dtype with
its weights cast to it (``layers.py:47``); BatchNorm computes in f32 and
casts back (``layers.py:88-134``).

Training mode is ``module.train()``. BatchNorm then normalizes with the
batch statistics (``batch_norm_train``, JAX's exact algebra) and updates
its running statistics in place under ``torch.no_grad()``, which takes the
place of the JAX ``new_state``. A conv bias that feeds train-mode BN
directly is detached (``bn_covered_bias``); its gradient is exactly zero
anyway, and the optimizer still decays it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convdp_train import fused_pw_dw

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default, used by every BN in the model
BN_MOMENTUM = 0.1  # running-stat update: new = (1-m)*old + m*batch


def library_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   **kw) -> torch.Tensor:
    """F.conv2d in x's dtype, except that a bf16 conv with one input and
    one output channel (the cls and obj branches' 3x3) runs in f32 on the
    bf16 values and is rounded to bf16 once. cuDNN 9.22 (PyTorch 2.11+cu128, H100) returns
    garbage for that bf16 conv at 20x20: up to 1.8e38 relative error and
    NaN in training, different from call to call; its f32 path is right
    (chip runs of this port). The JAX trunk accumulates in f32 as well."""
    w, b = w.to(x.dtype), b.to(x.dtype)
    if x.dtype == torch.bfloat16 and w.shape[0] == w.shape[1] == 1:
        return F.conv2d(x.float(), w.float(), b.float(), **kw).to(x.dtype)
    return F.conv2d(x, w, b, **kw)


def conv2d(x: torch.Tensor, conv: nn.Conv2d,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv``'s convolution in x's dtype (weights cast to it), with
    ``bias`` in place of conv.bias when given."""
    return library_conv2d(x, conv.weight,
                          conv.bias if bias is None else bias,
                          stride=conv.stride, padding=conv.padding,
                          groups=conv.groups)


def bn_covered_bias(conv: nn.Conv2d) -> torch.Tensor:
    """The bias of a conv whose output feeds BatchNorm directly, detached
    in training (JAX ``_bn_covered_bias``, layers.py:195-206): train-mode
    BN subtracts the batch mean, so dL/db is exactly 0."""
    return conv.bias.detach() if conv.training else conv.bias


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Running-stat BatchNorm computed in f32, cast back to x's dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight
    y = ((x.float() - bn.running_mean[:, None, None]) * inv[:, None, None]
         + bn.bias[:, None, None])
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     group_size: int = 0) -> torch.Tensor:
    """Train-mode BatchNorm over (N, H, W) with the JAX algebra
    (layers.py:81-128), computed in f32 and cast back to x's dtype.

    Single-pass statistics shifted by the running mean c (detached):
    mean = E[x-c] + c, var = max(E[(x-c)^2] - E[x-c]^2, 0) (biased, to
    normalize); the running variance takes the unbiased var*n/(n-1).
    ``group_size`` > 0 (and < N) is GhostBN: statistics per group of that
    many samples, running statistics averaged over the groups. The
    running mean and variance are updated in place under no_grad.
    (F.batch_norm takes two-pass statistics, which round differently.)"""
    n_b, c, h, w = x.shape
    g = group_size if 0 < group_size < n_b else n_b
    if n_b % g:
        raise ValueError(f"GhostBN group_size {g} does not divide batch "
                         f"{n_b}")
    ng = n_b // g
    xf = x.float()
    # a copy: the running mean is updated in place below
    shift = bn.running_mean.float().clone()[None, :, None, None]
    xg = (xf - shift).reshape(ng, g, c, h, w)
    mean_c = xg.mean(dim=(1, 3, 4))                       # (ng, C)
    mean_sq = torch.square(xg).mean(dim=(1, 3, 4))
    var = torch.clamp(mean_sq - torch.square(mean_c), min=0.0)
    mean = mean_c + shift[:, :, 0, 0]
    n = g * h * w
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        m = bn.momentum if bn.momentum is not None else BN_MOMENTUM
        bn.running_mean.copy_((1.0 - m) * bn.running_mean
                              + m * mean.mean(0))
        bn.running_var.copy_((1.0 - m) * bn.running_var
                             + m * unbiased.mean(0))
    inv = torch.rsqrt(var + bn.eps) * bn.weight               # (ng, C)
    bc = (slice(None), None, slice(None), None, None)
    y = (xf.reshape(ng, g, c, h, w) - mean[bc]) * inv[bc] + \
        bn.bias[None, :, None, None]
    return y.reshape(x.shape).to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d,
               group_size: int = 0) -> torch.Tensor:
    """Train-mode BN when ``bn`` is training, running-stat BN else."""
    if bn.training:
        return batch_norm_train(x, bn, group_size)
    return batch_norm_eval(x, bn)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, device="meta")


@torch.no_grad()
def init_conv(conv: nn.Conv2d, generator: Optional[torch.Generator]):
    """Xavier-normal weight, bias 0.02 (reference yunet_backbone.py:21-31).

    Draws on the generator's device, so the weights do not depend on the
    module's device. With no generator the weights are zero (a module
    that is about to be loaded from a checkpoint)."""
    w = conv.weight
    if generator is None:
        w.zero_()
    else:
        rf = w.shape[2] * w.shape[3]
        std = math.sqrt(2.0 / (w.shape[1] * rf + w.shape[0] * rf))
        w.copy_(torch.empty(w.shape, device=generator.device).normal_(
            0.0, std, generator=generator))
    conv.bias.fill_(0.02)


@torch.no_grad()
def init_bn(bn: nn.BatchNorm2d):
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.num_batches_tracked.zero_()


class ConvDPUnit(nn.Module):
    """pw 1x1 (+bias) -> dw 3x3 (+bias) [-> BN -> ReLU]."""

    def __init__(self, cin: int, cout: int, with_bn: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1, device="meta")
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, groups=cout,
                               device="meta")
        self.bn = _bn(cout) if with_bn else None

    def reset_parameters(self, generator: Optional[torch.Generator]):
        init_conv(self.conv1, generator)
        init_conv(self.conv2, generator)
        if self.bn is not None:
            init_bn(self.bn)

    def forward(self, x: torch.Tensor, bn_group: int = 0,
                fused: bool = False) -> torch.Tensor:
        """bn_group: the GhostBN group size in training (0: the batch).
        fused: pw + dw through the fused kernel pair (JAX
        ``conv_dp_unit(fused=True)``, layers.py:260-271)."""
        bd = (self.conv2.bias if self.bn is None
              else bn_covered_bias(self.conv2))
        if fused:
            x = self._fused_pw_dw(x, bd)
        else:
            x = conv2d(conv2d(x, self.conv1), self.conv2, bd)
        if self.bn is None:
            return x
        return F.relu(batch_norm(x, self.bn, bn_group))

    def _fused_pw_dw(self, x: torch.Tensor, bd: torch.Tensor
                     ) -> torch.Tensor:
        """``ops/convdp_train.py:fused_pw_dw`` on the NHWC view of x, with
        the f32 weights (JAX passes its raw params), returned as an NCHW
        view of the NHWC result. A channels-last x (the fused training
        path keeps the trunk so) needs no copy on the way in or out."""
        cout, cin = self.conv1.weight.shape[:2]
        w1 = self.conv1.weight.reshape(cout, cin).t().contiguous()
        wd = self.conv2.weight.reshape(cout, 9).t().contiguous()
        z = fused_pw_dw(x.permute(0, 2, 3, 1).contiguous(), w1,
                        self.conv1.bias, wd, bd)
        return z.permute(0, 3, 1, 2)


class ConvHead(nn.Module):
    """The stem: 3x3/s2 conv -> BN -> ReLU -> ConvDPUnit
    (reference yunet_layer.py:39-62)."""

    def __init__(self, cin: int, cmid: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cmid, 3, stride=2, padding=1,
                               device="meta")
        self.bn1 = _bn(cmid)
        self.conv2 = ConvDPUnit(cmid, cout, with_bn=True)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        init_conv(self.conv1, generator)
        init_bn(self.bn1)
        self.conv2.reset_parameters(generator)

    def forward(self, x: torch.Tensor, bn_group: int = 0,
                fused: bool = False) -> torch.Tensor:
        x = conv2d(x, self.conv1, bn_covered_bias(self.conv1))
        x = F.relu(batch_norm(x, self.bn1, bn_group))
        return self.conv2(x, bn_group, fused)


class Conv4LayerBlock(nn.Module):
    """Two ConvDPUnits (reference yunet_layer.py:65-82)."""

    def __init__(self, cin: int, cout: int, with_bn: bool = True):
        super().__init__()
        self.conv1 = ConvDPUnit(cin, cin, with_bn=True)
        self.conv2 = ConvDPUnit(cin, cout, with_bn=with_bn)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)

    def forward(self, x: torch.Tensor, bn_group: int = 0,
                fused: bool = False) -> torch.Tensor:
        return self.conv2(self.conv1(x, bn_group, fused), bn_group, fused)
