"""YuNet building blocks as nn.Modules, eval forward (NCHW / OIHW)
— counterpart of ``yunet_tpu/models/layers.py:252-335``.

ConvDPUnit is a 1x1 pointwise conv with bias, then a 3x3 *depthwise* conv
with bias, then optional BatchNorm + ReLU (reference
mmdet/models/utils/yunet_layer.py:4-36). Submodule names equal the
reference checkpoint keys, so a reference ``state_dict`` loads as it is.

Precision follows the JAX package: each conv runs in the input's dtype with
its weights cast to it (``layers.py:47``); eval BatchNorm computes in f32
and casts back (``layers.py:132-134``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default, used by every BN in the model


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv``'s convolution in x's dtype (weights cast to it)."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    stride=conv.stride, padding=conv.padding,
                    groups=conv.groups)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Running-stat BatchNorm computed in f32, cast back to x's dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight
    y = ((x.float() - bn.running_mean[:, None, None]) * inv[:, None, None]
         + bn.bias[:, None, None])
    return y.to(x.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(conv2d(x, self.conv1), self.conv2)
        if self.bn is not None:
            x = F.relu(batch_norm_eval(x, self.bn))
        return x


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(batch_norm_eval(conv2d(x, self.conv1), self.bn1))
        return self.conv2(x)


class Conv4LayerBlock(nn.Module):
    """Two ConvDPUnits (reference yunet_layer.py:65-82)."""

    def __init__(self, cin: int, cout: int, with_bn: bool = True):
        super().__init__()
        self.conv1 = ConvDPUnit(cin, cin, with_bn=True)
        self.conv2 = ConvDPUnit(cin, cout, with_bn=with_bn)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))
