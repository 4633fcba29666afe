"""CIFAR-style ResNet18/34 (JAX ``models/resnet.py``), NCHW.

Convs are flax's ``nn.Conv(use_bias=False)`` with lax's ``SAME`` padding:
the stride-2 3x3 conv that opens stages 2-4 pads (0, 1) on an even side,
not (1, 1) (``models/pwc_net.py::same_pads``); the stride-2 1x1 shortcut
pads nothing.  :class:`BatchNorm` is flax's ``nn.BatchNorm`` (momentum
0.99, eps 1e-5, float32): in training it normalises by the batch's mean
and biased variance (E[x^2] - E[x]^2, clipped at 0) and folds that same
mean and variance into its running buffers, ``ra = 0.99 ra + 0.01 batch``,
where ``torch.nn.BatchNorm2d`` folds the unbiased variance at momentum 0.1.
The running buffers are JAX's ``batch_stats`` (``mean``, ``var``) and take
no gradient.  Train or evaluate with ``module.train()`` / ``.eval()``
(JAX's ``train`` argument).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .pwc_net import same_pads


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of (B, C, H, W) or (B, C):
    ``weight`` is flax's ``scale``, ``bias`` its ``bias``, the buffers
    ``running_mean`` and ``running_var`` its ``batch_stats``."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        axes = [0] + list(range(2, x.dim()))
        if self.training:
            mean = x.mean(dim=axes)
            var = torch.clamp(x.square().mean(dim=axes) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (k, k), strides=stride, feature_group_count=groups,
    use_bias=False)`` with lax's ``SAME`` padding, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        (t, b), (l, r) = (same_pads(n, self.stride, k) for n in x.shape[-2:])
        x, pad = x.to(self.dtype), t
        if not t == b == l == r:
            x, pad = F.pad(x, (l, r, t, b)), 0
        return F.conv2d(x, self.weight.to(self.dtype), None, self.stride, pad,
                        groups=self.groups)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype)
        self.bn2 = BatchNorm(planes)
        self.shortcut = (nn.Sequential(Conv(cin, planes, 1, stride, dtype=dtype),
                                       BatchNorm(planes))
                         if stride != 1 or cin != planes else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(y + x)


class ResNet(nn.Module):
    """``forward(x)`` gives the logits of (B, in_channels, H, W);
    ``features=True`` the 512-d global-average-pooled embedding instead
    (the trained feature extractor of ``utils/fid.py``)."""

    def __init__(self, num_blocks: Sequence[int], num_classes: int = 10, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = Conv(in_channels, 64, 3, dtype=dtype)
        self.bn1 = BatchNorm(64)
        layers, cin = [], 64
        for planes, n, first_stride in zip((64, 128, 256, 512), self.num_blocks, (1, 2, 2, 2)):
            for i in range(n):
                layers.append(BasicBlock(cin, planes, first_stride if i == 0 else 1, dtype))
                cin = planes
        self.layers = nn.ModuleList(layers)
        self.linear = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, features: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for block in self.layers:
            x = block(x)
        x = x.mean(dim=(2, 3))
        if features:
            return x
        return self.linear(x)


def ResNet18(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, in_channels)


def ResNet34(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, in_channels)


__all__ = ["BasicBlock", "BatchNorm", "Conv", "ResNet", "ResNet18", "ResNet34"]
