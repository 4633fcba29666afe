"""MobileNetV2, the CIFAR variant (JAX ``models/mobilenet.py``), NCHW.

The depthwise 3x3 conv is flax's ``feature_group_count=planes``: torch's
``groups=planes``, its flax kernel (3, 3, 1, planes) stored as (planes, 1,
3, 3).  At stride 2 it pads by lax's ``SAME`` rule, (0, 1) on an even side,
as ResNet's convs do.  The residual is taken at stride 1 only.  BatchNorm
is flax's (``models/resnet.py::BatchNorm``)."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm, Conv

# (expansion, out_planes, num_blocks, stride)
_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 1),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class InvertedResidual(nn.Module):
    def __init__(self, in_planes: int, expansion: int, out_planes: int, stride: int):
        super().__init__()
        planes = expansion * in_planes
        self.stride = stride
        self.conv1 = Conv(in_planes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, groups=planes)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, out_planes, 1)
        self.bn3 = BatchNorm(out_planes)
        self.shortcut = (nn.Sequential(Conv(in_planes, out_planes, 1), BatchNorm(out_planes))
                         if stride == 1 and in_planes != out_planes else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.stride == 1:
            y = y + (x if self.shortcut is None else self.shortcut(x))
        return y


class MobileNetV2(nn.Module):
    """Logits of (B, in_channels, H, W)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 32, 3)
        self.bn1 = BatchNorm(32)
        layers, cin = [], 32
        for expansion, out_planes, num_blocks, stride in _CFG:
            for i in range(num_blocks):
                layers.append(InvertedResidual(cin, expansion, out_planes,
                                               stride if i == 0 else 1))
                cin = out_planes
        self.layers = nn.ModuleList(layers)
        self.conv2 = Conv(cin, 1280, 1)
        self.bn2 = BatchNorm(1280)
        self.linear = nn.Linear(1280, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        for block in self.layers:
            x = block(x)
        x = F.relu(self.bn2(self.conv2(x)))
        return self.linear(x.mean(dim=(2, 3)))


__all__ = ["InvertedResidual", "MobileNetV2"]
