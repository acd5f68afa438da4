"""CIFAR ResNet-s (He et al., option-A shortcuts): port of
``iif_tpu/models/resnet_cifar.py``: ResNet-20/32/44/56/110/1202 and
SE-ResNet-32 (SE r=4 after ``bn2``), a 3x3 stem to 16 channels, three
stages of widths 16, 32, 64 with strides 1, 2, 2, global average pool and
the head of ``use_norm`` (named ``linear``). State-dict names are the
reference's: ``conv1``, ``bn1``, ``layer{s}.{i}.{conv,bn}{1,2}``,
``layer{s}.{i}.se.fc{1,2}``, ``linear``.

The option-A shortcut subsamples by 2 and zero-pads the channels by
``planes // 4`` on each side (dim 1 in NCHW). Parameters stay f32;
convolutions run in ``compute_dtype`` and BatchNorm rounds to it, as in
``iif_torch/models/resnet.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.models.layers import SEBlock, make_classifier_head
from iif_torch.models.resnet import BatchNorm2d, conv_in_dtype


def option_a_shortcut(x: torch.Tensor, planes: int) -> torch.Tensor:
    pad = planes // 4
    return F.pad(x[:, :, ::2, ::2], (0, 0, 0, 0, pad, pad))


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_se: bool = False, bn_groups: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.planes = planes
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes, 1e-5, bn_groups)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes, 1e-5, bn_groups)
        self.se = SEBlock(planes, 4) if use_se else None
        self.shortcut = stride != 1 or in_planes != planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.relu(self.bn1(conv_in_dtype(self.conv1, x, dt)))
        out = self.bn2(conv_in_dtype(self.conv2, out, dt))
        if self.se is not None:
            out = self.se(out)
        short = option_a_shortcut(x, self.planes) if self.shortcut else x
        return F.relu(out + short)


class ResNetS(nn.Module):
    def __init__(self, num_blocks: Sequence[int] = (5, 5, 5),
                 num_classes: int = 10, use_norm: Optional[str] = None,
                 use_se: bool = False, bn_groups: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(16, 1e-5, bn_groups)
        in_planes = 16
        for stage, (planes, stride) in enumerate(
                zip((16, 32, 64), (1, 2, 2)), start=1):
            blocks = []
            for i in range(num_blocks[stage - 1]):
                blocks.append(BasicBlock(in_planes, planes,
                                         stride if i == 0 else 1, use_se,
                                         bn_groups, compute_dtype))
                in_planes = planes
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.linear = make_classifier_head(64, num_classes, use_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(dt)
        out = F.relu(self.bn1(conv_in_dtype(self.conv1, x, dt)))
        out = self.layer3(self.layer2(self.layer1(out)))
        return self.linear(out.mean((2, 3)))


def resnet20(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((3, 3, 3), num_classes, use_norm, **kw)


def resnet32(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((5, 5, 5), num_classes, use_norm, **kw)


def se_resnet32(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((5, 5, 5), num_classes, use_norm, use_se=True, **kw)


def resnet44(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((7, 7, 7), num_classes, use_norm, **kw)


def resnet56(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((9, 9, 9), num_classes, use_norm, **kw)


def resnet110(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((18, 18, 18), num_classes, use_norm, **kw)


def resnet1202(num_classes=10, use_norm=None, **kw) -> ResNetS:
    return ResNetS((200, 200, 200), num_classes, use_norm, **kw)
