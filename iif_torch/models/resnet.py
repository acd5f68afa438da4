"""ResNet v1.5: port of ``iif_tpu/models/resnet.py`` (``ResNet``,
``Bottleneck``, ``ResLayer``, the classifier constructors) with
torchvision's and mmdet's state_dict names (``conv1``, ``bn1``,
``layer{s}.{i}.conv{1,2,3}``, ``layer{s}.{i}.downsample.{0,1}``,
``layer{s}.{i}.se.fc{1,2}``, ``fc``).

As a detection trunk (``num_classes=None``) it returns its stage outputs;
as a classifier it pools them globally and applies the head of
``use_norm`` (``iif_torch/models/layers.py``), ``use_se`` adding the SE
block (r=16) after each block's last BatchNorm: the JAX factory's eleven
ImageNet classifiers, ``resnet18/34`` (``BasicBlock``),
``resnet50/101/152``, ``resnext50_32x4d`` / ``resnext101_32x8d`` and
``wide_resnet50_2`` / ``wide_resnet101_2`` (a grouped or wider 3x3 conv
in the bottleneck), ``se_resnet50`` and ``se_resnext50_32x4d``.

``num_stages=3`` is the C4 trunk (mmdet ``num_stages=3``): no ``layer4``,
three outputs. ``ResLayer`` is res5 run per RoI as the C4 shared head
(mmdet ``shared_heads/res_layer.py``, its blocks named ``layer4.{i}``).
Both keep the JAX package's v1.5 block, the stride on the 3x3 conv, not
the stride-on-conv1 caffe block of mmdet's C4 config.

Training follows the detection configs: ``frozen_stages`` freezes the stem
and the first stages (no gradient: their parameters do not require it and
their outputs are detached where the JAX package stops the gradient), and
``norm_eval=True`` keeps every BatchNorm on its running statistics while
its affine parameters train. Elsewhere a BatchNorm in training mode takes
its batch's statistics (``iif_torch/models/norm.py``: ``"bn"``, or
``"bn@G"`` with ``bn_groups=G``); ``train()`` leaves the stem and the
frozen stages, or with ``norm_eval`` every BatchNorm, on the running
statistics, as the JAX package's ``stage_train`` does.

Padding is explicit as in the JAX package: stem 7x7/2 pad 3, max-pool 3/2
pad 1, the stride on the 3x3 conv. Parameters stay f32; convolutions run
in ``compute_dtype`` (flax ``dtype=``), and BatchNorm takes its running
statistics in f32 and rounds its output back to the compute dtype, as
flax's BatchNorm does. Tensors are NCHW in ``channels_last`` memory.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.models.layers import SEBlock, make_classifier_head
from iif_torch.models.norm import batch_norm_train


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor,
                  dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Run ``conv`` with input, weight and bias cast to ``dtype`` (flax
    ``nn.Conv(dtype=...)``); ``None`` keeps f32 parameters and promotes."""
    if dtype is None:
        dtype = torch.promote_types(x.dtype, conv.weight.dtype)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in flax's op order. In eval mode on its running
    statistics: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32,
    rounded to the input dtype. In training mode on the batch's
    statistics (``batch_norm_train``; ``groups`` 0 for ``"bn"``, G for
    ``"bn@G"``), updating the running ones."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 groups: int = 0):
        super().__init__(num_features, eps=eps)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batch_norm_train(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.eps, self.groups)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) \
            * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _projection(inplanes: int, out: int, stride: int,
                bn_groups: int) -> nn.Sequential:
    """The shortcut's 1x1 conv and its BatchNorm (``downsample.0`` /
    ``.1``)."""
    return nn.Sequential(
        nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
        BatchNorm2d(out, 1e-5, bn_groups))


class BasicBlock(nn.Module):
    """JAX's ``BasicBlockV1``: two 3x3 convs, the stride on the first,
    the zero-initialised ``bn2`` (its scale), with ``use_se`` the SE
    block (r=16) after ``bn2``; the projection shortcut where the shape
    changes."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, compute_dtype=None,
                 use_se: bool = False, bn_groups: int = 0,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes, 1e-5, bn_groups)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes, 1e-5, bn_groups)
        self.se = SEBlock(planes, 16) if use_se else None
        self.downsample = (_projection(inplanes, planes, stride, bn_groups)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.relu(self.bn1(conv_in_dtype(self.conv1, x, dt)))
        out = self.bn2(conv_in_dtype(self.conv2, out, dt))
        if self.se is not None:
            out = self.se(out)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                conv_in_dtype(self.downsample[0], x, dt))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: stride on the 3x3 conv, which is
    grouped (``groups``) at width ``int(planes * base_width / 64) *
    groups`` (ResNeXt, the wide variants); with ``use_se`` the SE block
    (r=16) after ``bn3``. The SE block's f32 output promotes the residual
    sum to f32, as in JAX."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, compute_dtype=None,
                 use_se: bool = False, bn_groups: int = 0,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.compute_dtype = compute_dtype
        out = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width, 1e-5, bn_groups)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = BatchNorm2d(width, 1e-5, bn_groups)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, 1e-5, bn_groups)
        self.se = SEBlock(out, 16) if use_se else None
        self.downsample = (_projection(inplanes, out, stride, bn_groups)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.relu(self.bn1(conv_in_dtype(self.conv1, x, dt)))
        out = F.relu(self.bn2(conv_in_dtype(self.conv2, out, dt)))
        out = self.bn3(conv_in_dtype(self.conv3, out, dt))
        if self.se is not None:
            out = self.se(out)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                conv_in_dtype(self.downsample[0], x, dt))
        return F.relu(out + identity)


def _stage(inplanes: int, planes: int, n_blocks: int, stride: int,
           compute_dtype, use_se: bool = False, bn_groups: int = 0,
           block=None, groups: int = 1,
           base_width: int = 64) -> nn.Sequential:
    """One stage of ``block``s (default ``Bottleneck``), the first taking
    the stride and, where the shape changes, the projection shortcut."""
    block = block or Bottleneck
    blocks = []
    for i in range(n_blocks):
        first = i == 0
        downsample = first and (
            stride != 1 or inplanes != planes * block.expansion)
        blocks.append(block(inplanes, planes, stride if first else 1,
                            downsample, compute_dtype, use_se, bn_groups,
                            groups, base_width))
        inplanes = planes * block.expansion
    return nn.Sequential(*blocks)


class ResNet(nn.Module):
    """ResNet of ``block`` ``"bottleneck"`` (``groups`` and
    ``width_per_group`` set the 3x3 conv's width) or ``"basic"``. With
    ``num_classes=None`` a trunk returning its stage outputs (C2..C5, or
    C2..C4 with ``num_stages=3``); with ``num_classes`` a classifier:
    global average pool and the head of ``use_norm`` (named ``fc``)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 frozen_stages: int = -1, norm_eval: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 num_stages: int = 4, num_classes: Optional[int] = None,
                 use_norm: Optional[str] = None, use_se: bool = False,
                 bn_groups: int = 0, block: str = "bottleneck",
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.compute_dtype = compute_dtype
        self.num_stages = num_stages
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, 1e-5, bn_groups)
        block_cls = {"bottleneck": Bottleneck, "basic": BasicBlock}[block]
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512)[:num_stages], layers), start=1):
            self.add_module(f"layer{stage}", _stage(
                inplanes, planes, n_blocks, 1 if stage == 1 else 2,
                compute_dtype, use_se, bn_groups, block_cls, groups,
                width_per_group))
            inplanes = planes * block_cls.expansion
        self.fc = (None if num_classes is None
                   else make_classifier_head(inplanes, num_classes, use_norm))
        if frozen_stages >= 0:            # mmdet ResNet._freeze_stages
            for mod in [self.conv1, self.bn1] + [
                    getattr(self, f"layer{s}")
                    for s in range(1, frozen_stages + 1)]:
                mod.requires_grad_(False)

    def train(self, mode: bool = True) -> "ResNet":
        """Training mode, with the BatchNorms of the stem and the frozen
        stages (all of them under ``norm_eval``) on their running
        statistics."""
        super().train(mode)
        if mode:
            fixed = [self] if self.norm_eval else (
                [self.bn1] + [getattr(self, f"layer{s}") for s in range(
                    1, self.frozen_stages + 1)]
                if self.frozen_stages >= 0 else [])
            for mod in fixed:
                for m in mod.modules():
                    if isinstance(m, nn.BatchNorm2d):
                        m.train(False)
        return self

    def forward(self, x: torch.Tensor):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        out = F.relu(self.bn1(conv_in_dtype(self.conv1, x,
                                            self.compute_dtype)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        if self.frozen_stages >= 0:
            out = out.detach()
        feats = []
        for stage in range(1, self.num_stages + 1):
            out = getattr(self, f"layer{stage}")(out)
            if stage <= self.frozen_stages:
                out = out.detach()
            feats.append(out)
        if self.fc is None:
            return tuple(feats)
        return self.fc(out.mean((2, 3)))


class ResLayer(nn.Module):
    """res5 as a per-RoI trunk, the C4 shared head: ``n_blocks``
    bottlenecks of width 512 on the 1024-channel C4 features, under the
    name ``layer4``, the first with stride 2 and the projection shortcut
    (14x14 RoIs -> 7x7). Its BatchNorms run on their running statistics
    in flax's op order in f32, in training too (``norm_eval=True``, as
    the C4 config trains it): the convs and the BN affine parameters
    train, the statistics stay. BN statistics over a batch of RoIs
    (``norm_eval=False``, which no config sets) are not ported."""

    def __init__(self, n_blocks: int = 3, norm_eval: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_eval = norm_eval
        self.compute_dtype = compute_dtype
        self.layer4 = _stage(1024, 512, n_blocks, 2, compute_dtype)

    def train(self, mode: bool = True) -> "ResLayer":
        super().train(mode)
        if mode:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.train(False)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 1024, 14, 14) NCHW -> (R, 2048, 7, 7)."""
        if self.training and not self.norm_eval:
            raise NotImplementedError(
                "norm_eval=False (BatchNorm statistics over a batch of "
                "RoIs) is not ported")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.layer4(x)


# ------------------------------------------------------------ classifiers
def resnet18(num_classes: int = 1000, use_norm=None, **kw) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes=num_classes, use_norm=use_norm,
                  block="basic", **kw)


def resnet34(num_classes: int = 1000, use_norm=None, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, use_norm=use_norm,
                  block="basic", **kw)


def resnet50(num_classes: int = 1000, use_norm=None, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, use_norm=use_norm,
                  **kw)


def resnet101(num_classes: int = 1000, use_norm=None, **kw) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes=num_classes,
                  use_norm=use_norm, **kw)


def resnet152(num_classes: int = 1000, use_norm=None, **kw) -> ResNet:
    return ResNet((3, 8, 36, 3), num_classes=num_classes,
                  use_norm=use_norm, **kw)


def resnext50_32x4d(num_classes: int = 1000, use_norm=None,
                    **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, use_norm=use_norm,
                  groups=32, width_per_group=4, **kw)


def resnext101_32x8d(num_classes: int = 1000, use_norm=None,
                     **kw) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes=num_classes,
                  use_norm=use_norm, groups=32, width_per_group=8, **kw)


def wide_resnet50_2(num_classes: int = 1000, use_norm=None,
                    **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, use_norm=use_norm,
                  width_per_group=128, **kw)


def wide_resnet101_2(num_classes: int = 1000, use_norm=None,
                     **kw) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes=num_classes,
                  use_norm=use_norm, width_per_group=128, **kw)


def se_resnet50(num_classes: int = 1000, use_norm=None, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, use_norm=use_norm,
                  use_se=True, **kw)


def se_resnext50_32x4d(num_classes: int = 1000, use_norm=None,
                       **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, use_norm=use_norm,
                  groups=32, width_per_group=4, use_se=True, **kw)
