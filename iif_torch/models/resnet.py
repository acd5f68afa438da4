"""ResNet v1.5 trunk for detection: port of ``iif_tpu/models/resnet.py``
(``ResNet``, ``Bottleneck``, ``ResLayer``) with mmdet's state_dict names
(``conv1``, ``bn1``, ``layer{s}.{i}.conv{1,2,3}``,
``layer{s}.{i}.downsample.{0,1}``).

``num_stages=3`` is the C4 trunk (mmdet ``num_stages=3``): no ``layer4``,
three outputs. ``ResLayer`` is res5 run per RoI as the C4 shared head
(mmdet ``shared_heads/res_layer.py``, its blocks named ``layer4.{i}``).
Both keep the JAX package's v1.5 block, the stride on the 3x3 conv, not
the stride-on-conv1 caffe block of mmdet's C4 config.

Training follows the detection configs: ``frozen_stages`` freezes the stem
and the first stages (no gradient: their parameters do not require it and
their outputs are detached where the JAX package stops the gradient), and
``norm_eval=True`` keeps every BatchNorm on its running statistics while
its affine parameters train. BN batch statistics (``norm_eval=False``)
are not ported.

Padding is explicit as in the JAX package: stem 7x7/2 pad 3, max-pool 3/2
pad 1, the stride on the 3x3 conv. Parameters stay f32; convolutions run
in ``compute_dtype`` (flax ``dtype=``), and BatchNorm takes its running
statistics in f32 and rounds its output back to the compute dtype, as
flax's BatchNorm does. Tensors are NCHW in ``channels_last`` memory.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


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
    """BatchNorm on its running statistics in flax's op order: (x - mean)
    * (rsqrt(var + eps) * scale) + bias, in f32, rounded to the input
    dtype. The statistics never update (``norm_eval``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) \
            * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, eps=1e-5)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            BatchNorm2d(out, eps=1e-5)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.relu(self.bn1(conv_in_dtype(self.conv1, x, dt)))
        out = F.relu(self.bn2(conv_in_dtype(self.conv2, out, dt)))
        out = self.bn3(conv_in_dtype(self.conv3, out, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                conv_in_dtype(self.downsample[0], x, dt))
        return F.relu(out + identity)


def _stage(inplanes: int, planes: int, n_blocks: int, stride: int,
           compute_dtype) -> nn.Sequential:
    """One stage of bottlenecks, the first taking the stride and, where
    the shape changes, the projection shortcut."""
    blocks = []
    for i in range(n_blocks):
        first = i == 0
        downsample = first and (
            stride != 1 or inplanes != planes * Bottleneck.expansion)
        blocks.append(Bottleneck(inplanes, planes, stride if first else 1,
                                 downsample, compute_dtype))
        inplanes = planes * Bottleneck.expansion
    return nn.Sequential(*blocks)


class ResNet(nn.Module):
    """Bottleneck ResNet returning its stage outputs (C2..C5, or C2..C4
    with ``num_stages=3``)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 frozen_stages: int = -1, norm_eval: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 num_stages: int = 4):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.compute_dtype = compute_dtype
        self.num_stages = num_stages
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512)[:num_stages], layers), start=1):
            self.add_module(f"layer{stage}", _stage(
                inplanes, planes, n_blocks, 1 if stage == 1 else 2,
                compute_dtype))
            inplanes = planes * Bottleneck.expansion
        if frozen_stages >= 0:            # mmdet ResNet._freeze_stages
            for mod in [self.conv1, self.bn1] + [
                    getattr(self, f"layer{s}")
                    for s in range(1, frozen_stages + 1)]:
                mod.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self.training and not self.norm_eval:
            raise NotImplementedError(
                "norm_eval=False needs BatchNorm batch statistics, which "
                "are not ported")
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
        return tuple(feats)


class ResLayer(nn.Module):
    """res5 as a per-RoI trunk, the C4 shared head: ``n_blocks``
    bottlenecks of width 512 on the 1024-channel C4 features, under the
    name ``layer4``, the first with stride 2 and the projection shortcut
    (14x14 RoIs -> 7x7). Its BatchNorms run on their running statistics
    in flax's op order in f32, in training too (``norm_eval=True``, as
    the C4 config trains it): the convs and the BN affine parameters
    train, the statistics stay. Training with batch statistics
    (``norm_eval=False``) is not ported, as in ``ResNet``."""

    def __init__(self, n_blocks: int = 3, norm_eval: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_eval = norm_eval
        self.compute_dtype = compute_dtype
        self.layer4 = _stage(1024, 512, n_blocks, 2, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 1024, 14, 14) NCHW -> (R, 2048, 7, 7)."""
        if self.training and not self.norm_eval:
            raise NotImplementedError(
                "norm_eval=False needs BatchNorm batch statistics, which "
                "are not ported")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.layer4(x)
