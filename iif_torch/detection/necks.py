"""FPN neck: port of ``iif_tpu/detection/necks.py::FPN`` with
``add_extra_convs=False`` (4 inputs, 5 outputs, the MaskRCNN
configuration), under mmdet's names ``lateral_convs.{i}.conv`` and
``fpn_convs.{i}.conv``.

The top-down path repeats each map x2 and crops to the finer map, as the
JAX package does (``necks.py:69-73``); on odd sizes that differs from
``F.interpolate(size=...)``. P6 is ``P5[:, :, ::2, ::2]`` (a 1x1 max-pool
of stride 2).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from iif_torch.models.resnet import conv_in_dtype


class ConvModule(nn.Module):
    """mmdet ``ConvModule`` without norm or activation: holds ``conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel,
                              padding=padding)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 compute_dtype=None):
        super().__init__()
        self.num_outs = num_outs
        self.compute_dtype = compute_dtype
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        dt = self.compute_dtype
        laterals = [conv_in_dtype(m.conv, x, dt)
                    for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            th, tw = laterals[i - 1].shape[2:]
            up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(
                2, dim=3)[:, :, :th, :tw]
            laterals[i - 1] = laterals[i - 1] + up
        outs = [conv_in_dtype(m.conv, x, dt)
                for m, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
