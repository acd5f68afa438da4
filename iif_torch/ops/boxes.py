"""Box primitives: pairwise IoU and the delta (dx, dy, dw, dh) coder.

Port of ``iif_tpu/ops/boxes.py`` (``bbox_overlaps``, ``bbox2delta``,
``delta2bbox``), the mmdet ``delta_xywh_bbox_coder`` semantics. Boxes are (x1, y1, x2, y2) in
pixels. ``bbox_overlaps`` takes leading batch dimensions.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise IoU, (..., N, M)."""
    area1 = ((boxes1[..., 2] - boxes1[..., 0])
             * (boxes1[..., 3] - boxes1[..., 1]))
    area2 = ((boxes2[..., 2] - boxes2[..., 0])
             * (boxes2[..., 3] - boxes2[..., 1]))
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode gt boxes as deltas with respect to proposals (regression
    targets), (..., 4)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]

    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]

    dx = (gx - px) / torch.clamp(pw, min=1e-6)
    dy = (gy - py) / torch.clamp(ph, min=1e-6)
    dw = torch.log(torch.clamp(gw, min=1e-6) / torch.clamp(pw, min=1e-6))
    dh = torch.log(torch.clamp(gh, min=1e-6) / torch.clamp(ph, min=1e-6))
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means) / stds


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
               max_shape: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """Decode deltas into boxes. ``deltas`` may be (..., 4) or (..., C*4)
    (per-class regression); rois broadcast accordingly. dw, dh are clipped
    at |log(16 / 1000)| (mmdet's ``wh_ratio_clip``)."""
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    shape = deltas.shape
    deltas = deltas.reshape(shape[:-1] + (-1, 4))
    d = deltas * stds + means
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    max_ratio = abs(math.log(16.0 / 1000.0))
    dw = torch.clamp(dw, -max_ratio, max_ratio)
    dh = torch.clamp(dh, -max_ratio, max_ratio)

    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy

    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if max_shape is not None:
        h, w = max_shape
        x1 = torch.clamp(x1, 0, w)
        y1 = torch.clamp(y1, 0, h)
        x2 = torch.clamp(x2, 0, w)
        y2 = torch.clamp(y2, 0, h)
    out = torch.stack([x1, y1, x2, y2], dim=-1)
    return out.reshape(shape)
