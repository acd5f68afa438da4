"""MaxIoU assignment: port of ``iif_tpu/ops/assigner.py::max_iou_assign``
(mmdet ``max_iou_assigner.py``), batched over images.

Returns mmdet's convention: -1 ignore, 0 negative, i+1 matched to gt i.
Padded gts count as IoU 0 (not -1), so an image without a valid gt makes
every box a negative, as mmdet's ``num_gt == 0`` branch does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from iif_torch.ops.boxes import bbox_overlaps


def max_iou_assign(
    boxes: torch.Tensor,        # (N, 4) or (B, N, 4) candidates
    gt_boxes: torch.Tensor,     # (B, G, 4) padded
    gt_valid: torch.Tensor,     # (B, G) bool
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.5,
    min_pos_iou: float = 0.0,
    match_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (assigned_gt_inds (B, N) int32, max_overlaps (B, N)).
    Low-quality matching is mmdet's ``gt_max_assign_all=True``; the SSD
    convention (``False``) is not ported."""
    iou = bbox_overlaps(boxes, gt_boxes)                       # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))

    max_overlaps, argmax_overlaps = iou.max(dim=2)   # first max on ties
    assigned = torch.full(max_overlaps.shape, -1, dtype=torch.int32,
                          device=iou.device)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr,
                           argmax_overlaps.to(torch.int32) + 1, assigned)

    if match_low_quality:
        # every box tying a gt's best IoU claims that gt; across gts the
        # last claiming one wins (the reference's in-order overwrite)
        gt_max = iou.amax(dim=1, keepdim=True)                  # (B, 1, G)
        claim = ((iou == gt_max) & (gt_max >= min_pos_iou)
                 & gt_valid[:, None, :])
        g_plus1 = torch.arange(1, gt_boxes.shape[1] + 1, dtype=torch.int32,
                               device=iou.device)
        last_claim = torch.where(claim, g_plus1, torch.zeros_like(g_plus1)
                                 ).amax(dim=2)
        assigned = torch.where(last_claim > 0, last_claim, assigned)
    return assigned, max_overlaps
