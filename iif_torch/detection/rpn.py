"""RPN head, its training loss and fixed-shape proposal generation: port
of ``iif_tpu/detection/rpn.py`` (``RPNHead``, ``rpn_loss``,
``rpn_proposals``), mmdet's ``rpn_head.py`` and ``anchor_head.py``.

The head runs on NCHW (channels_last) maps and hands back NHWC views, so
``rpn_proposals`` sees the JAX package's (B, H, W, A) / (B, H, W, 4A)
layout and flattens anchors in the same (H, W, A) order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.ops.assigner import max_iou_assign
from iif_torch.ops.boxes import bbox2delta, delta2bbox
from iif_torch.ops.nms import _take, nms, top_k
from iif_torch.ops.sampler import random_sample_pos_neg


class RPNHead(nn.Module):
    """mmdet names: ``rpn_conv`` (3x3, in the compute dtype), ``rpn_cls``
    and ``rpn_reg`` (1x1, f32 on the upcast trunk output, as flax promotes
    to its f32 parameters)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """feats: NCHW maps -> per level (B, H, W, A) objectness logits and
        (B, H, W, 4A) deltas, both f32."""
        from iif_torch.models.resnet import conv_in_dtype

        cls_scores, bbox_preds = [], []
        for x in feats:
            t = F.relu(conv_in_dtype(self.rpn_conv, x, self.compute_dtype))
            t = t.float()
            cls_scores.append(self.rpn_cls(t).permute(0, 2, 3, 1))
            bbox_preds.append(self.rpn_reg(t).permute(0, 2, 3, 1))
        return cls_scores, bbox_preds


def bce_with_logits(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE in the JAX package's stable form."""
    return (torch.clamp(x, min=0) - x * labels
            + torch.log1p(torch.exp(-torch.abs(x))))


def rpn_loss(
    cls_scores: Sequence[torch.Tensor],
    bbox_preds: Sequence[torch.Tensor],
    anchors: torch.Tensor,        # (A_tot, 4) concatenated over levels
    valid_mask: torch.Tensor,     # (A_tot,) anchors inside the image
    gt_boxes: torch.Tensor,       # (B, G, 4) padded
    gt_valid: torch.Tensor,       # (B, G)
    num_samples: int = 256,
    pos_fraction: float = 0.5,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_cls, loss_bbox): MaxIoU assignment (pos 0.7, neg 0.3,
    low-quality 0.3), BCE objectness on the sampled anchors and L1 on the
    positives' deltas, both over the batch's count of valid samples
    (``rpn.py:66-111``). ``noise`` = the sampler's (pos, neg) uniform
    draws, each (B, A_tot); else drawn from ``generator``."""
    b = cls_scores[0].shape[0]
    scores = torch.cat([s.reshape(b, -1) for s in cls_scores], 1)
    deltas = torch.cat([d.reshape(b, -1, 4) for d in bbox_preds], 1)
    assigned, _ = max_iou_assign(anchors, gt_boxes, gt_valid, 0.7, 0.3,
                                 0.3)
    assigned = torch.where(valid_mask[None, :], assigned,
                           torch.full_like(assigned, -1))
    pos_noise, neg_noise = noise if noise is not None else (None, None)
    inds, is_pos, sample_valid = random_sample_pos_neg(
        assigned, num_samples, pos_fraction, pos_noise, neg_noise, generator)
    labels = is_pos.float()
    w = sample_valid.float()
    s = torch.gather(scores, 1, inds)
    loss_cls = (bce_with_logits(s, labels) * w).sum()

    gt_idx = torch.clamp(torch.gather(assigned, 1, inds).long() - 1, 0,
                         gt_boxes.shape[1] - 1)
    tgt = bbox2delta(anchors[inds], _take(gt_boxes, gt_idx))
    l1 = torch.abs(_take(deltas, inds) - tgt).sum(-1)
    loss_bbox = (l1 * labels * w).sum()
    denom = torch.clamp(w.sum(), min=1.0)
    return loss_cls / denom, loss_bbox / denom


def rpn_proposals(
    cls_scores: Sequence[torch.Tensor],
    bbox_preds: Sequence[torch.Tensor],
    anchors_per_level: Sequence[torch.Tensor],
    img_shape: Tuple[int, int],
    nms_pre: int = 1000,
    max_per_img: int = 1000,
    nms_iou: float = 0.7,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (proposals (B, P, 4), scores (B, P), valid (B, P)),
    P = max_per_img.

    NMS runs per level (mmdet's level-aware ``batched_nms`` never crosses
    levels), after dropping empty boxes (``min_bbox_size=0``). Candidates
    per level are an exact top-``nms_pre``; the JAX package's
    ``approx_max_k`` is a TPU shortcut that is exact on a CPU."""
    b = cls_scores[0].shape[0]
    neg_inf = float("-inf")
    out_boxes, out_scores = [], []
    for s, d, anc in zip(cls_scores, bbox_preds, anchors_per_level):
        s = torch.sigmoid(s.reshape(b, -1).float())
        d = d.reshape(b, -1, 4)
        k = min(nms_pre, s.shape[1])
        top_s, top_i = top_k(s, k)
        sel_anc = anc[top_i]                                  # (B, k, 4)
        sel_d = _take(d, top_i)
        boxes = delta2bbox(sel_anc, sel_d, max_shape=img_shape)
        ok = ((boxes[..., 2] > boxes[..., 0])
              & (boxes[..., 3] > boxes[..., 1]))
        top_s = torch.where(ok, top_s, torch.full_like(top_s, neg_inf))
        keep, order = nms(boxes, top_s, nms_iou)
        out_boxes.append(_take(boxes, order))
        out_scores.append(torch.where(keep, _take(top_s, order),
                                      torch.full_like(top_s, neg_inf)))

    boxes = torch.cat(out_boxes, 1)          # (B, sum k_l, 4)
    scores = torch.cat(out_scores, 1)        # survivors only finite
    k_out = min(max_per_img, scores.shape[1])
    top_s, top_i = top_k(scores, k_out)
    valid = torch.isfinite(top_s)
    out_b = torch.where(valid[..., None], _take(boxes, top_i),
                        torch.zeros((), device=boxes.device))
    out_s = torch.where(valid, top_s, torch.zeros((), device=boxes.device))
    if k_out < max_per_img:       # pad small images to the fixed slate
        pad = max_per_img - k_out
        out_b = torch.cat([out_b, out_b.new_zeros((b, pad, 4))], 1)
        out_s = torch.cat([out_s, out_s.new_zeros((b, pad))], 1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], 1)
    return out_b, out_s, valid
