"""Shared2FC bbox head, its training targets and loss, and its inference
decode: port of ``iif_tpu/detection/bbox_head.py`` (``Shared2FCBBoxHead``
with the linear, the normed or the IIF-normed classifier, ``cls_channels``
and ``cls_only``,
``BBoxTargets``, ``bbox_targets`` with the random sampler,
``bbox_head_loss`` with the L1 box loss, ``bbox_head_get_bboxes``) under
mmdet's names ``shared_fcs.{0,1}``, ``fc_cls``, ``fc_reg``.

The 7x7 RoI features are flattened in mmdet's CHW order (the JAX package
flattens HWC and permutes ``shared_fcs.0`` when converting, see
``detection/convert.py``). The head has no compute dtype: it takes the
RoI features in the trunk's dtype and computes in f32, as flax promotes
to its f32 parameters.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.models.layers import IIFNormedLinear, NormedLinear
from iif_torch.ops.assigner import max_iou_assign
from iif_torch.ops.boxes import bbox2delta, delta2bbox
from iif_torch.ops.nms import _take, multiclass_nms
from iif_torch.ops.sampler import random_sample_pos_neg

BBOX_TARGET_MEANS = (0.0, 0.0, 0.0, 0.0)
BBOX_TARGET_STDS = (0.1, 0.1, 0.2, 0.2)


class Shared2FCBBoxHead(nn.Module):
    """``cls_predictor`` is ``"linear"``, ``"normed"`` (the cosine
    ``NormedLinear`` at ``cls_temperature``) or ``"iif_normed"``
    (``IIFNormedLinear`` with ``iif_weights``, C+1 of them);
    ``cls_channels`` is the classifier's width, 0 for C+1 (Seesaw's head
    takes C+2; the IIF-normed classifier has C+1 whatever it says, as in
    JAX); ``reg_class_agnostic`` regresses one box a RoI instead of one a
    class. ``cls_init`` is the initialiser of a linear ``fc_cls`` in fresh
    weights (``detection/init.py::fresh_init_``): ``("normal", std)`` or
    ``("constant", value)``, with an optional bias value third, as the
    JAX head takes it."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_size: int = 7, fc_out_channels: int = 1024,
                 cls_init: tuple = ("normal", 0.01),
                 cls_predictor: str = "linear",
                 cls_temperature: float = 8.0,
                 reg_class_agnostic: bool = False,
                 cls_channels: int = 0, iif_weights=()):
        super().__init__()
        if cls_predictor not in ("linear", "normed", "iif_normed"):
            raise NotImplementedError(
                f"cls_predictor {cls_predictor!r} is not ported")
        self.num_classes = num_classes
        self.cls_init = tuple(cls_init)
        self.reg_class_agnostic = reg_class_agnostic
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        out_ch = cls_channels or num_classes + 1
        if cls_predictor == "normed":
            self.fc_cls = NormedLinear(fc_out_channels, out_ch,
                                       cls_temperature)
        elif cls_predictor == "iif_normed":
            self.fc_cls = IIFNormedLinear(fc_out_channels, num_classes + 1,
                                          iif_weights, cls_temperature)
        else:
            self.fc_cls = nn.Linear(fc_out_channels, out_ch)
        self.fc_reg = nn.Linear(
            fc_out_channels, 4 if reg_class_agnostic else num_classes * 4)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """roi_feats (R, 7, 7, C) -> (cls_score (R, C+1, or C+2 for
        Seesaw), bbox_pred (R, C*4 or 4), embedding (R, 1024))."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        x = x.float()
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x), x

    def cls_only(self, embedding: torch.Tensor) -> torch.Tensor:
        """The classifier alone on 1024-d embeddings (FASA's virtual
        features, ``fasa_bbox_head.py:283-287``)."""
        return self.fc_cls(embedding)


class BBoxTargets(NamedTuple):
    rois: torch.Tensor           # (B, R, 4) sampled proposals
    labels: torch.Tensor         # (B, R) class, or num_classes for bg
    label_weights: torch.Tensor  # (B, R)
    bbox_targets: torch.Tensor   # (B, R, 4)
    bbox_weights: torch.Tensor   # (B, R) 1 for positives
    pos_gt_inds: torch.Tensor    # (B, R) matched gt index (positives)


def bbox_targets(
    proposals: torch.Tensor,       # (B, P, 4), no gradient
    proposal_valid: torch.Tensor,  # (B, P)
    gt_boxes: torch.Tensor,        # (B, G, 4)
    gt_labels: torch.Tensor,       # (B, G)
    gt_valid: torch.Tensor,        # (B, G)
    num_classes: int,
    num_samples: int = 512,
    pos_fraction: float = 0.25,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.5,
    min_pos_iou: float = 0.5,
    add_gt_as_proposals: bool = True,
) -> BBoxTargets:
    """The gt boxes join the proposals (``add_gt_as_proposals``), MaxIoU
    assigns them at the IoU thresholds without low-quality matching, the
    random sampler picks ``num_samples`` per image, positives first
    (``bbox_head.py:206-305``). ``noise`` = the sampler's (pos, neg)
    draws, each (B, G + P), or (B, P) without the gt boxes."""
    g = gt_boxes.shape[1]
    props, pvalid = proposals, proposal_valid
    if add_gt_as_proposals:
        props = torch.cat([gt_boxes, props], 1)
        pvalid = torch.cat([gt_valid, pvalid], 1)
    assigned, _ = max_iou_assign(props, gt_boxes, gt_valid, pos_iou_thr,
                                 neg_iou_thr, min_pos_iou,
                                 match_low_quality=False)
    assigned = torch.where(pvalid, assigned, torch.full_like(assigned, -1))
    pos_noise, neg_noise = noise if noise is not None else (None, None)
    inds, is_pos, valid = random_sample_pos_neg(
        assigned, num_samples, pos_fraction, pos_noise, neg_noise, generator)
    rois = _take(props, inds)
    gt_idx = torch.clamp(torch.gather(assigned, 1, inds).long() - 1, 0,
                         g - 1)
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, num_classes))
    tgt = bbox2delta(rois, _take(gt_boxes, gt_idx), BBOX_TARGET_MEANS,
                     BBOX_TARGET_STDS)
    return BBoxTargets(rois, labels, valid.float(), tgt,
                       (is_pos & valid).float(), gt_idx)


def bbox_head_loss(
    cls_score: torch.Tensor,     # (B*R, C+1)
    bbox_pred: torch.Tensor,     # (B*R, C*4)
    targets: BBoxTargets,
    loss_cls,
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IIF recipe's ``bbox_head_loss`` (``bbox_head.py:308-350``,
    ``loss_bbox="l1"``, ``avg_mode="sum"``): the classification loss over
    the summed label weights, and the L1 on the positives' class-specific
    deltas over the same sum."""
    labels = targets.labels.reshape(-1)
    lw = targets.label_weights.reshape(-1)
    bw = targets.bbox_weights.reshape(-1)
    tgt = targets.bbox_targets.reshape(-1, 4)
    l_cls = loss_cls(cls_score, labels, weight=lw, avg_factor=lw.sum())
    pred = bbox_pred.reshape(-1, num_classes, 4)
    cls_idx = torch.clamp(labels, 0, num_classes - 1)
    pred = torch.gather(pred, 1, cls_idx[:, None, None].expand(-1, 1, 4))
    per = torch.abs(pred[:, 0] - tgt).sum(-1)
    l_bbox = (per * bw).sum() / torch.clamp(lw.sum(), min=1.0)
    return l_cls, l_bbox


def bbox_head_get_bboxes(
    rois: torch.Tensor,          # (B, R, 4)
    cls_score: torch.Tensor,     # (B, R, C+1)
    bbox_pred: torch.Tensor,     # (B, R, C*4)
    img_shape: Tuple[int, int],
    loss_cls,
    score_thr: float = 0.05,
    nms_iou: float = 0.5,
    max_per_img: int = 100,
):
    """Decode, the loss's custom activation (softmax(IIF x score) for
    ``DetIIFLoss``, class softmax x P(object) for ``SeesawLoss``'s C+2
    channels), multiclass NMS (``bbox_head.py:315-377``). Batched
    over the leading axis. Returns fixed-shape detections."""
    if getattr(loss_cls, "custom_activation", False):
        scores = loss_cls.get_activation(cls_score)
    else:
        scores = torch.softmax(cls_score.float(), dim=-1)
    boxes = delta2bbox(rois, bbox_pred, BBOX_TARGET_MEANS, BBOX_TARGET_STDS,
                       max_shape=img_shape)
    return multiclass_nms(boxes, scores, score_thr, nms_iou, max_per_img)
