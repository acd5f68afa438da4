"""Shared2FC bbox head and its inference decode: port of
``iif_tpu/detection/bbox_head.py`` (``Shared2FCBBoxHead``,
``bbox_head_get_bboxes``) under mmdet's names ``shared_fcs.{0,1}``,
``fc_cls``, ``fc_reg``.

The 7x7 RoI features are flattened in mmdet's CHW order (the JAX package
flattens HWC and permutes ``shared_fcs.0`` when converting, see
``detection/convert.py``). The head has no compute dtype: it takes the
RoI features in the trunk's dtype and computes in f32, as flax promotes
to its f32 parameters.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.ops.boxes import delta2bbox
from iif_torch.ops.nms import multiclass_nms

BBOX_TARGET_MEANS = (0.0, 0.0, 0.0, 0.0)
BBOX_TARGET_STDS = (0.1, 0.1, 0.2, 0.2)


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_size: int = 7, fc_out_channels: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """roi_feats (R, 7, 7, C) -> (cls_score (R, C+1), bbox_pred
        (R, C*4), embedding (R, 1024))."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        x = x.float()
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x), x


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
    ``DetIIFLoss``), multiclass NMS (``bbox_head.py:315-377``). Batched
    over the leading axis. Returns fixed-shape detections."""
    if getattr(loss_cls, "custom_activation", False):
        scores = loss_cls.get_activation(cls_score)
    else:
        scores = torch.softmax(cls_score.float(), dim=-1)
    boxes = delta2bbox(rois, bbox_pred, BBOX_TARGET_MEANS, BBOX_TARGET_STDS,
                       max_shape=img_shape)
    return multiclass_nms(boxes, scores, score_thr, nms_iou, max_per_img)
