"""Faster R-CNN R50-C4, its training loss and its inference pass: port of
``iif_tpu/detection/c4.py`` (``C4BBoxHead``, ``C4FasterRCNN``,
``c4_anchor_generator``, ``c4_loss``, ``c4_simple_test``), mmdet's
``faster_rcnn_r50_caffe_c4`` layout:

- the backbone is ResNet stages 1-3 (``num_stages=3``): one C4 map at
  stride 16 with 1024 channels;
- the RPN runs on that one level with 15 anchors a cell (scales 2-32 of
  the stride-16 base, ratios 0.5/1/2);
- RoIAlign 14x14 on C4 (kernel K3 on the card, and its backward K4 in
  training), then res5 per RoI as the shared head (``ResLayer``, stride
  2 -> 7x7), then the mean over 7x7 and the linear ``fc_cls`` /
  class-specific ``fc_reg``.

State_dict names are mmdet's: ``backbone.*``, ``rpn_head.*``,
``roi_head.shared_head.layer4.{i}.*``, ``roi_head.bbox_head.fc_cls|fc_reg``.
Each stage of ``c4_loss`` and ``c4_simple_test`` is a named
``record_function`` span, so a ``torch.profiler`` trace splits a step or a
request by stage.

The JAX ``c4_loss`` reads its RoI features with ``ops/roi_align.py::
roi_align``, the XLA gather, and differentiates it as a scatter-add; K3
and K4 compute exactly that function (``roi_align_pallas`` and the
backward of ``roi_align_pallas_grad`` without the TPU's window), so both
the serving and the training path take them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from iif_torch.detection.bbox_head import (
    bbox_head_get_bboxes,
    bbox_head_loss,
    bbox_targets,
)
from iif_torch.detection.detector import (
    _DEPTH_LAYERS,
    _DTYPES,
    DetTestCfg,
    DetTrainCfg,
    normalize_if_uint8,
)
from iif_torch.detection.rpn import RPNHead, rpn_loss, rpn_proposals
from iif_torch.models.resnet import ResLayer, ResNet
from iif_torch.ops.anchors import AnchorGenerator
from iif_torch.ops.roi_align import roi_align


class C4BBoxHead(nn.Module):
    """mmdet ``BBoxHead(with_avg_pool=True)``: the mean over the 7x7
    shared-head output (f32 sum, rounded to its dtype, as ``jnp.mean``),
    then ``fc_cls`` and the class-specific ``fc_reg`` in f32, as flax
    promotes to its f32 parameters."""

    def __init__(self, num_classes: int, in_channels: int = 2048):
        super().__init__()
        self.fc_cls = nn.Linear(in_channels, num_classes + 1)
        self.fc_reg = nn.Linear(in_channels, num_classes * 4)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (R, C, 7, 7) -> (cls_score (R, K+1), bbox_pred (R, 4K),
        embedding (R, C) in x's dtype)."""
        n = torch.tensor(float(x.shape[2] * x.shape[3]), device=x.device)
        e = (x.float().sum(dim=(2, 3)) / n).to(x.dtype)
        return self.fc_cls(e.float()), self.fc_reg(e.float()), e


class C4RoIHead(nn.Module):
    """Container for mmdet's ``roi_head.shared_head`` /
    ``roi_head.bbox_head`` names."""

    def __init__(self, num_classes: int, n_blocks: int, norm_eval: bool,
                 compute_dtype):
        super().__init__()
        self.shared_head = ResLayer(n_blocks, norm_eval, compute_dtype)
        self.bbox_head = C4BBoxHead(num_classes)


class C4FasterRCNN(nn.Module):
    """Takes the keyword arguments of the C4 config's model dict. Only
    the bbox-only detector with an RPN is ported (``with_mask=False``,
    ``with_rpn=True``, as in the config)."""

    # random_init_'s scales for the predictors: the JAX package's flax
    # inits (normal 0.01 and 0.001), mmdet's for BBoxHead
    init_std = {"roi_head.bbox_head.fc_cls.weight": 0.01,
                "roi_head.bbox_head.fc_reg.weight": 0.001}

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 frozen_stages: int = 1, norm_eval: bool = True,
                 compute_dtype=None, with_mask: bool = False,
                 with_rpn: bool = True):
        super().__init__()
        if with_mask or not with_rpn:
            raise NotImplementedError(
                "the port serves the C4 detector with an RPN and no mask "
                f"head, got with_mask={with_mask}, with_rpn={with_rpn}")
        if isinstance(compute_dtype, str):
            compute_dtype = _DTYPES[compute_dtype]
        layers = _DEPTH_LAYERS[depth]
        self.num_classes = num_classes
        self.backbone = ResNet(layers, frozen_stages, norm_eval,
                               compute_dtype, num_stages=3)
        self.rpn_head = RPNHead(1024, 1024, num_anchors=15,
                                compute_dtype=compute_dtype)
        self.roi_head = C4RoIHead(num_classes, layers[3], norm_eval,
                                  compute_dtype)
        self._anchors: Dict[Any, list] = {}

    def extract_feat(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 or normalised float -> the C4 map, NCHW in
        ``channels_last`` memory (its NHWC view is contiguous)."""
        x = normalize_if_uint8(images).permute(0, 3, 1, 2)
        return self.backbone(x)[-1].contiguous(
            memory_format=torch.channels_last)

    def forward_rpn(self, feat: torch.Tensor):
        return self.rpn_head([feat])

    def forward_shared(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C) NHWC RoI features -> (R, 2048, 7, 7)."""
        return self.roi_head.shared_head(roi_feats.permute(0, 3, 1, 2))

    def forward_bbox(self, shared: torch.Tensor):
        return self.roi_head.bbox_head(shared)

    def anchors(self, feat_hw: Tuple[int, int], device) -> list:
        """The C4 level's anchors on ``device`` for a map size, built
        once."""
        key = (tuple(feat_hw), str(device))
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(device) for a in
                c4_anchor_generator().grid_anchors([tuple(feat_hw)])]
        return self._anchors[key]

    def train_anchors(self, img_hw: Tuple[int, int],
                      feat_hw: Tuple[int, int], device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The C4 level's anchors (A, 4) and their inside-the-image flags
        (A,) (``c4.py:143-148``), built once per canvas and map size."""
        key = ("train", tuple(img_hw), tuple(feat_hw), str(device))
        if key not in self._anchors:
            gen = c4_anchor_generator()
            self._anchors[key] = (
                torch.from_numpy(gen.grid_anchors([tuple(feat_hw)])[0]
                                 ).to(device),
                torch.from_numpy(np.asarray(gen.valid_flags(
                    [tuple(feat_hw)], tuple(img_hw))[0])).to(device))
        return self._anchors[key]


def c4_anchor_generator() -> AnchorGenerator:
    """The C4 RPN anchors: scales [2, 4, 8, 16, 32] on the one stride-16
    level, ratios [0.5, 1, 2]."""
    return AnchorGenerator(strides=[16], ratios=[0.5, 1.0, 2.0],
                           scales=[2.0, 4.0, 8.0, 16.0, 32.0])


def c4_loss(
    model: C4FasterRCNN,
    batch: Dict[str, torch.Tensor],
    loss_cls,
    cfg: DetTrainCfg = DetTrainCfg(),
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Forward and every loss of one batch (``c4.py:121-189``): the C4
    trunk, the one-level RPN loss, proposals from the detached RPN
    outputs, the sampled RoIs' targets, RoIAlign 14x14 on the C4 map (K3
    forward, K4 backward on the card), res5 per RoI and the bbox head.

    batch: ``image`` (B, H, W, 3) uint8 or normalised float,
    ``gt_boxes`` (B, G, 4), ``gt_labels`` (B, G), ``gt_valid`` (B, G).
    The samplers draw their noise from ``generator``, or take it from
    ``noise``: ``{"rpn": (pos, neg)}`` each (B, A) and ``{"rcnn": (pos,
    neg)}`` each (B, G + P), as ``maskrcnn_loss`` takes it.

    Returns (total, losses, aux): ``losses`` has the JAX package's keys
    (``loss_cls``, ``loss_bbox``, ``loss_rpn_cls``, ``loss_rpn_bbox``);
    ``aux`` is empty: the JAX package's carries the BN statistics, which
    ``norm_eval`` leaves as they are."""
    noise = noise or {}
    images = batch["image"]
    b, img_h, img_w, _ = images.shape
    dev = images.device
    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]

    with record_function("backbone"):
        feat = model.extract_feat(images)
    with record_function("rpn_loss"):
        cls_scores, bbox_preds = model.forward_rpn(feat)
        anchors, anchor_valid = model.train_anchors(
            (img_h, img_w), feat.shape[2:], dev)
        l_rpn_cls, l_rpn_bbox = rpn_loss(
            cls_scores, bbox_preds, anchors, anchor_valid, gt_boxes,
            gt_valid, num_samples=cfg.rpn_num_samples,
            pos_fraction=cfg.rpn_pos_fraction, noise=noise.get("rpn"),
            generator=generator)
    with record_function("rpn_proposals"):
        proposals, _, prop_valid = rpn_proposals(
            [s.detach() for s in cls_scores],
            [d.detach() for d in bbox_preds], [anchors], (img_h, img_w),
            nms_pre=cfg.rpn_nms_pre, max_per_img=cfg.rpn_max_per_img,
            nms_iou=cfg.rpn_nms_iou)
    with record_function("bbox_targets"):
        tgts = bbox_targets(
            proposals, prop_valid, gt_boxes, batch["gt_labels"], gt_valid,
            model.num_classes, num_samples=cfg.rcnn_num_samples,
            pos_fraction=cfg.rcnn_pos_fraction, noise=noise.get("rcnn"),
            generator=generator)
        r = cfg.rcnn_num_samples
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=dev).repeat_interleave(r)
        rois5 = torch.cat([batch_idx[:, None], tgts.rois.reshape(-1, 4)], 1)
    with record_function("roi_align"):
        roi_feats = roi_align(feat.permute(0, 2, 3, 1), rois5, (14, 14),
                              spatial_scale=1.0 / 16)
    with record_function("shared_head"):
        shared = model.forward_shared(roi_feats)
    with record_function("bbox_head_loss"):
        cls_score, bbox_pred, _ = model.forward_bbox(shared)
        l_cls, l_bbox = bbox_head_loss(cls_score, bbox_pred, tgts, loss_cls,
                                       model.num_classes)
    losses = {"loss_cls": l_cls, "loss_bbox": l_bbox,
              "loss_rpn_cls": l_rpn_cls, "loss_rpn_bbox": l_rpn_bbox}
    return sum(losses.values()), losses, {}


@torch.inference_mode()
def c4_simple_test(
    model: C4FasterRCNN,
    images: torch.Tensor,
    loss_cls,
    cfg: DetTestCfg = DetTestCfg(),
) -> Dict[str, torch.Tensor]:
    """Inference on (B, H, W, 3) canvases (``c4.py:192-237``): fixed-shape
    per-image detections (boxes (B, K, 4), scores (B, K), labels (B, K),
    valid (B, K))."""
    if cfg.nms_kind != "nms":
        raise NotImplementedError(f"nms_kind {cfg.nms_kind!r} is not ported")
    b, img_h, img_w, _ = images.shape
    dev = images.device
    with record_function("backbone"):
        feat = model.extract_feat(images)
    with record_function("rpn"):
        cls_scores, bbox_preds = model.forward_rpn(feat)
        proposals, _, prop_valid = rpn_proposals(
            cls_scores, bbox_preds, model.anchors(feat.shape[2:], dev),
            (img_h, img_w), nms_pre=cfg.rpn_nms_pre,
            max_per_img=cfg.rpn_max_per_img, nms_iou=cfg.rpn_nms_iou)

    p = proposals.shape[1]
    with record_function("roi_align"):
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=dev).repeat_interleave(p)
        rois5 = torch.cat([batch_idx[:, None], proposals.reshape(-1, 4)], 1)
        roi_feats = roi_align(feat.permute(0, 2, 3, 1), rois5, (14, 14),
                              spatial_scale=1.0 / 16)
    with record_function("shared_head"):
        shared = model.forward_shared(roi_feats)
    with record_function("bbox_head"):
        cls_score, bbox_pred, _ = model.forward_bbox(shared)
        cls_score = cls_score.reshape(b, p, -1)
        bbox_pred = bbox_pred.reshape(b, p, -1)
        # suppress padded proposals
        cls_score = torch.where(prop_valid[..., None], cls_score,
                                torch.full_like(cls_score, -1e9))
    with record_function("bbox_nms"):
        dets, scores, labels, det_valid = bbox_head_get_bboxes(
            proposals, cls_score, bbox_pred, (img_h, img_w), loss_cls,
            score_thr=cfg.score_thr, nms_iou=cfg.nms_iou,
            max_per_img=cfg.max_per_img)
    return {"boxes": dets, "scores": scores, "labels": labels,
            "valid": det_valid}
