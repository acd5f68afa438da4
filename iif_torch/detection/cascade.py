"""Cascade Mask R-CNN, its training loss and its inference pass: port of
``iif_tpu/detection/cascade.py`` (``CascadeMaskRCNN``, ``_select_pred``,
``_refine``, ``cascade_loss``, ``cascade_simple_test``), the reference's
``cascade_roi_head.py`` with the FASA cascade's per-stage heads.

Three refinement stages on one ResNet + FPN + RPN trunk: per-stage IoU
thresholds (0.5, 0.6, 0.7), box-delta stds and loss weights (1, 0.5,
0.25); each stage decodes its label-selected regression into the next
stage's RoIs; at test time the class scores are averaged over the stages
through the loss's activation, and so are the mask probabilities. With
FASA each stage owns a ``FasaState``.

Parameters take mmdet's cascade names, ``roi_head.bbox_head.{i}.*`` and
``roi_head.mask_head.{i}.*`` beside the trunk's. HTC (``detection/
htc.py``) shares the box half: ``trunk_rpn_loss``, ``stage_bbox_loss``
and ``cascade_detect``, its mask heads from ``make_mask_head``. Each stage of
``cascade_loss`` and ``cascade_simple_test`` is a ``record_function``
span (``stage{i}_*``), so a ``torch.profiler`` trace splits a step or a
request by stage.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from iif_torch.detection.bbox_head import (
    BBOX_TARGET_MEANS,
    BBOX_TARGET_STDS,
    Shared2FCBBoxHead,
    bbox_targets,
)
from iif_torch.detection.detector import (
    DetTestCfg,
    DetTrainCfg,
    TwoStageTrunk,
    fasa_step,
    resolve_gt_masks,
)
from iif_torch.detection.mask_head import (
    FCNMaskHead,
    mask_head_loss,
    mask_targets,
)
from iif_torch.detection.roi_extractor import SingleRoIExtractor
from iif_torch.detection.rpn import rpn_loss, rpn_proposals
from iif_torch.ops.boxes import bbox2delta, delta2bbox
from iif_torch.ops.nms import multiclass_nms

STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
STAGE_WEIGHTS = (1.0, 0.5, 0.25)


class CascadeRoIHead(nn.Module):
    """Container for mmdet's ``roi_head.bbox_head.{i}`` and
    ``roi_head.mask_head.{i}`` names, one head a stage (``mask_heads``
    as the detector builds them, or None)."""

    def __init__(self, num_classes: int, cls_init: tuple,
                 cls_predictor: str, cls_temperature: float,
                 reg_class_agnostic: bool,
                 mask_heads: Optional[Sequence[nn.Module]],
                 iif_weights=()):
        super().__init__()
        self.bbox_head = nn.ModuleList([
            Shared2FCBBoxHead(num_classes, cls_init=cls_init,
                              cls_predictor=cls_predictor,
                              cls_temperature=cls_temperature,
                              reg_class_agnostic=reg_class_agnostic,
                              iif_weights=iif_weights)
            for _ in STAGE_IOUS])
        self.mask_head = (None if mask_heads is None
                          else nn.ModuleList(mask_heads))


class CascadeMaskRCNN(TwoStageTrunk):
    """Takes the keyword arguments of a ``configs/`` cascade model dict
    (``configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py``). The heads'
    options are ``MaskRCNN``'s (``iif_weights`` with ``cls_predictor=
    "iif_normed"``; no ``cls_channels``, as JAX's cascade takes none);
    ``reg_class_agnostic`` defaults to True
    as in mmdet's cascade (the FASA cascade sets False); ``stage_stds``
    gives one entry a stage. The stages' IoUs and loss weights are
    ``STAGE_IOUS`` and ``STAGE_WEIGHTS``."""

    num_stages = len(STAGE_IOUS)

    def __init__(self, num_classes: int = 1203, depth: int = 101,
                 with_mask: bool = True,
                 frozen_stages: int = 1, norm_eval: bool = True,
                 compute_dtype=None, backbone_type: str = "resnet",
                 cls_predictor: str = "linear", mask_predictor: str = "conv",
                 cls_temperature: float = 8.0, mask_temperature: float = 20.0,
                 reg_class_agnostic: bool = True,
                 cls_init: tuple = ("normal", 0.01),
                 stage_stds: Sequence[Sequence[float]] = STAGE_STDS,
                 iif_weights=()):
        super().__init__(num_classes, depth, with_mask, frozen_stages,
                         norm_eval, compute_dtype, backbone_type)
        self.reg_class_agnostic = reg_class_agnostic
        self.stage_stds = tuple(tuple(s) for s in stage_stds)
        self.roi_head = CascadeRoIHead(
            num_classes, tuple(cls_init), cls_predictor, cls_temperature,
            reg_class_agnostic,
            [self.make_mask_head(i, mask_predictor, mask_temperature)
             for i in range(self.num_stages)] if with_mask else None,
            iif_weights)

    def make_mask_head(self, stage: int, predictor: str,
                       temperature: float) -> nn.Module:
        """Stage ``stage``'s mask head."""
        return FCNMaskHead(self.num_classes, predictor=predictor,
                           temperature=temperature)


def _select_pred(bbox_pred: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, reg_class_agnostic: bool
                 ) -> torch.Tensor:
    """(R, C*4) -> (R, 4) by each RoI's label, background clamped to
    class 0 (mmdet's ``regress_by_class``)."""
    if reg_class_agnostic:
        return bbox_pred
    pred = bbox_pred.reshape(-1, num_classes, 4)
    idx = torch.clamp(labels, 0, num_classes - 1)
    return torch.gather(pred, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]


def _refine(rois: torch.Tensor, bbox_pred4: torch.Tensor,
            img_shape: Tuple[int, int], stds) -> torch.Tensor:
    """Decode a label-selected (R, 4) regression, clamped to the image."""
    return delta2bbox(rois, bbox_pred4, (0.0, 0.0, 0.0, 0.0), stds,
                      max_shape=img_shape)


def _rois5(boxes: torch.Tensor) -> torch.Tensor:
    """(B, R, 4) -> (B*R, 5) with each box's image index first."""
    b, r = boxes.shape[:2]
    idx = torch.arange(b, dtype=torch.float32,
                       device=boxes.device).repeat_interleave(r)
    return torch.cat([idx[:, None], boxes.reshape(-1, 4)], 1)


class StageBBox(NamedTuple):
    """One stage's sampled targets, classifier output and box losses."""
    tgts: Any
    labels: torch.Tensor        # (B*R,)
    embedding: torch.Tensor     # (B*R, 1024), FASA's
    pred4: torch.Tensor         # (B*R, 4) label-selected regression
    loss_cls: torch.Tensor      # times the stage's weight
    loss_bbox: torch.Tensor

    def refined(self, model, stage: int, img_hw: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sampled RoIs refined by the detached regression with the
        stage's stds, (B, R, 4), and their validity (the label weight)."""
        b, r = self.tgts.rois.shape[:2]
        boxes = _refine(self.tgts.rois.reshape(-1, 4), self.pred4.detach(),
                        img_hw, model.stage_stds[stage])
        return boxes.reshape(b, r, 4), self.tgts.label_weights > 0


def trunk_rpn_loss(model, batch: Dict[str, torch.Tensor], cfg: DetTrainCfg,
                   generator: Optional[torch.Generator],
                   noise: Dict[str, Any]):
    """The trunk's FPN maps as NHWC views (P2..P5), the RPN's losses and
    the proposals (``backbone_fpn``, ``rpn_loss``, ``rpn_proposals``
    spans). Returns (nhwc, losses, proposals, proposal_valid)."""
    images = batch["image"]
    img_h, img_w = images.shape[1:3]
    dev = images.device
    with record_function("backbone_fpn"):
        feats = model.extract_feat(images)
    with record_function("rpn_loss"):
        cls_scores, bbox_preds = model.rpn_head(feats)
        anchors, anchor_valid = model.train_anchors((img_h, img_w), dev)
        l_rpn_cls, l_rpn_bbox = rpn_loss(
            cls_scores, bbox_preds, anchors, anchor_valid, batch["gt_boxes"],
            batch["gt_valid"], num_samples=cfg.rpn_num_samples,
            pos_fraction=cfg.rpn_pos_fraction, noise=noise.get("rpn"),
            generator=generator)
    with record_function("rpn_proposals"):
        proposals, _, prop_valid = rpn_proposals(
            [s.detach() for s in cls_scores],
            [d.detach() for d in bbox_preds],
            model.anchors((img_h, img_w), dev), (img_h, img_w),
            nms_pre=cfg.rpn_nms_pre, max_per_img=cfg.rpn_max_per_img,
            nms_iou=cfg.rpn_nms_iou)
    nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]
    return nhwc, {"loss_rpn_cls": l_rpn_cls, "loss_rpn_bbox": l_rpn_bbox}, \
        proposals, prop_valid


def stage_bbox_loss(model, stage: int, nhwc, proposals: torch.Tensor,
                    prop_valid: torch.Tensor, batch: Dict[str, torch.Tensor],
                    loss_cls, cfg: DetTrainCfg,
                    generator: Optional[torch.Generator],
                    noise: Dict[str, Any]) -> StageBBox:
    """One cascade stage's box branch (``stage{i}_targets``,
    ``_bbox_roi_align``, ``_bbox_head_loss`` spans): MaxIoU at the stage's
    IoU (the gt boxes join the proposals in stage 0 only), the sampled
    RoIs' 7x7 features, the head, the classification loss and the L1 box
    loss on the targets decoded with the default stds and encoded again
    with the stage's, each times the stage's weight."""
    iou, stds = STAGE_IOUS[stage], model.stage_stds[stage]
    sw = STAGE_WEIGHTS[stage]
    n = model.num_classes
    with record_function(f"stage{stage}_targets"):
        tgts = bbox_targets(
            proposals, prop_valid, batch["gt_boxes"], batch["gt_labels"],
            batch["gt_valid"], n, num_samples=cfg.rcnn_num_samples,
            pos_fraction=cfg.rcnn_pos_fraction,
            noise=noise["rcnn"][stage] if "rcnn" in noise else None,
            generator=generator, pos_iou_thr=iou, neg_iou_thr=iou,
            min_pos_iou=iou, add_gt_as_proposals=stage == 0)
        labels = tgts.labels.reshape(-1)
        lw = tgts.label_weights.reshape(-1)
        bw = tgts.bbox_weights.reshape(-1)
    with record_function(f"stage{stage}_bbox_roi_align"):
        roi_feats = SingleRoIExtractor((7, 7))(nhwc, _rois5(tgts.rois))
    with record_function(f"stage{stage}_bbox_head_loss"):
        cls_score, bbox_pred, embedding = model.roi_head.bbox_head[stage](
            roi_feats)
        l_cls = sw * loss_cls(cls_score, labels, weight=lw,
                              avg_factor=lw.sum())
        rois = tgts.rois.reshape(-1, 4)
        gt_boxes_roi = delta2bbox(rois, tgts.bbox_targets.reshape(-1, 4),
                                  BBOX_TARGET_MEANS, BBOX_TARGET_STDS)
        tgt = bbox2delta(rois, gt_boxes_roi, (0.0, 0.0, 0.0, 0.0), stds)
        pred4 = _select_pred(bbox_pred, labels, n, model.reg_class_agnostic)
        l1 = torch.abs(pred4 - tgt).sum(-1)
        l_bbox = sw * (l1 * bw).sum() / torch.clamp(lw.sum(), min=1.0)
    return StageBBox(tgts, labels, embedding, pred4, l_cls, l_bbox)


def cascade_loss(
    model: CascadeMaskRCNN,
    batch: Dict[str, torch.Tensor],
    loss_cls,
    cfg: DetTrainCfg = DetTrainCfg(),
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Any]] = None,
    fasa_state: Optional[Tuple] = None,
    fasa_cfg: Optional[Dict[str, float]] = None,
    epoch: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Forward and every loss of one batch (``cascade.py:166-305``); the
    batch as ``maskrcnn_loss`` takes it, ``loss_cls`` the one loss every
    stage uses. Per stage: MaxIoU at the stage's IoU, the gt boxes joining the
    proposals in stage 0 only, the regression targets decoded with the
    default stds and encoded again with the stage's, each loss times the
    stage's weight, and the next stage's proposals refined from the
    detached, label-selected regression (valid where the label weight
    is). ``fasa_state`` is a tuple of one ``FasaState`` a stage.

    ``noise``: ``{"rpn": (pos, neg)}`` each (B, A_tot), ``{"rcnn": [(pos,
    neg)] a stage}`` each (B, G + P) in stage 0 and (B, R) after, and
    ``{"fasa": [(uniform (C,), normal (C, 1024))] a stage}``; missing
    draws come from ``generator``. Returns (total, losses, aux) with the
    JAX package's keys (``loss_rpn_cls``, ``loss_rpn_bbox``,
    ``s{i}.loss_cls``, ``s{i}.loss_bbox``, ``s{i}.loss_mask``) and
    ``aux["fasa_state"]`` when FASA is on."""
    noise = noise or {}
    b, img_h, img_w, _ = batch["image"].shape
    nhwc, losses, proposals, prop_valid = trunk_rpn_loss(
        model, batch, cfg, generator, noise)
    r, m = cfg.rcnn_num_samples, cfg.num_mask_rois
    gt_masks = (resolve_gt_masks(batch, img_w // cfg.mask_gt_stride)
                if model.with_mask else None)
    new_fasa = []

    for stage in range(model.num_stages):
        sw = STAGE_WEIGHTS[stage]
        st = stage_bbox_loss(model, stage, nhwc, proposals, prop_valid,
                             batch, loss_cls, cfg, generator, noise)
        tgts, l_cls = st.tgts, st.loss_cls
        if fasa_state is not None:
            with record_function(f"stage{stage}_fasa"):
                fs, l_aug = fasa_step(
                    fasa_state[stage], st.embedding, st.labels,
                    tgts.bbox_weights.reshape(-1),
                    model.roi_head.bbox_head[stage].cls_only, loss_cls,
                    fasa_cfg, epoch, generator,
                    noise["fasa"][stage] if "fasa" in noise else None)
            if l_aug is not None:
                l_cls = l_cls + sw * l_aug
            new_fasa.append(fs)
        losses[f"s{stage}.loss_cls"] = l_cls
        losses[f"s{stage}.loss_bbox"] = st.loss_bbox

        if model.with_mask:
            with record_function(f"stage{stage}_mask_loss"):
                pos_rois5 = _rois5(tgts.rois[:, :m])
                pos_labels = tgts.labels[:, :m].reshape(-1)
                mask_tgt = mask_targets(
                    pos_rois5, tgts.pos_gt_inds[:, :m].reshape(-1),
                    gt_masks, cfg.mask_size, gt_stride=cfg.mask_gt_stride)
                mfeats = SingleRoIExtractor((14, 14))(nhwc, pos_rois5)
                mask_pred = model.roi_head.mask_head[stage].logits_for_labels(
                    mfeats, torch.clamp(pos_labels, 0, model.num_classes - 1))
                losses[f"s{stage}.loss_mask"] = sw * mask_head_loss(
                    mask_pred, mask_tgt,
                    tgts.bbox_weights[:, :m].reshape(-1))

        if stage < model.num_stages - 1:
            proposals, prop_valid = st.refined(model, stage, (img_h, img_w))

    aux: Dict[str, Any] = {}
    if fasa_state is not None:
        aux["fasa_state"] = tuple(new_fasa)
    return sum(losses.values()), losses, aux


def cascade_detect(model: CascadeMaskRCNN, images: torch.Tensor, loss_cls,
                   cfg: DetTestCfg) -> Tuple[Dict[str, torch.Tensor], list]:
    """The box half of the cascade's inference: each stage scores the
    current RoIs and refines them by its argmax foreground class; the
    class scores, through the loss's activation, are averaged over the
    stages, and the boxes are the last stage's refinement; multiclass
    NMS. Returns the detections (boxes, scores, labels, valid) and the
    FPN maps P2..P5 as NHWC views."""
    if cfg.nms_kind != "nms":
        raise NotImplementedError(f"nms_kind {cfg.nms_kind!r} is not ported")
    b, img_h, img_w, _ = images.shape
    dev = images.device
    n = model.num_classes
    with record_function("backbone_fpn"):
        feats = model.extract_feat(images)
    with record_function("rpn"):
        cls_scores, bbox_preds = model.rpn_head(feats)
        proposals, _, prop_valid = rpn_proposals(
            cls_scores, bbox_preds, model.anchors((img_h, img_w), dev),
            (img_h, img_w), nms_pre=cfg.rpn_nms_pre,
            max_per_img=cfg.rpn_max_per_img, nms_iou=cfg.rpn_nms_iou)
    p = proposals.shape[1]
    nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]
    rois = proposals.reshape(-1, 4)
    avg_scores = 0.0
    for stage in range(model.num_stages):
        with record_function(f"stage{stage}_bbox_roi_align"):
            roi_feats = SingleRoIExtractor((7, 7))(nhwc, _rois5(
                rois.reshape(b, p, 4)))
        with record_function(f"stage{stage}_bbox_head"):
            cls_score, bbox_pred, _ = model.roi_head.bbox_head[stage](
                roi_feats)
            if getattr(loss_cls, "custom_activation", False):
                avg_scores = avg_scores + loss_cls.get_activation(cls_score)
            else:
                avg_scores = avg_scores + torch.softmax(cls_score.float(),
                                                        -1)
            pred4 = _select_pred(bbox_pred, cls_score[:, :-1].argmax(-1), n,
                                 model.reg_class_agnostic)
            if stage < model.num_stages - 1:
                rois = _refine(rois, pred4, (img_h, img_w),
                               model.stage_stds[stage])
    with record_function("bbox_nms"):
        avg_scores = (avg_scores / model.num_stages).reshape(b, p, -1)
        avg_scores = torch.where(prop_valid[..., None], avg_scores,
                                 torch.zeros_like(avg_scores))
        final = _refine(rois, pred4, (img_h, img_w),
                        model.stage_stds[-1]).reshape(b, p, 4)
        dets, scores, labels, det_valid = multiclass_nms(
            final, avg_scores, cfg.score_thr, cfg.nms_iou, cfg.max_per_img)
    return {"boxes": dets, "scores": scores, "labels": labels,
            "valid": det_valid}, nhwc


@torch.inference_mode()
def cascade_simple_test(
    model: CascadeMaskRCNN,
    images: torch.Tensor,
    loss_cls,
    cfg: DetTestCfg = DetTestCfg(),
    scale_factor: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Inference on (B, H, W, 3) canvases (``cascade.py:308-393``): the
    detections of ``cascade_detect``, then the mask probabilities of each
    detection's class averaged over the stages' mask heads. Returns the
    fixed-shape dict of ``maskrcnn_simple_test``."""
    out, nhwc = cascade_detect(model, images, loss_cls, cfg)
    dets, labels = out["boxes"], out["labels"]
    if model.with_mask:
        b, k = dets.shape[:2]
        with record_function("mask_roi_align"):
            mfeats = SingleRoIExtractor((14, 14))(nhwc, _rois5(dets))
        with record_function("mask_head"):
            cls_idx = torch.clamp(labels.reshape(-1), 0,
                                  model.num_classes - 1)
            probs = 0.0
            for head in model.roi_head.mask_head:
                probs = probs + torch.sigmoid(
                    head.logits_for_labels(mfeats, cls_idx).float())
            probs = probs / model.num_stages
            out["masks"] = probs.reshape(b, k, *probs.shape[1:])

    if scale_factor is not None:
        out["boxes"] = out["boxes"] / scale_factor[:, None, :]
    return out
