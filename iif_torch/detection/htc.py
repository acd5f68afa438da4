"""HTC (Hybrid Task Cascade), its training loss and its inference pass:
port of ``iif_tpu/detection/htc.py`` (``HTC``, ``htc_loss``,
``htc_simple_test``), the reference's ``htc_roi_head.py`` without the
semantic branch (the ``htc_without_semantic`` configs and
``configs/activations/iif/iif_htc_r101_4x4_1x.py``).

The cascade of ``detection/cascade.py`` with two changes to its mask
branch:

1. interleaved training: each stage's mask branch trains on the stage's
   RoIs refined by its own (detached) regression, assigned and sampled
   again at the stage's IoU without the gt boxes;
2. mask information flow: stage i's mask trunk adds the previous stage's
   trunk output through its ``conv_res`` (``HTCMaskHead``), so stage i
   runs the trunks of stages 0..i on the same RoI features, in training
   and at test time.

Parameters take mmdet's HTC names: ``roi_head.bbox_head.{i}.*`` and
``roi_head.mask_head.{i}.*`` with ``conv_res.conv`` from stage 1 on.
The fused semantic branch (``with_semantic=True``) is not ported. Each
stage is a ``record_function`` span as in the cascade, its mask branch
split into ``stage{i}_mask_trunk`` (the chained trunks) and
``stage{i}_mask_loss``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from iif_torch.detection.bbox_head import bbox_targets
from iif_torch.detection.cascade import (
    STAGE_IOUS,
    STAGE_WEIGHTS,
    CascadeMaskRCNN,
    _rois5,
    cascade_detect,
    stage_bbox_loss,
    trunk_rpn_loss,
)
from iif_torch.detection.detector import (
    DetTestCfg,
    DetTrainCfg,
    resolve_gt_masks,
)
from iif_torch.detection.mask_head import (
    HTCMaskHead,
    mask_head_loss,
    mask_targets,
)
from iif_torch.detection.roi_extractor import SingleRoIExtractor


class HTC(CascadeMaskRCNN):
    """Takes the keyword arguments of a ``configs/`` HTC model dict:
    ``CascadeMaskRCNN``'s, with ``HTCMaskHead`` a stage (the first
    without ``conv_res``). ``with_semantic=True`` raises
    ``NotImplementedError``."""

    def __init__(self, *args, with_semantic: bool = False, **kw):
        if with_semantic:
            raise NotImplementedError(
                "HTC with_semantic=True (the fused semantic branch) is not "
                "ported")
        super().__init__(*args, **kw)

    def make_mask_head(self, stage: int, predictor: str,
                       temperature: float) -> nn.Module:
        return HTCMaskHead(self.num_classes, with_conv_res=stage > 0,
                           predictor=predictor)

    def mask_trunks(self, mfeats: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s trunk on (R, 14, 14, C) RoI features, after
        the trunks of the stages before it, each feeding the next."""
        last = None
        for head in self.roi_head.mask_head[:stage + 1]:
            last = head.trunk(mfeats, last)
        return last


def htc_loss(
    model: HTC,
    batch: Dict[str, torch.Tensor],
    loss_cls,
    cfg: DetTrainCfg = DetTrainCfg(),
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Forward and every loss of one batch (``htc.py:170-315``,
    interleaved with mask information flow), every stage with the one
    ``loss_cls``; the batch as ``maskrcnn_loss`` takes it. Per stage: the
    cascade's targets, bbox loss and refinement of the sampled RoIs by the
    detached, label-selected regression; then those refined RoIs (valid
    where the label weight is) assigned and sampled again at the stage's
    IoU without the gt boxes, their first ``num_mask_rois`` an image
    through the chained mask trunks, and the stage's weighted mask loss.

    ``noise``: ``{"rpn": (pos, neg)}`` each (B, A_tot), ``{"rcnn": [(pos,
    neg)] a stage}`` each (B, G + P) in stage 0 and (B, R) after, and
    ``{"mask": [(pos, neg)] a stage}`` each (B, R), the mask branch's
    re-sampling; missing draws come from ``generator``. Returns (total,
    losses, {}) with the JAX package's keys (``loss_rpn_cls``,
    ``loss_rpn_bbox``, ``s{i}.loss_cls``, ``s{i}.loss_bbox``,
    ``s{i}.loss_mask``)."""
    noise = noise or {}
    b, img_h, img_w, _ = batch["image"].shape
    nhwc, losses, proposals, prop_valid = trunk_rpn_loss(
        model, batch, cfg, generator, noise)
    r, m, n = cfg.rcnn_num_samples, cfg.num_mask_rois, model.num_classes
    gt_masks = (resolve_gt_masks(batch, img_w // cfg.mask_gt_stride)
                if model.with_mask else None)

    for stage in range(model.num_stages):
        iou, sw = STAGE_IOUS[stage], STAGE_WEIGHTS[stage]
        st = stage_bbox_loss(model, stage, nhwc, proposals, prop_valid,
                             batch, loss_cls, cfg, generator, noise)
        losses[f"s{stage}.loss_cls"] = st.loss_cls
        losses[f"s{stage}.loss_bbox"] = st.loss_bbox
        # interleaved: the stage's refined RoIs feed its own mask branch
        # and the next stage
        proposals, prop_valid = st.refined(model, stage, (img_h, img_w))
        if not model.with_mask:
            continue
        with record_function(f"stage{stage}_mask_targets"):
            mtgts = bbox_targets(
                proposals, prop_valid, batch["gt_boxes"], batch["gt_labels"],
                batch["gt_valid"], n, num_samples=r,
                pos_fraction=cfg.rcnn_pos_fraction,
                noise=noise["mask"][stage] if "mask" in noise else None,
                generator=generator, pos_iou_thr=iou, neg_iou_thr=iou,
                min_pos_iou=iou, add_gt_as_proposals=False)
            mrois5 = _rois5(mtgts.rois[:, :m])
            pos_labels = mtgts.labels[:, :m].reshape(-1)
            mask_tgt = mask_targets(
                mrois5, mtgts.pos_gt_inds[:, :m].reshape(-1), gt_masks,
                cfg.mask_size, gt_stride=cfg.mask_gt_stride)
        with record_function(f"stage{stage}_mask_roi_align"):
            mfeats = SingleRoIExtractor((14, 14))(nhwc, mrois5)
        with record_function(f"stage{stage}_mask_trunk"):
            trunk = model.mask_trunks(mfeats, stage)
        with record_function(f"stage{stage}_mask_loss"):
            mask_pred = model.roi_head.mask_head[
                stage].logits_for_labels_from_trunk(
                    trunk, torch.clamp(pos_labels, 0, n - 1))
            losses[f"s{stage}.loss_mask"] = sw * mask_head_loss(
                mask_pred, mask_tgt, mtgts.bbox_weights[:, :m].reshape(-1))

    return sum(losses.values()), losses, {}


@torch.inference_mode()
def htc_simple_test(
    model: HTC,
    images: torch.Tensor,
    loss_cls,
    cfg: DetTestCfg = DetTestCfg(),
    scale_factor: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Inference on (B, H, W, 3) canvases (``htc.py:318-408``): the
    cascade's boxes and stage-averaged scores (``cascade_detect``),
    then one 14x14 extraction at the detections and the mask
    probabilities of each detection's class averaged over the stages,
    each stage's trunk fed by the one before it. Returns the fixed-shape
    dict of ``maskrcnn_simple_test``."""
    out, nhwc = cascade_detect(model, images, loss_cls, cfg)
    dets, labels = out["boxes"], out["labels"]
    if model.with_mask:
        b, k = dets.shape[:2]
        with record_function("mask_roi_align"):
            mfeats = SingleRoIExtractor((14, 14))(nhwc, _rois5(dets))
        cls_idx = torch.clamp(labels.reshape(-1), 0, model.num_classes - 1)
        probs, last = 0.0, None
        for stage, head in enumerate(model.roi_head.mask_head):
            with record_function(f"stage{stage}_mask_trunk"):
                last = head.trunk(mfeats, last)
            with record_function(f"stage{stage}_mask_head"):
                probs = probs + torch.sigmoid(
                    head.logits_for_labels_from_trunk(last, cls_idx).float())
        probs = probs / model.num_stages
        out["masks"] = probs.reshape(b, k, *probs.shape[1:])

    if scale_factor is not None:
        out["boxes"] = out["boxes"] / scale_factor[:, None, :]
    return out
