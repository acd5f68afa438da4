"""Test-time augmentation: port of ``iif_tpu/detection/tta.py``
(``flip_boxes``, ``merge_aug_detections``, ``multi_scale_flip_views``, the
view mappings, ``_merged_aug_proposals``, ``maskrcnn_aug_test``,
``cascade_aug_test``), the reference's ``MultiScaleFlipAug`` with the
two-stage aug-test mixins (``test_mixins.py:138-176, 281-311``,
``cascade_roi_head.py:458-530``, ``merge_augs.py``).

For one image, its V views (each scale with and without a flip) share
one canvas and run as one batch of V through the trunk and the RPN. Each
view's proposals go back to the original image's frame and one NMS over
their union keeps the first ``rpn_max_per_img``: the merged set. Every
view re-scores that one set through the box head (the cascade: every
stage, refined by each stage's argmax class, the stages' activations
averaged); the decoded boxes, clamped to each view's content and mapped
back, and the scores are averaged over the views, then one multiclass
NMS runs. Mask probabilities (sigmoid, the cascade's averaged over its
stages) of each detection's class are averaged over the views, a flipped
view's mirrored back. JAX runs each image as one jitted program with the
views as its batch; the port runs the same batch eagerly.

The RoIAlign calls are the multi-level extractor's, K1 on the card
(``iif_torch/ops/roi_align_ml.py``): 7x7 on V x ``rpn_max_per_img`` RoIs
(three times for the cascade) and 14x14 on V x ``max_per_img``.

``aug_test`` dispatches as ``cli/test_det.py:177-230`` does: a cascade
(HTC included, ``detection/htc.py:120``) to ``cascade_aug_test``, any
other model to ``maskrcnn_aug_test``. Where JAX fails the port refuses
with ``NotImplementedError``: HTC with its mask branch (JAX's
``cascade_aug_test`` asks HTC for the cascade's ``mask_head_{i}``, which
HTC never builds) and Faster R-CNN C4 (its one stride-16 map is no FPN
level list).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from iif_torch.detection.bbox_head import BBOX_TARGET_MEANS, BBOX_TARGET_STDS
from iif_torch.detection.c4 import C4FasterRCNN
from iif_torch.detection.cascade import (
    CascadeMaskRCNN,
    _refine,
    _select_pred,
)
from iif_torch.detection.detector import DetTestCfg
from iif_torch.detection.htc import HTC
from iif_torch.detection.roi_extractor import SingleRoIExtractor
from iif_torch.detection.rpn import rpn_proposals
from iif_torch.ops.boxes import delta2bbox
from iif_torch.ops.nms import batched_nms, multiclass_nms, nms


def flip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    out = boxes.copy()
    out[..., 0] = width - boxes[..., 2]
    out[..., 2] = width - boxes[..., 0]
    return out


def merge_aug_detections(
    per_view: List[Dict[str, np.ndarray]],
    view_meta: List[Dict],
    orig_shape: Tuple[int, int],
    iou_thr: float = 0.5,
    max_per_img: int = 100,
) -> Dict[str, np.ndarray]:
    """Fuse per-view fixed-shape detections (boxes (K, 4), scores (K,),
    labels (K,), valid (K,) in each view's frame; ``view_meta`` each
    view's {scale_factor, flip}): mapped to the original frame, the valid
    ones pooled, class-aware NMS, the top ``max_per_img``."""
    h, w = orig_shape
    boxes_all, scores_all, labels_all = [], [], []
    for out, meta in zip(per_view, view_meta):
        boxes = np.asarray(out["boxes"], np.float64)
        if meta.get("flip"):
            boxes = flip_boxes(boxes, w * meta["scale_factor"])
        boxes = boxes / meta["scale_factor"]
        valid = np.asarray(out["valid"], bool)
        boxes_all.append(boxes[valid])
        scores_all.append(np.asarray(out["scores"])[valid])
        labels_all.append(np.asarray(out["labels"])[valid])
    if not boxes_all or sum(len(b) for b in boxes_all) == 0:
        return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                "labels": np.zeros(0, np.int64)}
    boxes = np.concatenate(boxes_all).astype(np.float32)
    scores = np.concatenate(scores_all).astype(np.float32)
    labels = np.concatenate(labels_all).astype(np.int64)
    keep, order = batched_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(labels), iou_thr)
    sel = order.numpy()[keep.numpy()][:max_per_img]
    return {"boxes": boxes[sel], "scores": scores[sel],
            "labels": labels[sel]}


def multi_scale_flip_views(scales: Sequence[Tuple[int, int]],
                           flip: bool = True) -> List[Dict]:
    """The view grid of MultiScaleFlipAug: each scale x {orig, flipped}."""
    views = []
    for s in scales:
        views.append({"scale": tuple(s), "flip": False})
        if flip:
            views.append({"scale": tuple(s), "flip": True})
    return views


def _boxes_to_view(boxes: torch.Tensor, sf: torch.Tensor,
                   flip: torch.Tensor, content_w: torch.Tensor
                   ) -> torch.Tensor:
    """Original-image boxes -> view coords (resize by ``sf``, then hflip
    within the resized content width); ``sf``, ``flip`` and
    ``content_w`` broadcast against ``boxes[..., 0]``."""
    x1, y1 = boxes[..., 0] * sf, boxes[..., 1] * sf
    x2, y2 = boxes[..., 2] * sf, boxes[..., 3] * sf
    fx1, fx2 = content_w - x2, content_w - x1
    return torch.stack([torch.where(flip, fx1, x1), y1,
                        torch.where(flip, fx2, x2), y2], dim=-1)


def _boxes_from_view(boxes: torch.Tensor, sf: torch.Tensor,
                     flip: torch.Tensor, content_w: torch.Tensor
                     ) -> torch.Tensor:
    """Inverse of ``_boxes_to_view`` (unflip, then divide by ``sf``)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    fx1, fx2 = content_w - x2, content_w - x1
    return torch.stack([torch.where(flip, fx1, x1), y1,
                        torch.where(flip, fx2, x2), y2],
                       dim=-1) / sf[..., None]


def _rois5(boxes: torch.Tensor) -> torch.Tensor:
    """(V, R, 4) view boxes -> (V*R, 5) with the view index first."""
    v, r = boxes.shape[:2]
    idx = torch.arange(v, dtype=torch.float32,
                       device=boxes.device).repeat_interleave(r)
    return torch.cat([idx[:, None], boxes.reshape(-1, 4)], 1)


def _activation(loss_cls, cls_score: torch.Tensor) -> torch.Tensor:
    if getattr(loss_cls, "custom_activation", False):
        return loss_cls.get_activation(cls_score)
    return torch.softmax(cls_score.float(), dim=-1)


def _merged_aug_proposals(model, images: torch.Tensor, sf: torch.Tensor,
                          flips: torch.Tensor, cw: torch.Tensor,
                          cfg: DetTestCfg):
    """Each view's RPN proposals (the views as the batch) mapped back to
    the original frame, one class-agnostic NMS over their union at
    ``rpn_nms_iou``, the first ``rpn_max_per_img`` kept (``merge_aug_
    proposals``). Returns the FPN maps P2..P5 as NHWC views, the merged
    (R, 4) proposals and their validity (R,)."""
    v, img_h, img_w, _ = images.shape
    dev = images.device
    with record_function("backbone_fpn"):
        feats = model.extract_feat(images)
    with record_function("rpn"):
        cls_scores, bbox_preds = model.rpn_head(feats)
        proposals, prop_scores, prop_valid = rpn_proposals(
            cls_scores, bbox_preds, model.anchors((img_h, img_w), dev),
            (img_h, img_w), nms_pre=cfg.rpn_nms_pre,
            max_per_img=cfg.rpn_max_per_img, nms_iou=cfg.rpn_nms_iou)
    with record_function("tta_merge"):
        orig = _boxes_from_view(proposals, sf[:, None], flips[:, None],
                                cw[:, None])
        flat = orig.reshape(-1, 4)
        flat_scores = torch.where(
            prop_valid.reshape(-1), prop_scores.reshape(-1).float(),
            torch.full_like(prop_scores.reshape(-1).float(), float("-inf")))
        keep, order = nms(flat, flat_scores, cfg.rpn_nms_iou)
        # ``order`` is score-sorted: the first rpn_max_per_img kept entries
        r = cfg.rpn_max_per_img
        rank = torch.cumsum(keep.long(), 0) - 1
        slots = torch.where(keep & (rank < r), rank, torch.full_like(rank, r))
        merged = flat.new_zeros((r + 1, 4))
        merged[slots] = flat[order]
        merged_valid = torch.zeros(r + 1, dtype=torch.bool, device=dev)
        merged_valid[slots] = keep & torch.isfinite(flat_scores[order])
    return ([f.permute(0, 2, 3, 1) for f in feats[:4]], merged[:r],
            merged_valid[:r])


def _view_meta(scale_factors, flips, content_hw):
    return (scale_factors.float(), flips.bool(),
            content_hw[:, 1].float(), content_hw[:, 0].float())


def _clamp_view(boxes: torch.Tensor, cw: torch.Tensor, ch: torch.Tensor
                ) -> torch.Tensor:
    """(V, ..., 4) view boxes clamped to each view's content."""
    shape = (-1,) + (1,) * (boxes.dim() - 2)
    bx = torch.minimum(torch.clamp(boxes[..., 0::2], min=0.0),
                       cw.reshape(shape + (1,)))
    by = torch.minimum(torch.clamp(boxes[..., 1::2], min=0.0),
                       ch.reshape(shape + (1,)))
    return torch.stack([bx[..., 0], by[..., 0], bx[..., 1], by[..., 1]],
                       dim=-1)


def _nms(boxes: torch.Tensor, scores: torch.Tensor, cfg: DetTestCfg
         ) -> Dict[str, torch.Tensor]:
    """One image's multiclass NMS: boxes (R, C*4 or 4), scores (R, C+1)."""
    dets, det_scores, labels, valid = multiclass_nms(
        boxes[None], scores[None], cfg.score_thr, cfg.nms_iou,
        cfg.max_per_img)
    return {"boxes": dets[0], "scores": det_scores[0], "labels": labels[0],
            "valid": valid[0]}


def _mask_probs(model, nhwc, dets: torch.Tensor, labels: torch.Tensor,
                sf, flips, cw, heads) -> torch.Tensor:
    """Each detection's class mask probabilities on every view, averaged
    over ``heads`` (a stage's mask head each) and then over the views,
    a flipped view's mirrored back."""
    v, k = sf.shape[0], dets.shape[0]
    with record_function("mask_roi_align"):
        det_view = _boxes_to_view(dets[None], sf[:, None], flips[:, None],
                                  cw[:, None])
        mfeats = SingleRoIExtractor((14, 14))(nhwc, _rois5(det_view))
    with record_function("mask_head"):
        cls_idx = torch.clamp(labels.repeat(v), 0, model.num_classes - 1)
        probs = 0.0
        for head in heads:
            probs = probs + torch.sigmoid(
                head.logits_for_labels(mfeats, cls_idx).float())
        probs = (probs / len(heads)).reshape(v, k, *probs.shape[1:])
        probs = torch.where(flips[:, None, None, None], probs.flip(3), probs)
        return probs.mean(0)


@torch.inference_mode()
def maskrcnn_aug_test(model, images: torch.Tensor,
                      scale_factors: torch.Tensor, flips: torch.Tensor,
                      content_hw: torch.Tensor, loss_cls,
                      cfg: DetTestCfg = DetTestCfg()
                      ) -> Dict[str, torch.Tensor]:
    """One image's aug-test: ``images`` (V, H, W, 3), every view on one
    canvas; ``scale_factors`` (V,), ``flips`` (V,) bool, ``content_hw``
    (V, 2) the resized content. Returns fixed-shape detections in the
    ORIGINAL image's frame: boxes (K, 4), scores (K,), labels (K,),
    valid (K,), and masks (K, 28, 28) probabilities with a mask head."""
    v = images.shape[0]
    sf, flips, cw, ch = _view_meta(scale_factors, flips, content_hw)
    nhwc, merged, merged_valid = _merged_aug_proposals(
        model, images, sf, flips, cw, cfg)
    r = merged.shape[0]
    with record_function("bbox_roi_align"):
        view_props = _boxes_to_view(merged[None], sf[:, None],
                                    flips[:, None], cw[:, None])
        roi_feats = SingleRoIExtractor((7, 7))(nhwc, _rois5(view_props))
    with record_function("bbox_head"):
        cls_score, bbox_pred, _ = model.roi_head.bbox_head(roi_feats)
        scores_v = _activation(loss_cls, cls_score).reshape(v, r, -1)
        boxes_v = delta2bbox(view_props.reshape(-1, 4), bbox_pred.float(),
                             BBOX_TARGET_MEANS, BBOX_TARGET_STDS)
        boxes_v = _clamp_view(boxes_v.reshape(v, r, -1, 4), cw, ch)
        boxes_orig = _boxes_from_view(boxes_v, sf[:, None, None],
                                      flips[:, None, None], cw[:, None, None])
    with record_function("bbox_nms"):
        mean_boxes = boxes_orig.mean(0)                 # (R, C or 1, 4)
        mean_scores = torch.where(merged_valid[:, None], scores_v.mean(0),
                                  torch.zeros((), device=images.device))
        out = _nms(mean_boxes.reshape(r, -1), mean_scores, cfg)
    if model.with_mask:
        out["masks"] = _mask_probs(model, nhwc, out["boxes"], out["labels"],
                                   sf, flips, cw, [model.roi_head.mask_head])
    return out


@torch.inference_mode()
def cascade_aug_test(model: CascadeMaskRCNN, images: torch.Tensor,
                     scale_factors: torch.Tensor, flips: torch.Tensor,
                     content_hw: torch.Tensor, loss_cls,
                     cfg: DetTestCfg = DetTestCfg()
                     ) -> Dict[str, torch.Tensor]:
    """The cascade's aug-test (``cascade_roi_head.py:458-530``): on each
    view the merged proposals run all stages, refined between stages by
    each stage's argmax foreground class and clamped to the view's
    content; the stages' activations (``loss_cls``, or a sequence of one
    a stage) averaged; then boxes and scores averaged over the views and
    one multiclass NMS; masks averaged over the stages and the views.
    Arguments and result as ``maskrcnn_aug_test``'s."""
    v = images.shape[0]
    n = model.num_classes
    losses = (list(loss_cls) if isinstance(loss_cls, (list, tuple))
              else [loss_cls] * model.num_stages)
    sf, flips, cw, ch = _view_meta(scale_factors, flips, content_hw)
    nhwc, merged, merged_valid = _merged_aug_proposals(
        model, images, sf, flips, cw, cfg)
    r = merged.shape[0]
    rois = _boxes_to_view(merged[None], sf[:, None], flips[:, None],
                          cw[:, None])                   # (V, R, 4)
    avg_scores = 0.0
    for stage in range(model.num_stages):
        with record_function(f"stage{stage}_bbox_roi_align"):
            roi_feats = SingleRoIExtractor((7, 7))(nhwc, _rois5(rois))
        with record_function(f"stage{stage}_bbox_head"):
            cls_score, bbox_pred, _ = model.roi_head.bbox_head[stage](
                roi_feats)
            avg_scores = avg_scores + _activation(losses[stage], cls_score)
            pred4 = _select_pred(bbox_pred, cls_score[:, :-1].argmax(-1), n,
                                 model.reg_class_agnostic)
            if stage < model.num_stages - 1:
                rois = _clamp_view(_refine(
                    rois.reshape(-1, 4), pred4, None,
                    model.stage_stds[stage]).reshape(v, r, 4), cw, ch)
    with record_function("bbox_nms"):
        final = _clamp_view(_refine(rois.reshape(-1, 4), pred4, None,
                                    model.stage_stds[-1]).reshape(v, r, 4),
                            cw, ch)
        boxes_orig = _boxes_from_view(final, sf[:, None], flips[:, None],
                                      cw[:, None])        # (V, R, 4)
        avg_scores = (avg_scores / model.num_stages).reshape(v, r, -1)
        mean_scores = torch.where(merged_valid[:, None], avg_scores.mean(0),
                                  torch.zeros((), device=images.device))
        out = _nms(boxes_orig.mean(0), mean_scores, cfg)
    if model.with_mask:
        out["masks"] = _mask_probs(model, nhwc, out["boxes"], out["labels"],
                                   sf, flips, cw,
                                   list(model.roi_head.mask_head))
    return out


def aug_test(model, images, scale_factors, flips, content_hw, loss_cls,
             cfg: DetTestCfg = DetTestCfg()) -> Dict[str, torch.Tensor]:
    """The family's aug-test, as ``cli/test_det.py:177-230`` picks it: a
    cascade (HTC included) ``cascade_aug_test``, MaskRCNN
    ``maskrcnn_aug_test``. HTC with masks and C4, where JAX fails, raise
    ``NotImplementedError``."""
    if isinstance(model, HTC) and model.with_mask:
        raise NotImplementedError(
            "--tta with HTC's mask branch is not ported: JAX's "
            "cascade_aug_test asks HTC for the cascade's mask_head_{i}, "
            "which HTC does not build, and fails")
    if isinstance(model, C4FasterRCNN):
        raise NotImplementedError(
            "--tta with Faster R-CNN C4 is not ported: JAX's "
            "maskrcnn_aug_test takes C4's one stride-16 map for FPN levels "
            "and fails")
    if isinstance(model, CascadeMaskRCNN):
        return cascade_aug_test(model, images, scale_factors, flips,
                                content_hw, loss_cls, cfg)
    return maskrcnn_aug_test(model, images, scale_factors, flips,
                             content_hw, loss_cls, cfg)
