"""MaskRCNN R50-FPN, its training loss and its inference pass: port of
``iif_tpu/detection/detector.py`` (``MaskRCNN`` in its resnet + fpn +
shared2fc + FCN-mask configuration with the linear, the cosine-normed or
the IIF-normed predictors, Seesaw's C+2 classifier and its counts and
FASA in its loss, ``DetTrainCfg``, ``DetTestCfg``,
``normalize_if_uint8``, ``unpack_mask_bits``, ``resolve_gt_masks``,
``make_anchor_generator``, ``fpn_shapes``, ``maskrcnn_loss``,
``maskrcnn_simple_test``).

The module holds mmdet's state_dict names (``backbone.*``, ``neck.*``,
``rpn_head.*``, ``roi_head.bbox_head.*``, ``roi_head.mask_head.*``), so an
mmdet checkpoint loads as it is. Images enter as (B, H, W, 3) like the JAX
package's; inside the trunk they are NCHW in ``channels_last`` memory, so
each FPN map permuted to NHWC is a contiguous (B, H, W, C) view for the
RoIAlign kernels. Each stage of ``maskrcnn_loss`` and
``maskrcnn_simple_test`` is a named ``record_function`` span, so a
``torch.profiler`` trace splits a step or a request by stage (a no-op
when no profiler runs).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from iif_torch.detection.bbox_head import (
    Shared2FCBBoxHead,
    bbox_head_get_bboxes,
    bbox_head_loss,
    bbox_targets,
)
from iif_torch.detection.fasa import fasa_aug_loss, fasa_update
from iif_torch.detection.losses_extra import SeesawLoss
from iif_torch.detection.mask_head import (
    FCNMaskHead,
    mask_head_loss,
    mask_targets,
)
from iif_torch.detection.necks import FPN
from iif_torch.detection.roi_extractor import SingleRoIExtractor
from iif_torch.detection.rpn import RPNHead, rpn_loss, rpn_proposals
from iif_torch.models.resnet import ResNet
from iif_torch.ops.anchors import AnchorGenerator

_DEPTH_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

# ImageNet pixel stats (0-255 scale) for device-side normalisation of uint8
# canvases.
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def normalize_if_uint8(images: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std when the canvas arrives as raw uint8 pixels;
    identity for already-normalised float input. (..., 3) layout."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.tensor(IMG_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMG_STD, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std


def unpack_mask_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of ``np.packbits(masks, axis=-1)`` (big-endian bits) on the
    tensor's device: (..., W/8) uint8 -> (..., width) uint8 in {0, 1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :width]


def resolve_gt_masks(batch: Dict[str, torch.Tensor], mask_width: int
                     ) -> torch.Tensor:
    """gt masks from the dense ``gt_masks`` key or the bit-packed
    ``gt_masks_packed`` key (unpacked on the device)."""
    if "gt_masks" in batch:
        return batch["gt_masks"]
    return unpack_mask_bits(batch["gt_masks_packed"], mask_width)


class StandardRoIHead(nn.Module):
    """Container for mmdet's ``roi_head.bbox_head`` / ``roi_head.mask_head``
    names."""

    def __init__(self, num_classes: int, with_mask: bool,
                 cls_init: tuple = ("normal", 0.01),
                 cls_predictor: str = "linear", mask_predictor: str = "conv",
                 cls_temperature: float = 8.0,
                 mask_temperature: float = 20.0, cls_channels: int = 0,
                 iif_weights=()):
        super().__init__()
        self.bbox_head = Shared2FCBBoxHead(
            num_classes, cls_init=cls_init, cls_predictor=cls_predictor,
            cls_temperature=cls_temperature, cls_channels=cls_channels,
            iif_weights=iif_weights)
        self.mask_head = FCNMaskHead(
            num_classes, predictor=mask_predictor,
            temperature=mask_temperature) if with_mask else None


def resnet_groups(backbone_type: str) -> Tuple[int, int]:
    """``backbone_type`` -> (groups, width_per_group) of the trunk's
    ResNet, as ``build_backbone`` parses it (``detector.py:400-403``):
    ``"resnet"`` (1, 64), ``"resnext<G>x<W>d"`` (G, W). Any other value
    raises ``NotImplementedError`` with its name."""
    if backbone_type == "resnet":
        return 1, 64
    if backbone_type.startswith("resnext"):
        g, w = backbone_type[len("resnext"):].split("x")
        return int(g), int(w.rstrip("d"))
    raise NotImplementedError(
        f"backbone_type {backbone_type!r} is not ported")


class TwoStageTrunk(nn.Module):
    """The ResNet + FPN + RPN trunk the two-stage detectors share, and
    their anchors. ``backbone_type`` is ``"resnet"`` or a ResNeXt
    (``"resnext32x4d"``: grouped 3x3 convolutions, ``resnet_groups``);
    ``frozen_stages`` and ``norm_eval`` shape the trunk's training;
    ``compute_dtype`` is the trunk's (``"bfloat16"`` in the IIF
    configs)."""

    def __init__(self, num_classes: int, depth: int, with_mask: bool,
                 frozen_stages: int, norm_eval: bool, compute_dtype,
                 backbone_type: str = "resnet"):
        super().__init__()
        if isinstance(compute_dtype, str):
            compute_dtype = _DTYPES[compute_dtype]
        groups, width = resnet_groups(backbone_type)
        self.num_classes = num_classes
        self.with_mask = with_mask
        self.backbone = ResNet(_DEPTH_LAYERS[depth], frozen_stages,
                               norm_eval, compute_dtype, groups=groups,
                               width_per_group=width)
        self.neck = FPN(compute_dtype=compute_dtype)
        self.rpn_head = RPNHead(num_anchors=3, compute_dtype=compute_dtype)
        self._anchors: Dict[Any, list] = {}

    def extract_feat(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) uint8 or normalised float -> 5 FPN maps, NCHW
        (P2..P5 in channels_last memory)."""
        x = normalize_if_uint8(images).permute(0, 3, 1, 2)
        feats = self.neck(self.backbone(x))
        return tuple(f.contiguous(memory_format=torch.channels_last)
                     if i < 4 else f for i, f in enumerate(feats))

    def anchors(self, img_hw: Tuple[int, int], device) -> list:
        """Per-level anchors on ``device`` for a canvas, built once."""
        key = (tuple(img_hw), str(device))
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(device) for a in
                make_anchor_generator().grid_anchors(fpn_shapes(img_hw))]
        return self._anchors[key]

    def train_anchors(self, img_hw: Tuple[int, int], device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All levels' anchors concatenated (A_tot, 4) and their
        inside-the-image flags (A_tot,), built once per canvas."""
        key = ("train", tuple(img_hw), str(device))
        if key not in self._anchors:
            gen = make_anchor_generator()
            shapes = fpn_shapes(img_hw)
            self._anchors[key] = (
                torch.from_numpy(np.concatenate(gen.grid_anchors(shapes))
                                 ).to(device),
                torch.from_numpy(np.concatenate(gen.valid_flags(
                    shapes, tuple(img_hw)))).to(device))
        return self._anchors[key]


class MaskRCNN(TwoStageTrunk):
    """Takes the keyword arguments of a ``configs/`` model dict.
    ``backbone_type`` as ``TwoStageTrunk`` takes it; ``cls_predictor`` is
    ``"linear"``, ``"normed"`` (``NormedLinear`` at ``cls_temperature``)
    or ``"iif_normed"`` (``IIFNormedLinear`` with ``iif_weights``),
    ``cls_channels`` the classifier's width (0: C+1; Seesaw's C+2, which
    the CLIs set, ``inference.model_cfg_for_loss``), ``mask_predictor``
    ``"conv"`` or ``"normed"`` (``NormedConv2d`` at
    ``mask_temperature``); ``cls_init`` initialises a linear ``fc_cls``
    in fresh weights (``fresh_init_``, as the JAX package's
    ``model.init``)."""

    def __init__(self, num_classes: int = 1203, depth: int = 50,
                 with_mask: bool = True, frozen_stages: int = 1,
                 norm_eval: bool = True, compute_dtype=None,
                 backbone_type: str = "resnet",
                 cls_predictor: str = "linear", mask_predictor: str = "conv",
                 cls_temperature: float = 8.0, mask_temperature: float = 20.0,
                 cls_init: tuple = ("normal", 0.01), cls_channels: int = 0,
                 iif_weights=()):
        super().__init__(num_classes, depth, with_mask, frozen_stages,
                         norm_eval, compute_dtype, backbone_type)
        self.roi_head = StandardRoIHead(
            num_classes, with_mask, cls_init, cls_predictor, mask_predictor,
            cls_temperature, mask_temperature, cls_channels, iif_weights)

    def forward_cls_only(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.roi_head.bbox_head.cls_only(embedding)


class DetTrainCfg(NamedTuple):
    """``iif_tpu``'s ``DetTrainCfg`` as the headline config uses it: the
    random samplers and the L1 box loss. Its other knobs (OHEM and the
    other samplers, Dynamic R-CNN, ISR, CARL) are not ported, and
    ``train_cfg_from_dict`` refuses them."""
    rpn_num_samples: int = 256
    rpn_pos_fraction: float = 0.5
    rpn_nms_pre: int = 1000          # candidates per level before NMS
    rpn_max_per_img: int = 1000
    rpn_nms_iou: float = 0.7
    rcnn_num_samples: int = 512
    rcnn_pos_fraction: float = 0.25
    mask_size: int = 28
    num_mask_rois: int = 128         # = rcnn_num_samples * pos_fraction
    mask_gt_stride: int = 1          # gt masks stored at 1/s canvas res


# Knobs of the JAX package's DetTrainCfg and the only value the port takes.
# ``roi_ext`` picks a RoIAlign route there ("ml" kernel or "flat" gather,
# the same function); the port has one route for both.
_TRAIN_CFG_FIXED = {"rcnn_loss_bbox": "l1", "rcnn_pos_sampler": "random",
                    "rcnn_neg_sampler": "random", "rcnn_sampler_cfg": (),
                    "rcnn_dynamic": False, "rcnn_isr": (), "rcnn_carl": ()}
_TRAIN_CFG_DROPPED = ("roi_ext", "dynamic_iou_topk", "dynamic_beta_topk",
                      "dynamic_interval", "dynamic_initial_iou",
                      "dynamic_initial_beta")


def train_cfg_from_dict(tc: Dict[str, Any]) -> DetTrainCfg:
    """A config's ``train_cfg`` dict -> ``DetTrainCfg``. Raises
    ``NotImplementedError`` for a knob value that is not ported."""
    kw = {}
    for k, v in tc.items():
        if k in _TRAIN_CFG_FIXED:
            if (tuple(v) if isinstance(v, list) else v) != \
                    _TRAIN_CFG_FIXED[k]:
                raise NotImplementedError(f"train_cfg.{k}={v!r} is not "
                                          "ported")
        elif k not in _TRAIN_CFG_DROPPED:
            kw[k] = v
    return DetTrainCfg(**kw)


class DetTestCfg(NamedTuple):
    rpn_nms_pre: int = 1000
    rpn_max_per_img: int = 1000
    rpn_nms_iou: float = 0.7
    score_thr: float = 0.05          # LVIS configs use 1e-4
    nms_iou: float = 0.5
    max_per_img: int = 100           # LVIS: 300
    nms_kind: str = "nms"            # only exact greedy "nms" is ported
    mask_thr_binary: float = 0.5


def make_anchor_generator() -> AnchorGenerator:
    """RPN anchors of every IIF config: scales [8], ratios [0.5, 1, 2],
    strides [4, 8, 16, 32, 64]."""
    return AnchorGenerator(strides=[4, 8, 16, 32, 64],
                           ratios=[0.5, 1.0, 2.0], scales=[8.0])


def fpn_shapes(img_hw: Tuple[int, int], num_levels: int = 5):
    h, w = img_hw
    return [(-(-h // s), -(-w // s)) for s in (4, 8, 16, 32, 64)][:num_levels]


def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for the parity tests and for serving without
    a checkpoint (training starts from ``detection/init.py::fresh_init_``,
    JAX's init), at scales that keep a deep trunk finite and the heads'
    outputs spread, random BN statistics included:
    normal(0, 1/sqrt(fan_in)) weights, BN scale in [0.5, 1] (the residual
    ``bn3`` in [0.1, 0.3]), small random shifts and BN statistics. A
    model's ``init_std`` maps weight names to a normal std of their own."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform(t, lo, hi):
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=generator))

    init_std = getattr(model, "init_std", {})
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            *mods, leaf = name.split(".")
            if leaf in ("num_batches_tracked", "iif"):   # iif: the data's
                continue
            if name in init_std:
                normal(t, init_std[name])
            elif any(m.startswith("bn") for m in mods) \
                    or "downsample.1" in name:
                if leaf == "weight":
                    lo, hi = (0.1, 0.3) if ".bn3" in name else (0.5, 1.0)
                    uniform(t, lo, hi)
                elif leaf in ("bias", "running_mean"):
                    normal(t, 0.1)
                elif leaf == "running_var":
                    uniform(t, 0.5, 1.5)
            elif leaf == "bias":
                normal(t, 0.01)
            else:
                normal(t, 1.0 / math.sqrt(t[0].numel()))
    return model


def maskrcnn_loss(
    model: MaskRCNN,
    batch: Dict[str, torch.Tensor],
    loss_cls,
    cfg: DetTrainCfg = DetTrainCfg(),
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
    fasa_state=None,
    fasa_cfg: Optional[Dict[str, float]] = None,
    epoch: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Forward and every loss of one batch (``detector.py:445-815`` for
    the resnet + fpn + shared2fc + FCN-mask body, FASA included).

    batch: ``image`` (B, H, W, 3) uint8 or normalised float,
    ``gt_boxes`` (B, G, 4), ``gt_labels`` (B, G), ``gt_valid`` (B, G),
    and ``gt_masks`` (B, G, H/s, W/s) or ``gt_masks_packed`` (B, G, H/s,
    W/s/8) with s = ``cfg.mask_gt_stride``. The samplers draw their noise
    from ``generator``, or take it from ``noise``: ``{"rpn": (pos, neg)}``
    each (B, A_tot), ``{"rcnn": (pos, neg)}`` each (B, G + P) and
    ``{"fasa": (uniform (C,), normal (C, 1024))}``.

    With a ``fasa_state`` (``detection/fasa.py``) the positives'
    embeddings update it and, from ``epoch`` 1, the virtual features' CE
    through ``fc_cls`` joins ``loss_cls`` (``fasa_cfg``: ``decay_ratio``,
    ``loss_aug_weight``). With a ``SeesawLoss`` the sampled labels of
    weight > 0 join its ``cum_samples`` before the loss (and FASA's aug
    loss) reads them.

    Returns (total, losses, aux): ``losses`` has the JAX package's keys
    (``loss_cls``, ``loss_bbox``, ``loss_rpn_cls``, ``loss_rpn_bbox``,
    ``loss_mask``); ``aux`` holds the new ``fasa_state`` when one was
    given, Seesaw's new ``seesaw_cum`` and the positives' accuracy
    ``acc`` (``get_accuracy``, in %) (the JAX package's also carries the
    BN statistics, which ``norm_eval`` leaves as they are)."""
    noise = noise or {}
    images = batch["image"]
    b, img_h, img_w, _ = images.shape
    dev = images.device
    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]

    with record_function("backbone_fpn"):
        feats = model.extract_feat(images)
    with record_function("rpn_loss"):
        cls_scores, bbox_preds = model.rpn_head(feats)
        anchors, anchor_valid = model.train_anchors((img_h, img_w), dev)
        l_rpn_cls, l_rpn_bbox = rpn_loss(
            cls_scores, bbox_preds, anchors, anchor_valid, gt_boxes,
            gt_valid, num_samples=cfg.rpn_num_samples,
            pos_fraction=cfg.rpn_pos_fraction, noise=noise.get("rpn"),
            generator=generator)
    with record_function("rpn_proposals"):
        proposals, _, prop_valid = rpn_proposals(
            [s.detach() for s in cls_scores],
            [d.detach() for d in bbox_preds],
            model.anchors((img_h, img_w), dev), (img_h, img_w),
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
    nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]
    with record_function("bbox_roi_align"):
        roi_feats = SingleRoIExtractor((7, 7))(nhwc, rois5)
    aux: Dict[str, Any] = {}
    if isinstance(loss_cls, SeesawLoss):
        # the step's valid labels counted before the loss reads them
        # (detector.py:579-590); the new counts ride ``aux``
        aux["seesaw_cum"] = loss_cls.update_cum(
            tgts.labels.reshape(-1), tgts.label_weights.reshape(-1))
        loss_cls = loss_cls.with_cum(aux["seesaw_cum"])
    with record_function("bbox_head_loss"):
        cls_score, bbox_pred, embedding = model.roi_head.bbox_head(
            roi_feats)
        l_cls, l_bbox = bbox_head_loss(cls_score, bbox_pred, tgts, loss_cls,
                                       model.num_classes)
        if "seesaw_cum" in aux:
            aux["acc"] = loss_cls.get_accuracy(cls_score.detach(),
                                               tgts.labels.reshape(-1))
    losses = {"loss_cls": l_cls, "loss_bbox": l_bbox,
              "loss_rpn_cls": l_rpn_cls, "loss_rpn_bbox": l_rpn_bbox}
    if fasa_state is not None:
        with record_function("fasa"):
            aux["fasa_state"], l_aug = fasa_step(
                fasa_state, embedding, tgts.labels.reshape(-1),
                tgts.bbox_weights.reshape(-1), model.forward_cls_only,
                loss_cls, fasa_cfg, epoch, generator, noise.get("fasa"))
        if l_aug is not None:
            losses["loss_cls"] = losses["loss_cls"] + l_aug

    if model.with_mask:
        # positives lead each image's slate
        m = cfg.num_mask_rois
        with record_function("mask_targets"):
            pos_rois5 = rois5.reshape(b, r, 5)[:, :m].reshape(-1, 5)
            pos_w = tgts.bbox_weights[:, :m].reshape(-1)
            pos_gt = tgts.pos_gt_inds[:, :m].reshape(-1)
            pos_labels = tgts.labels[:, :m].reshape(-1)
            gt_masks = resolve_gt_masks(batch, img_w // cfg.mask_gt_stride)
            mask_tgt = mask_targets(pos_rois5, pos_gt, gt_masks,
                                    cfg.mask_size,
                                    gt_stride=cfg.mask_gt_stride)
        with record_function("mask_roi_align"):
            mask_feats = SingleRoIExtractor((14, 14))(nhwc, pos_rois5)
        with record_function("mask_head_loss"):
            cls_idx = torch.clamp(pos_labels, 0, model.num_classes - 1)
            mask_pred = model.roi_head.mask_head.logits_for_labels(
                mask_feats, cls_idx)
            losses["loss_mask"] = mask_head_loss(mask_pred, mask_tgt, pos_w)

    return sum(losses.values()), losses, aux


def fasa_step(state, embedding: torch.Tensor, labels: torch.Tensor,
              pos_weight: torch.Tensor, cls_only, loss_cls,
              fasa_cfg: Optional[Dict[str, float]], epoch: int,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[Any, Optional[torch.Tensor]]:
    """One head's FASA work in a training step (``detector.py:709-725``):
    the EMA statistics from the positives' embeddings, then from ``epoch``
    1 the virtual features' CE through ``cls_only``. Returns the new state
    and that loss (None before epoch 1)."""
    fcfg = fasa_cfg or {}
    state = fasa_update(state, embedding, labels, pos_weight,
                        decay_ratio=fcfg.get("decay_ratio", 0.1))
    if epoch < 1:
        return state, None
    return state, fasa_aug_loss(
        state, cls_only, loss_cls,
        loss_aug_weight=fcfg.get("loss_aug_weight", 0.1),
        generator=generator, noise=noise)


@torch.inference_mode()
def maskrcnn_simple_test(
    model: MaskRCNN,
    images: torch.Tensor,
    loss_cls,
    cfg: DetTestCfg = DetTestCfg(),
    scale_factor: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Inference on (B, H, W, 3) canvases: fixed-shape per-image detections
    (boxes (B,K,4), scores (B,K), labels (B,K), valid (B,K), masks
    (B,K,28,28) probabilities for the predicted class)."""
    if cfg.nms_kind != "nms":
        raise NotImplementedError(f"nms_kind {cfg.nms_kind!r} is not ported")
    b, img_h, img_w, _ = images.shape
    dev = images.device
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
    with record_function("bbox_roi_align"):
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=dev).repeat_interleave(p)
        rois5 = torch.cat([batch_idx[:, None], proposals.reshape(-1, 4)], 1)
        roi_feats = SingleRoIExtractor((7, 7))(nhwc, rois5)
    with record_function("bbox_head"):
        cls_score, bbox_pred, _ = model.roi_head.bbox_head(roi_feats)
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
    out = {"boxes": dets, "scores": scores, "labels": labels,
           "valid": det_valid}

    if model.with_mask:
        k = dets.shape[1]
        with record_function("mask_roi_align"):
            batch_idx2 = torch.arange(b, dtype=torch.float32,
                                      device=dev).repeat_interleave(k)
            det_rois = torch.cat([batch_idx2[:, None], dets.reshape(-1, 4)],
                                 1)
            mfeats = SingleRoIExtractor((14, 14))(nhwc, det_rois)
        with record_function("mask_head"):
            cls_idx = torch.clamp(labels.reshape(-1), 0,
                                  model.num_classes - 1)
            sel = model.roi_head.mask_head.logits_for_labels(mfeats, cls_idx)
            probs = torch.sigmoid(sel.float())
            out["masks"] = probs.reshape(b, k, *probs.shape[1:])

    if scale_factor is not None:
        out["boxes"] = out["boxes"] / scale_factor[:, None, :]
    return out


def build_detector(model_cfg: Dict[str, Any]) -> nn.Module:
    """Config dict (``cfg.model``) -> ``MaskRCNN``, ``CascadeMaskRCNN``
    (type ``CascadeMaskRCNN`` or ``CascadeRCNN``, as the JAX registry
    takes both), ``HTC`` (type ``HTC`` or ``HybridTaskCascade``) or
    ``C4FasterRCNN`` (``iif_tpu/detection/__init__.py``). Other families
    are not ported."""
    kw = dict(model_cfg)
    kind = kw.pop("type", "MaskRCNN")
    kw.pop("pretrained_backbone", None)
    if kind in ("HTC", "HybridTaskCascade"):
        from iif_torch.detection.htc import HTC

        return HTC(**kw)
    if kind in ("CascadeMaskRCNN", "CascadeRCNN"):
        from iif_torch.detection.cascade import CascadeMaskRCNN

        return CascadeMaskRCNN(**kw)
    if kind == "FasterRCNNC4":
        from iif_torch.detection.c4 import C4FasterRCNN

        for k in ("cls_predictor", "mask_predictor"):
            kw.pop(k, None)
        return C4FasterRCNN(**kw)
    if kind != "MaskRCNN":
        raise NotImplementedError(f"detector type {kind!r} is not ported")
    return MaskRCNN(**kw)
