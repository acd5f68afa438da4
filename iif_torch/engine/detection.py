"""Detection trainer: port of ``iif_tpu/engine/detection.py``
(``DetectionTrainer`` with ``init_state``, one train step with gradient
accumulation, ``train_one_epoch``, the FASA val pass ``fasa_val_epoch``
with ``_fasa_accumulate_batch``, and ``frozen_backbone_mask``) for the
MaskRCNN, Cascade Mask R-CNN, HTC and Faster R-CNN C4 losses, with
FASA's and Seesaw's state and no EMA or Dynamic R-CNN state. The step
dispatches on the model as the JAX trainer does (``engine/
detection.py:307-335``): ``maskrcnn_loss`` for ``MaskRCNN``, ``htc_loss``
for ``HTC`` and ``cascade_loss`` for ``CascadeMaskRCNN`` (their stages
share the one loss), ``c4_loss`` for ``C4FasterRCNN``; other families
raise. FASA with HTC raises, as JAX's ``htc_loss`` takes no FASA state;
``SeesawLoss`` with any family but MaskRCNN raises, as JAX threads its
counts through ``maskrcnn_loss`` only.

FASA's state (``detection/fasa.py``; one ``FasaState`` a stage for the
cascade) and Seesaw's ``cum_samples`` (``seesaw_cum``) ride in the train
state; the aug loss is on from epoch 1 (``fasa_aug_on``,
``engine/detection.py:469-470``).

With ``grad_accum`` n > 1 the batch splits along axis 0 into n
micro-batches, taken in order (``engine/detection.py:346-380``, JAX's
``lax.scan``): FASA's and Seesaw's state thread through them, each
backward adds its gradient, and the sum is divided by n before the
optimizer; the metrics are the micro-batches' means.

The JAX step folds ``step`` (``step * n + i`` for micro-batch i) into its
base key; here each (micro-)batch draws its sampling noise from a
``torch.Generator`` seeded from ``(seed, step * n + i)``, and the FASA
val pass from ``(seed, step + 999_983)``. The step returns the JAX
package's metrics: the losses and their sum under ``"loss"``, with
gradient clipping the global norm under ``"grad_norm"``, and with Seesaw
the positives' accuracy under ``"acc"`` (its ``get_accuracy``), as device
tensors (nothing syncs with the host). The backward and the optimizer
are ``record_function`` spans (``backward``, ``optimizer``) beside the
loss's stage spans.

``train_one_epoch`` reads the metrics back asynchronously, as the JAX
package's does: a step's metrics wait in a window of ``SYNC_WINDOW``
steps and are read back (one copy a step) when it fills, and all of them
at each print point; a non-finite loss raises ``FloatingPointError`` at
read-back (mmdet's ``CheckInvalidLossHook`` fires at that granularity
too).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from iif_torch.detection.bbox_head import bbox_targets
from iif_torch.detection.c4 import C4FasterRCNN, c4_loss
from iif_torch.detection.cascade import (
    STAGE_IOUS,
    CascadeMaskRCNN,
    _refine,
    _rois5,
    _select_pred,
    cascade_loss,
)
from iif_torch.detection.detector import (
    DetTrainCfg,
    MaskRCNN,
    build_detector,
    maskrcnn_loss,
    train_cfg_from_dict,
)
from iif_torch.detection.fasa import (
    fasa_accumulate_val,
    fasa_dynamic_sampling,
    init_fasa_state,
)
from iif_torch.detection.htc import HTC, htc_loss
from iif_torch.detection.inference import model_cfg_for_loss
from iif_torch.detection.init import fresh_init_
from iif_torch.detection.losses_extra import SeesawLoss
from iif_torch.detection.roi_extractor import SingleRoIExtractor
from iif_torch.detection.rpn import rpn_proposals
from iif_torch.device import resolve_device
from iif_torch.engine.schedules import (
    build_lr_schedule,
    build_optimizer,
    flax_offset_params,
    norm_decay_mask,
)
from iif_torch.utils.metrics import MetricLogger

# the batch keys the losses read (``engine/detection.py:455-460``, less
# the semantic maps and proposals the port does not train with)
FEED_KEYS = ("image", "gt_boxes", "gt_labels", "gt_valid", "gt_masks",
             "gt_masks_packed")
VAL_KEYS = FEED_KEYS[:4]  # the FASA val pass moves no masks
VAL_STEP_OFFSET = 999_983  # the val pass's draws: (seed, step + this)
SYNC_WINDOW = 4           # steps of metrics in flight before a read-back


def frozen_param(name: str, frozen_stages: int) -> bool:
    """Whether the mmdet-named parameter belongs to the frozen stem or to
    a stage <= ``frozen_stages`` (``frozen_backbone_mask``,
    ``engine/detection.py:592-610``): the names whose ``requires_grad``
    ``ResNet`` turns off, which is what the optimizer reads."""
    if frozen_stages < 0:
        return False
    prefixes = ["backbone.conv1.", "backbone.bn1."] + [
        f"backbone.layer{s}." for s in range(1, frozen_stages + 1)]
    return any(name.startswith(p) for p in prefixes)


@dataclass
class DetTrainState:
    step: int
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    fasa: Any = None     # a FasaState, a tuple of one a stage, or None
    seesaw_cum: Optional[torch.Tensor] = None   # SeesawLoss's (C+1,)


def init_fasa_states(model, instance_counts: np.ndarray,
                     fasa_cfg: Dict[str, Any], device=None):
    """FASA's initial state for ``model`` from the train set's instance
    counts (``cli/train_det.py:243-260``): one ``FasaState``, or for a
    cascade one independent copy a stage."""
    fcfg = fasa_cfg or {}

    def one():
        return init_fasa_state(
            np.maximum(instance_counts, 1), feat_dim=1024,
            instance_prob_power=fcfg.get("instance_prob_power", 1.0),
            instance_prob_scale=fcfg.get("instance_prob_scale", 1.0),
            device=device)

    if isinstance(model, CascadeMaskRCNN):
        return tuple(one() for _ in range(model.num_stages))
    return one()


class DetectionTrainer:
    """Trains ``model`` (a ``MaskRCNN``, a ``CascadeMaskRCNN``, an ``HTC``
    or a ``C4FasterRCNN``, on ``device``, default the card) with ``loss_cls``
    under ``lr_schedule``; ``optimizer_cfg`` is the config's ``optimizer``
    dict (type, momentum, weight_decay), ``grad_clip`` the global-norm
    bound of ``optimizer_config.grad_clip``, ``fasa_cfg`` the config's
    (decay_ratio, loss_aug_weight, dynamic_up, dynamic_down),
    ``grad_accum`` the micro-batches a step (``data.grad_accum``) and
    ``norm_decay`` False to take the normalisation layers' parameters
    out of the weight decay (``norm_decay_mask``)."""

    def __init__(self, model: Union[MaskRCNN, CascadeMaskRCNN,
                                    C4FasterRCNN], loss_cls,
                 lr_schedule: Callable[[int], float],
                 train_cfg: DetTrainCfg = DetTrainCfg(),
                 optimizer_cfg: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 grad_clip: Optional[float] = None,
                 fasa_cfg: Optional[Dict[str, Any]] = None,
                 grad_accum: int = 1, norm_decay: bool = True):
        if fasa_cfg is not None and isinstance(model, HTC):
            raise NotImplementedError(
                "FASA with HTC is not ported (JAX's htc_loss takes no FASA "
                "state)")
        if isinstance(loss_cls, SeesawLoss) and \
                _loss_fn(model) is not maskrcnn_loss:
            raise NotImplementedError(
                f"SeesawLoss with {type(model).__name__} is not ported "
                "(JAX threads its counts through maskrcnn_loss only)")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.device = resolve_device(device)
        self.loss_fn = _loss_fn(model)
        self.model = model.to(self.device).train()
        self.loss_cls = loss_cls.to(self.device)
        self.lr_schedule = lr_schedule
        self.train_cfg = train_cfg
        self.optimizer_cfg = dict(optimizer_cfg or {})
        self.seed = seed
        self.grad_clip = grad_clip
        self.fasa_cfg = fasa_cfg
        self.grad_accum = int(grad_accum)
        self.norm_decay = norm_decay

    def init_state(self, fasa_state=None) -> DetTrainState:
        """Optimizer state over the trainable parameters, at step 0,
        FASA's state (``init_fasa_states``) when it trains with FASA, and
        Seesaw's counts (the loss's, zeros from the CLI) with Seesaw."""
        ocfg = self.optimizer_cfg
        decay = norm_decay_mask(self.model)
        opt, sched = build_optimizer(
            ocfg.get("type", "sgd"), self.model.parameters(),
            self.lr_schedule, ocfg.get("momentum", 0.9),
            ocfg.get("weight_decay", 1e-4), grad_clip=self.grad_clip,
            no_decay=() if self.norm_decay else [
                p for n, p in self.model.named_parameters()
                if not decay[n]],
            decay_offset=flax_offset_params(self.model))
        cum = (self.loss_cls.cum_samples.clone()
               if isinstance(self.loss_cls, SeesawLoss) else None)
        return DetTrainState(0, opt, sched, fasa_state, cum)

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            ((self.seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))

    def train_step(self, state: DetTrainState,
                   batch: Dict[str, Any],
                   noise: Union[None, Dict[str, Any],
                                List[Optional[Dict[str, Any]]]] = None,
                   epoch: int = 0
                   ) -> Tuple[DetTrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (see ``maskrcnn_loss``,
        ``cascade_loss`` or ``c4_loss`` for its keys; ``noise`` as there,
        with ``grad_accum`` > 1 a list of one a micro-batch) in ``epoch``
        (FASA's aug loss from epoch 1). Updates the model and ``state``
        in place and returns them with the metrics."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        self.model.train()
        n = self.grad_accum
        micro = split_micro_batches(batch, n)
        noises = [noise] if n == 1 else list(noise or [None] * n)
        totals, per_losses = [], []
        for i, mb in enumerate(micro):
            kwargs = {}
            if state.fasa is not None:
                kwargs = {"fasa_state": state.fasa,
                          "fasa_cfg": self.fasa_cfg,
                          "epoch": 1 if epoch >= 1 else 0}
            loss_cls = (self.loss_cls if state.seesaw_cum is None
                        else self.loss_cls.with_cum(state.seesaw_cum))
            total, losses, aux = self.loss_fn(
                self.model, mb, loss_cls, self.train_cfg,
                generator=self._generator(state.step * n + i),
                noise=noises[i], **kwargs)
            with record_function("backward"):
                if i == 0:
                    state.optimizer.zero_grad(set_to_none=True)
                total.backward()
            state.fasa = aux.get("fasa_state", state.fasa)
            state.seesaw_cum = aux.get("seesaw_cum", state.seesaw_cum)
            totals.append(total.detach())
            per_losses.append({k: v.detach() for k, v in losses.items()})
            if "acc" in aux:
                per_losses[-1]["acc"] = aux["acc"]
        if n > 1:
            # JAX sums the micro-batches' gradients, then divides by n
            with record_function("backward"):
                torch._foreach_div_([p.grad for p in self.model.parameters()
                                     if p.grad is not None], float(n))
        with record_function("optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        metrics = {k: torch.stack([m[k] for m in per_losses]).mean()
                   for k in per_losses[0]}
        metrics["loss"] = torch.stack(totals).mean()
        if state.optimizer.grad_clip is not None:
            metrics["grad_norm"] = state.optimizer.grad_clip.last_norm
        return state, metrics

    def train_one_epoch(self, state: DetTrainState, loader, epoch: int,
                        print_freq: int = 50, log_writer=None
                        ) -> Tuple[DetTrainState, MetricLogger]:
        """One epoch of ``loader`` (``engine/detection.py:417-482``):
        ``loader.set_epoch(epoch)``, a step a batch on its ``FEED_KEYS``,
        the metrics read back as the module notes say, a ``.log.json``
        record (with the learning rate) at each print point when
        ``log_writer`` is given. Closes the loader's iterator before it
        returns or raises."""
        logger = MetricLogger()
        loader.set_epoch(epoch)
        total = len(loader)

        def sink(rec):
            if log_writer is None:
                return
            step = state.step - 1            # the step just taken
            log_writer.write({"mode": "train", "epoch": epoch + 1, **rec,
                              "lr": float(self.lr_schedule(step))},
                             step=step)

        pending: List[Dict[str, torch.Tensor]] = []

        def absorb(metrics):
            keys = list(metrics)
            host = dict(zip(keys, torch.stack(
                [metrics[k].float() for k in keys]).tolist()))
            if not math.isfinite(host.get("loss", 0.0)):
                raise FloatingPointError(
                    f"loss became non-finite at epoch {epoch} "
                    f"(metrics: {host})")
            logger.update(**host)

        batches = iter(loader)
        try:
            for i, batch in enumerate(logger.log_every(
                    batches, print_freq, f"Epoch: [{epoch}]", total=total,
                    sink=sink)):
                # the epoch matters only to FASA (its aug loss)
                state, metrics = self.train_step(
                    state, {k: v for k, v in batch.items()
                            if k in FEED_KEYS},
                    **({} if getattr(state, "fasa", None) is None
                       else {"epoch": epoch}))
                pending.append(metrics)
                if print_freq and (i % print_freq == 0 or i == total - 1):
                    while pending:
                        absorb(pending.pop(0))
                elif len(pending) >= SYNC_WINDOW:
                    absorb(pending.pop(0))
            while pending:
                absorb(pending.pop(0))
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        return state, logger

    def fasa_val_epoch(self, state: DetTrainState, loader,
                       print_fn=print) -> DetTrainState:
        """The dynamic runner's val pass (``engine/detection.py:485-509``,
        the reference's ``epoch_based_dynamic_runner.py:48-86``): each
        batch of ``loader`` (the val set through the train pipeline)
        adds its per-class losses to FASA's counters, then each stage's
        ``fasa_dynamic_sampling`` runs; its seconds and each stage's
        ``prob_list`` are printed. Returns ``state`` with the new FASA
        state."""
        fasa = state.fasa
        batches = iter(loader)
        try:
            for batch in batches:
                fasa = self._fasa_accumulate_batch(
                    state, {k: torch.as_tensor(v, device=self.device)
                            for k, v in batch.items() if k in VAL_KEYS},
                    fasa)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        fcfg = self.fasa_cfg or {}
        up, down = fcfg.get("dynamic_up", 1.1), fcfg.get("dynamic_down", 0.9)
        stages = fasa if isinstance(self.model, CascadeMaskRCNN) else (fasa,)
        new = []
        for i, st in enumerate(stages):
            t0 = time.perf_counter()
            new.append(fasa_dynamic_sampling(st, up, down))
            p = new[-1].prob_list.cpu().numpy()
            print_fn(f"FASA dynamic sampling stage {i}: {len(p)} classes "
                     f"in {time.perf_counter() - t0:.3f} s, prob_list "
                     f"min {p.min():.6g} mean {p.mean():.6g} max "
                     f"{p.max():.6g}")
        state.fasa = (tuple(new) if isinstance(self.model, CascadeMaskRCNN)
                      else new[0])
        return state

    @torch.no_grad()
    def _fasa_accumulate_batch(self, state: DetTrainState,
                               batch: Dict[str, torch.Tensor], fasa,
                               noise: Optional[List[Tuple[torch.Tensor,
                                                          torch.Tensor]]]
                               = None):
        """One val batch (``engine/detection.py:511-589``): the eval-mode
        trunk's proposals (``train_cfg``'s RPN settings), each stage's
        RoIs sampled at the stage's IoU and their class scores, folded
        into the FASA counters; a cascade stage refines the next stage's
        RoIs by the target labels. ``noise`` is one sampler draw (pos,
        neg) a stage as ``bbox_targets`` takes it, (B, G + P) in stage 0
        and (B, R) after; without it the samplers draw from a generator
        seeded ``(seed, step + 999_983)``."""
        model, tc = self.model, self.train_cfg
        model.eval()
        try:
            images = batch["image"]
            b, img_h, img_w, _ = images.shape
            feats = model.extract_feat(images)
            cls_scores, bbox_preds = model.rpn_head(feats)
            proposals, _, prop_valid = rpn_proposals(
                cls_scores, bbox_preds,
                model.anchors((img_h, img_w), images.device),
                (img_h, img_w), nms_pre=tc.rpn_nms_pre,
                max_per_img=tc.rpn_max_per_img, nms_iou=tc.rpn_nms_iou)
            generator = self._generator(state.step + VAL_STEP_OFFSET)
            nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]
            cascade = isinstance(model, CascadeMaskRCNN)
            heads = model.roi_head.bbox_head if cascade else [
                model.roi_head.bbox_head]
            stages = fasa if cascade else (fasa,)
            new = []
            for i, head in enumerate(heads):
                iou = STAGE_IOUS[i] if cascade else 0.5
                with record_function(f"fasa_val_stage{i}"):
                    tgts = bbox_targets(
                        proposals, prop_valid, batch["gt_boxes"],
                        batch["gt_labels"], batch["gt_valid"],
                        model.num_classes, num_samples=tc.rcnn_num_samples,
                        pos_fraction=tc.rcnn_pos_fraction,
                        noise=None if noise is None else noise[i],
                        generator=generator, pos_iou_thr=iou,
                        neg_iou_thr=iou, min_pos_iou=iou,
                        add_gt_as_proposals=i == 0)
                    cls_score, bbox_pred, _ = head(SingleRoIExtractor(
                        (7, 7))(nhwc, _rois5(tgts.rois)))
                    labels = tgts.labels.reshape(-1)
                    new.append(fasa_accumulate_val(
                        stages[i], self.loss_cls, cls_score, labels,
                        tgts.label_weights.reshape(-1)))
                if cascade and i < model.num_stages - 1:
                    pred4 = _select_pred(bbox_pred, labels,
                                         model.num_classes,
                                         model.reg_class_agnostic)
                    proposals = _refine(
                        tgts.rois.reshape(-1, 4), pred4, (img_h, img_w),
                        model.stage_stds[i]).reshape(
                            b, tc.rcnn_num_samples, 4)
                    prop_valid = tgts.label_weights > 0
        finally:
            model.train()
        return tuple(new) if cascade else new[0]


def split_micro_batches(batch: Dict[str, torch.Tensor], n: int
                        ) -> List[Dict[str, torch.Tensor]]:
    """``batch`` split along axis 0 into ``n`` equal micro-batches, in
    order (JAX's ``x.reshape((n, B // n) + ...)``). Raises ``ValueError``
    when n does not divide the batch."""
    if n == 1:
        return [batch]
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"grad_accum {n} does not divide the batch of {b}")
    return [{k: v.reshape((n, b // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def _loss_fn(model) -> Callable:
    """The loss of the model's family, as the JAX trainer dispatches."""
    if isinstance(model, C4FasterRCNN):
        return c4_loss
    if isinstance(model, HTC):          # before its cascade base
        return htc_loss
    if isinstance(model, CascadeMaskRCNN):
        return cascade_loss
    if isinstance(model, MaskRCNN):
        return maskrcnn_loss
    raise NotImplementedError(
        f"training {type(model).__name__} is not ported")


def trainer_from_config(cfg, loss_cls, steps_per_epoch: int, seed: int = 0,
                        device: Union[str, torch.device] = "cuda"
                        ) -> DetectionTrainer:
    """A trainer for a MaskRCNN, Cascade Mask R-CNN, HTC or Faster R-CNN
    C4 config as ``iif_tpu/cli/train_det.py`` builds one (model completed
    from the loss, ``model_cfg_for_loss``; ``train_cfg``, with masks the
    pipeline's ``mask_stride``; the step-decay schedule with warm-up; the
    optimizer with ``optimizer_config.grad_clip``'s ``max_norm`` and, for
    ``optimizer.paramwise_cfg.norm_decay_mult=0``, no decay on the
    normalisation layers; ``data.grad_accum``; ``fasa_cfg``), from fresh
    weights drawn as the JAX package's ``model.init`` draws them
    (``fresh_init_``, seeded; ``cls_init`` from the config). Raises
    ``NotImplementedError`` for what the port does not train with: other
    parameter-wise optimizer settings (JAX reads only
    ``norm_decay_mult=0``) and other LR policies."""
    device = resolve_device(device)
    ocfg, lcfg = dict(cfg.optimizer), dict(cfg.get("lr_config", {}))
    pw = dict(ocfg.get("paramwise_cfg") or {})
    unported = {
        f"optimizer.paramwise_cfg {pw}": bool(pw) and pw != {
            "norm_decay_mult": 0.0},
        "lr_config.policy": lcfg.get("policy", "step") != "step",
    }
    for key, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{key} is not ported")
    accum, batch = cfg.data.get("grad_accum", 1), cfg.data.get(
        "samples_per_gpu", 4)
    if accum < 1 or batch % accum:
        raise ValueError(f"data.grad_accum {accum} does not divide "
                         f"data.samples_per_gpu {batch}")
    model = build_detector(model_cfg_for_loss(cfg.model, loss_cls))
    fresh_init_(model, torch.Generator().manual_seed(seed))
    tc = dict(cfg.get("train_cfg", {}))
    if isinstance(model, (MaskRCNN, CascadeMaskRCNN)):
        tc.setdefault("mask_gt_stride",
                      cfg.get("pipeline", {}).get("mask_stride", 1))
    schedule = build_lr_schedule(
        ocfg["lr"], steps_per_epoch, milestones=lcfg.get("milestones", []),
        lr_gamma=lcfg.get("gamma", 0.1),
        warmup_iters=lcfg.get("warmup_iters"),
        warmup_factor=lcfg.get("warmup_factor", 1.0 / 1000))
    grad_clip = cfg.get("optimizer_config", {}).get("grad_clip") or {}
    return DetectionTrainer(model, loss_cls, schedule,
                            train_cfg_from_dict(tc), ocfg, seed=seed,
                            device=device,
                            grad_clip=grad_clip.get("max_norm"),
                            fasa_cfg=cfg.get("fasa_cfg"),
                            grad_accum=accum,
                            norm_decay=not pw)
