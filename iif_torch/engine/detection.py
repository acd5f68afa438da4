"""Detection trainer: port of ``iif_tpu/engine/detection.py``
(``DetectionTrainer`` with ``init_state``, one train step and
``train_one_epoch``, and ``frozen_backbone_mask``) for the MaskRCNN and
the Faster R-CNN C4 losses, with ``grad_accum=1`` and no EMA, FASA,
Seesaw or Dynamic R-CNN state. The step dispatches on the model as the
JAX trainer does (``engine/detection.py:307-312`` for C4):
``maskrcnn_loss`` for ``MaskRCNN``, ``c4_loss`` for ``C4FasterRCNN``;
other families raise.

The JAX step folds the step number into its base key; here each step
draws its sampling noise from a ``torch.Generator`` seeded from
``(seed, step)``. The step returns the JAX package's metrics: the losses
and their sum under ``"loss"``, as device tensors (nothing syncs with the
host). The backward and the optimizer are ``record_function`` spans
(``backward``, ``optimizer``) beside the loss's stage spans.

``train_one_epoch`` reads the metrics back asynchronously, as the JAX
package's does: a step's metrics wait in a window of ``SYNC_WINDOW``
steps and are read back (one copy a step) when it fills, and all of them
at each print point; a non-finite loss raises ``FloatingPointError`` at
read-back (mmdet's ``CheckInvalidLossHook`` fires at that granularity
too).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from iif_torch.detection.c4 import C4FasterRCNN, c4_loss
from iif_torch.detection.detector import (
    DetTrainCfg,
    MaskRCNN,
    build_detector,
    maskrcnn_loss,
    train_cfg_from_dict,
)
from iif_torch.detection.init import fresh_init_
from iif_torch.device import resolve_device
from iif_torch.engine.schedules import build_lr_schedule, build_optimizer
from iif_torch.utils.metrics import MetricLogger

# the batch keys the losses read (``engine/detection.py:455-460``, less
# the semantic maps and proposals the port does not train with)
FEED_KEYS = ("image", "gt_boxes", "gt_labels", "gt_valid", "gt_masks",
             "gt_masks_packed")
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


class DetectionTrainer:
    """Trains ``model`` (a ``MaskRCNN`` or a ``C4FasterRCNN``, on
    ``device``, default the card) with ``loss_cls`` under
    ``lr_schedule``; ``optimizer_cfg`` is the config's ``optimizer`` dict
    (type, momentum, weight_decay)."""

    def __init__(self, model: Union[MaskRCNN, C4FasterRCNN], loss_cls,
                 lr_schedule: Callable[[int], float],
                 train_cfg: DetTrainCfg = DetTrainCfg(),
                 optimizer_cfg: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.loss_fn = _loss_fn(model)
        self.model = model.to(self.device).train()
        self.loss_cls = loss_cls.to(self.device)
        self.lr_schedule = lr_schedule
        self.train_cfg = train_cfg
        self.optimizer_cfg = dict(optimizer_cfg or {})
        self.seed = seed

    def init_state(self) -> DetTrainState:
        """Optimizer state over the trainable parameters, at step 0."""
        ocfg = self.optimizer_cfg
        opt, sched = build_optimizer(
            ocfg.get("type", "sgd"), self.model.parameters(),
            self.lr_schedule, ocfg.get("momentum", 0.9),
            ocfg.get("weight_decay", 1e-4))
        return DetTrainState(0, opt, sched)

    def train_step(self, state: DetTrainState,
                   batch: Dict[str, Any],
                   noise: Optional[Dict[str, Any]] = None
                   ) -> Tuple[DetTrainState, Dict[str, torch.Tensor]]:
        """One SGD step on ``batch`` (see ``maskrcnn_loss`` or ``c4_loss``
        for its keys; ``noise`` as there). Updates the model and ``state``
        in place and returns them with the metrics."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        self.model.train()
        generator = torch.Generator(device=self.device).manual_seed(
            ((self.seed & 0xFFFFFFFF) << 32) | (state.step & 0xFFFFFFFF))
        total, losses, _ = self.loss_fn(
            self.model, batch, self.loss_cls, self.train_cfg,
            generator=generator, noise=noise)
        with record_function("backward"):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with record_function("optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
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
                state, metrics = self.train_step(
                    state, {k: v for k, v in batch.items()
                            if k in FEED_KEYS})
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


def _loss_fn(model) -> Callable:
    """The loss of the model's family, as the JAX trainer dispatches."""
    if isinstance(model, C4FasterRCNN):
        return c4_loss
    if isinstance(model, MaskRCNN):
        return maskrcnn_loss
    raise NotImplementedError(
        f"training {type(model).__name__} is not ported")


def trainer_from_config(cfg, loss_cls, steps_per_epoch: int, seed: int = 0,
                        device: Union[str, torch.device] = "cuda"
                        ) -> DetectionTrainer:
    """A trainer for a MaskRCNN or a Faster R-CNN C4 config as
    ``iif_tpu/cli/train_det.py`` builds one (model, ``train_cfg``, for
    MaskRCNN with the pipeline's ``mask_stride``, the step-decay schedule
    with warm-up, SGD), from fresh weights drawn as the JAX package's
    ``model.init`` draws them (``fresh_init_``, seeded; ``cls_init`` from
    the config); ``cli/train_det.py`` then loads ``pretrained_backbone``,
    ``--resume-from`` or ``--load-from`` over them. Raises
    ``NotImplementedError`` for what the port does not train with:
    gradient accumulation, gradient clipping, parameter-wise optimizer
    settings and other LR policies."""
    device = resolve_device(device)
    ocfg, lcfg = dict(cfg.optimizer), dict(cfg.get("lr_config", {}))
    unported = {
        "data.grad_accum": cfg.data.get("grad_accum", 1) != 1,
        "optimizer_config.grad_clip": bool(
            cfg.get("optimizer_config", {}).get("grad_clip")),
        "optimizer.paramwise_cfg": bool(ocfg.get("paramwise_cfg")),
        "lr_config.policy": lcfg.get("policy", "step") != "step",
    }
    for key, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{key} is not ported")
    model = build_detector(dict(cfg.model))
    fresh_init_(model, torch.Generator().manual_seed(seed))
    tc = dict(cfg.get("train_cfg", {}))
    if isinstance(model, MaskRCNN):
        tc.setdefault("mask_gt_stride",
                      cfg.get("pipeline", {}).get("mask_stride", 1))
    schedule = build_lr_schedule(
        ocfg["lr"], steps_per_epoch, milestones=lcfg.get("milestones", []),
        lr_gamma=lcfg.get("gamma", 0.1),
        warmup_iters=lcfg.get("warmup_iters"),
        warmup_factor=lcfg.get("warmup_factor", 1.0 / 1000))
    return DetectionTrainer(model, loss_cls, schedule,
                            train_cfg_from_dict(tc), ocfg, seed=seed,
                            device=device)
