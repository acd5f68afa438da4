"""Classification trainer: port of ``iif_tpu/engine/classification.py``
(``ClassificationTrainer``, with its QAT hooks) on one card.

A step: the uint8 batch to the device, the augmentation there (its draws
and mixup's permutation from a ``torch.Generator`` seeded from ``(seed,
step)``, mixup's lambda and a policy's choice for the batch from host
``RandomState``s seeded so), the
input in the compute dtype, optional mixup (f32, as in JAX), the forward
with BatchNorm on the batch's statistics, the logits in f32, the
criterion, the backward, the optimizer over the trainable parameters and the
schedule's next rate; metrics (loss, Acc@1, Acc@5 from a stable top-5,
ties in index order as ``jax.lax.top_k``) stay on the device.
``train_one_epoch`` reads them back every ``SYNC_WINDOW`` steps and at
each print point, as the JAX package's does. ``evaluate`` runs the model
on its running statistics, applies the inference-time IIF (``logits *
w``) for an IIF criterion only, and counts hits on the device; it returns
the JAX package's dict (accuracies, per-class counts, ``preds`` and
``labels`` of the valid rows for ``shot_acc``).

QAT (``qat``, an ``iif_torch.quant.QatConfig``): while ``quant_on`` the
forward runs on fake-quantized weights (``torch.func.functional_call``;
the gradient reaches the float weights straight through); from epoch
``freeze_observer_epoch`` on the scales are the ones snapshotted once at
its start (``frozen_scales``); from epoch ``freeze_bn_epoch`` on every
BatchNorm runs on its running statistics and leaves them unchanged
(flax's ``train=False``) while the rest of the step trains.
``evaluate_quantized`` evaluates the fake-quantized weights, with the
frozen scales once they exist.

Images enter as (B, H, W, 3), as in JAX; the model takes the NCHW view of
the NHWC batch (``channels_last`` memory). The step and the evaluation
are ``record_function`` spans (``augment``, ``forward``, ``backward``,
``optimizer``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from iif_torch.device import resolve_device
from iif_torch.engine.schedules import build_optimizer, flax_offset_params
from iif_torch.losses.mixup import mixup_batch, mixup_criterion, sample_mixup
from iif_torch.ops.nms import top_k
from iif_torch.quant import fake_quant_params, observe_scales
from iif_torch.utils.metrics import MetricLogger, SmoothedValue

SYNC_WINDOW = 4           # steps of metrics in flight before a read-back


@dataclass
class TrainState:
    step: int
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR


class ClassificationTrainer:
    """Trains ``model`` (on ``device``, default the card) with
    ``criterion`` under ``lr_schedule``. ``train_augment(generator,
    images_u8)`` and ``eval_transform(images_u8)`` map a (B, H, W, 3)
    uint8 batch on the device to float; ``mixup_alpha`` turns mixup on;
    ``compute_dtype`` is the input's dtype (the model's convolutions take
    theirs from the model)."""

    def __init__(self, model: torch.nn.Module, criterion,
                 lr_schedule: Callable[[int], float],
                 train_augment: Callable, eval_transform: Callable,
                 num_classes: int, mixup_alpha: Optional[float] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 opt: str = "sgd", momentum: float = 0.9,
                 weight_decay: float = 1e-4,
                 device: Union[str, torch.device] = "cuda", qat=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.criterion = criterion.to(self.device)
        self.lr_schedule = lr_schedule
        self.train_augment = train_augment
        self.eval_transform = eval_transform
        self.num_classes = num_classes
        self.mixup_alpha = mixup_alpha
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.opt = (opt, momentum, weight_decay)
        self.qat = qat
        self.frozen_scales = None      # set at the observer-freeze epoch

    def init_state(self) -> TrainState:
        """The optimizer over the parameters that require a gradient, at
        step 0."""
        name, momentum, wd = self.opt
        opt, sched = build_optimizer(
            name, self.model.parameters(), self.lr_schedule, momentum, wd,
            decay_offset=flax_offset_params(self.model))
        return TrainState(0, opt, sched)

    def _images(self, batch: Dict[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch["image"]).to(self.device)

    def _logits(self, x: torch.Tensor,
                params: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The model on NHWC ``x`` (its NCHW view), with ``params`` in
        place of its parameters when given; f32."""
        x = x.permute(0, 3, 1, 2)
        if params is None:
            return self.model(x).float()
        return torch.func.functional_call(self.model, params, (x,)).float()

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   mix: Optional[Tuple[Any, Any]] = None, *,
                   quant_on: bool = False, freeze_bn: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` ({image, label}); ``mix`` =
        (lam, index) replaces mixup's draw; ``quant_on`` runs the forward
        on fake-quantized weights (``frozen_scales`` when set),
        ``freeze_bn`` every BatchNorm on its running statistics. Updates
        the model and ``state`` in place and returns them with the
        metrics (device tensors)."""
        images = self._images(batch)
        y = torch.as_tensor(batch["label"]).to(self.device).long()
        self.model.train()
        if freeze_bn:
            for m in self.model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.train(False)
        generator = torch.Generator(device=self.device).manual_seed(
            ((self.seed & 0xFFFFFFFF) << 32) | (state.step & 0xFFFFFFFF))
        with record_function("augment"):
            x = self.train_augment(generator, images).to(self.compute_dtype)
            if self.mixup_alpha is not None:
                lam, index = mix if mix is not None else sample_mixup(
                    np.random.RandomState([self.seed & 0xFFFFFFFF,
                                           state.step & 0xFFFFFFFF]),
                    generator, x.shape[0], self.mixup_alpha)
                x, y_a, y_b, lam = mixup_batch(x, y, lam, index)
        with record_function("forward"):
            params = None
            if quant_on:
                params = fake_quant_params(
                    self.model, scales=self.frozen_scales,
                    per_channel=self.qat.per_channel if self.qat else True)
            logits = self._logits(x, params)
            if self.mixup_alpha is not None:
                loss = mixup_criterion(self.criterion, logits, y_a, y_b, lam)
            else:
                loss = self.criterion(logits, y)
        with record_function("backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            _, top5 = top_k(logits.detach(), 5)
            correct = top5 == y[:, None]
            metrics = {"loss": loss.detach(),
                       "acc1": correct[:, :1].any(1).float().mean() * 100.0,
                       "acc5": correct.any(1).float().mean() * 100.0}
        return state, metrics

    def train_one_epoch(self, state: TrainState, loader, epoch: int,
                        print_freq: int = 100, print_fn=print,
                        log_writer=None) -> Tuple[TrainState, MetricLogger]:
        """One epoch of ``loader`` (``set_epoch(epoch)`` first); img/s
        is the images absorbed over the wall time between read-backs."""
        logger = MetricLogger(print_fn=print_fn)
        logger.meters["img/s"] = SmoothedValue(window_size=10,
                                               fmt="{value:.1f}")
        loader.set_epoch(epoch)
        total = len(loader)
        quant_on = bool(self.qat and self.qat.enabled)
        freeze_bn = quant_on and epoch >= self.qat.freeze_bn_epoch
        if quant_on and epoch >= self.qat.freeze_observer_epoch \
                and self.frozen_scales is None:
            with torch.no_grad():
                self.frozen_scales = observe_scales(self.model)

        def sink(rec):
            if log_writer is not None:
                log_writer.write({"mode": "train", "epoch": epoch + 1,
                                  **rec}, step=epoch * total + rec["iter"])

        pending: List[Tuple[Dict[str, torch.Tensor], int]] = []
        clock: List[Optional[float]] = [None]

        def absorb(n: int) -> None:
            group, imgs = pending[:n], 0
            del pending[:n]
            for metrics, bsz in group:
                loss, acc1, acc5 = torch.stack(
                    [metrics["loss"], metrics["acc1"], metrics["acc5"]]
                ).tolist()
                logger.update(loss=loss, acc1=acc1, acc5=acc5)
                imgs += bsz
            now = time.time()
            if clock[0] is not None:
                logger.meters["img/s"].update(
                    imgs / max(now - clock[0], 1e-9))
            clock[0] = now

        for i, batch in enumerate(logger.log_every(
                iter(loader), print_freq, f"Epoch: [{epoch}]", total=total,
                sink=sink)):
            if clock[0] is None:
                clock[0] = time.time()
            state, metrics = self.train_step(state, batch,
                                             quant_on=quant_on,
                                             freeze_bn=freeze_bn)
            pending.append((metrics, int(batch["image"].shape[0])))
            if print_freq and (i % print_freq == 0 or i == total - 1):
                absorb(len(pending))
            elif len(pending) >= SYNC_WINDOW:
                absorb(1)
        if pending:
            absorb(len(pending))
        return state, logger

    @torch.no_grad()
    def evaluate_quantized(self, batches: Iterable[Dict[str, Any]],
                           print_fn=print) -> Dict[str, Any]:
        """``evaluate`` on the fake-quantized weights (the frozen scales
        when set, else live ones): the converted int8 model's accuracy,
        since fake-quant equals int8 dequantization."""
        params = fake_quant_params(self.model, scales=self.frozen_scales)
        return self.evaluate(batches, print_fn=print_fn, params=params)

    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, Any]], print_fn=print,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, Any]:
        """Accuracy over ``batches`` ({image, label, valid}) on the
        running statistics (with ``params`` in place of the model's
        parameters when given)."""
        self.model.eval()
        c = self.num_classes
        counts = torch.zeros(3, dtype=torch.long, device=self.device)
        percls = torch.zeros(2, c, dtype=torch.long, device=self.device)
        preds, labels = [], []
        for batch in batches:
            images = self._images(batch)
            y = torch.as_tensor(batch["label"]).to(self.device).long()
            valid = torch.as_tensor(batch["valid"]).to(self.device).bool()
            x = self.eval_transform(images).to(self.compute_dtype)
            logits = self._logits(x, params)
            if getattr(self.criterion, "iif", False):
                logits = self.criterion.transform(logits)
            _, top5 = top_k(logits, 5)
            hit = top5 == y[:, None]
            c1 = hit[:, 0] & valid
            counts += torch.stack([c1.sum(), (hit.any(1) & valid).sum(),
                                   valid.sum()])
            percls[0].index_add_(0, y, c1.long())
            percls[1].index_add_(0, y, valid.long())
            preds.append(top5[:, 0][valid])
            labels.append(y[valid])
        correct1, correct5, count = counts.tolist()
        acc1 = 100.0 * correct1 / max(count, 1)
        acc5 = 100.0 * correct5 / max(count, 1)
        print_fn(f" * Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}")
        percls = percls.cpu().numpy().astype(np.float64)
        return {
            "acc1": acc1, "acc5": acc5, "count": float(count),
            "percls_correct": percls[0], "percls_total": percls[1],
            "preds": (torch.cat(preds).cpu().numpy() if preds
                      else np.empty(0, np.int64)),
            "labels": (torch.cat(labels).cpu().numpy() if labels
                       else np.empty(0, np.int64)),
        }
