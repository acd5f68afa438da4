"""LR schedule and optimizer: port of ``iif_tpu/engine/schedules.py``
(``build_lr_schedule`` with step decay or the per-epoch cosine and the
linear warm-up, ``build_optimizer`` for ``"sgd"``, ``classifier_mask``
and ``reinit_classifier_head`` for decoupled classifier training).

The JAX package's optax chain for SGD with a trainable mask is
``masked set_to_zero -> add_decayed_weights -> trace(momentum) -> -lr``:
coupled weight decay added to the gradient before the momentum buffer.
That is ``torch.optim.SGD(momentum, dampening=0, weight_decay)`` over the
trainable parameters only (a frozen parameter gets neither gradient nor
decay), at ``lr=1`` under a ``LambdaLR`` that returns the schedule's rate.
The schedule computes in float32, as the jitted JAX schedule does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from iif_torch.utils.init import HEAD_NAMES, ParamInit, head_of


def build_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    milestones: Sequence[int] = (),
    lr_gamma: float = 0.1,
    warmup_factor: float = 1.0 / 1000,
    warmup_iters: Optional[int] = None,
    epochs: int = 0,
    cosine: bool = False,
    warmup: bool = True,
) -> Callable[[int], float]:
    """Step -> learning rate: ``lr_gamma`` per epoch milestone passed, or
    with ``cosine`` torch's ``CosineAnnealingLR`` stepped per epoch over
    ``epochs`` (eta_min 0), times a linear ramp from ``warmup_factor`` to
    1 over the first ``warmup_iters`` steps (``min(1000,
    steps_per_epoch - 1)`` when None, none when 0 or ``warmup`` is
    False)."""
    milestones = sorted(int(m) for m in milestones)
    if not warmup:
        warmup_iters = 0
    elif warmup_iters is None:
        warmup_iters = min(1000, max(steps_per_epoch - 1, 1))
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if cosine:
            factor = f32(0.5) * (f32(1.0) + np.cos(
                f32(np.pi) * f32(epoch) / f32(epochs)))
        else:
            n_decays = sum(epoch >= m for m in milestones)
            factor = f32(lr_gamma) ** np.int32(n_decays)
        if warmup_iters > 0 and step < warmup_iters:
            alpha = min(max(f32(step) / f32(warmup_iters), f32(0.0)),
                        f32(1.0))
            factor = factor * (f32(warmup_factor) * (f32(1.0) - alpha)
                               + alpha)
        return float(f32(base_lr) * f32(factor))

    return schedule


def build_optimizer(
    opt_name: str,
    params: Iterable[torch.nn.Parameter],
    lr_schedule: Callable[[int], float],
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """SGD with momentum and coupled weight decay over the parameters
    that require a gradient (the trainable mask: a frozen stage has
    ``requires_grad`` off), and the scheduler that sets its rate from
    ``lr_schedule`` at every step. Only ``"sgd"`` is ported."""
    if opt_name.lower() != "sgd":
        raise NotImplementedError(f"optimizer {opt_name!r} is not ported")
    params = [p for p in params if p.requires_grad]
    opt = torch.optim.SGD(params, lr=1.0, momentum=momentum, dampening=0.0,
                          weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule)


def classifier_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it belongs to the classifier head, the
    parameters ``--decoup`` trains (``HEAD_NAMES``: ``linear`` of a
    ResNet-s, ``fc`` of an ImageNet ResNet)."""
    return {name: name.split(".")[0] in HEAD_NAMES
            for name, _ in model.named_parameters()}


def freeze_all_but_head(model: torch.nn.Module) -> None:
    """``--decoup``: only the head's parameters require a gradient (and
    so reach the optimizer). BatchNorm stays in training mode: its batch
    statistics and running buffers update, as in JAX."""
    mask = classifier_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])


def reinit_classifier_head(model: torch.nn.Module, seed: int = 0) -> None:
    """Decoupled training's fresh head (reference ``train.py:123-145``):
    ``xavier_uniform`` for each weight of two or more dimensions, bias
    0.01, from a generator seeded with ``seed``; other head parameters
    (the learned cosine scale) stay."""
    init = ParamInit(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in head_of(model).named_parameters():
            if name == "weight" and p.dim() >= 2:
                init.uniform(p, math.sqrt(6.0 / (p.shape[0] + p.shape[1])))
            elif name == "bias":
                init.const(p, 0.01)
