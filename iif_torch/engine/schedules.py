"""LR schedule and optimizer: port of ``iif_tpu/engine/schedules.py``
(``build_lr_schedule`` with step decay or the per-epoch cosine and the
linear warm-up, ``build_optimizer`` for ``sgd``, ``nesterov``,
``rmsprop`` and ``adamw`` with ``norm_decay_mask``, ``classifier_mask``
and ``reinit_classifier_head`` for decoupled classifier training).

The JAX package's optax chains, and their counterparts here, over the
trainable parameters only (a frozen parameter has ``requires_grad`` off:
it gets neither gradient nor decay, as JAX's masks give it), at ``lr=1``
under a ``LambdaLR`` that returns the schedule's rate:

- ``sgd``: ``add_decayed_weights -> trace(momentum) -> -lr``, coupled
  decay before the momentum buffer: ``torch.optim.SGD(momentum,
  dampening=0, weight_decay)``;
- ``nesterov``: the same with ``trace(nesterov=True)``:
  ``torch.optim.SGD(nesterov=True)`` (update ``g + m * buf``);
- ``rmsprop``: ``add_decayed_weights -> scale_by_rms(decay=0.9,
  eps=0.0316) -> trace(momentum) -> -lr``. optax puts eps inside the
  square root (``g * rsqrt(nu + eps)``, nu from 0), which
  ``torch.optim.RMSprop`` (``g / (sqrt(v) + eps)``) does not:
  ``RMSpropOptax`` writes the chain;
- ``adamw``: ``scale_by_adam()`` (b1 0.9, b2 0.999, eps 1e-8, bias
  corrected) then decoupled decay inside the rate, ``p -= lr * (adam +
  wd * p)``: ``AdamWOptax``.

The two written here compute in optax's order in f32, each divisor a
tensor. The schedule computes in float32, as the jitted JAX schedule
does.

``grad_clip`` (the configs' ``optimizer_config.grad_clip.max_norm``) puts
optax's ``clip_by_global_norm`` first in the chain, before the coupled
decay and the momentum: ``GlobalNormClip``, a step pre-hook over the
trainable gradients.

A decay mask (JAX's ``decay_mask``, the RSB recipe's ``paramwise_cfg=
dict(norm_decay_mult=0.)``: ``norm_decay_mask``) takes its parameters out
of the decay, coupled or decoupled: they form a parameter group at
``weight_decay`` 0. The decay acts on JAX's parameter, which for a
``NormedLinear`` or ``IIFNormedLinear`` weight is the port's weight plus
1 (flax's kernel, ``flax_offset_params``): those weights form a group
with ``decay_offset`` 1, decayed as ``wd * (p + 1)`` (for the coupled
decay a step pre-hook adds ``wd * 1`` to their gradients, after the
clipping; ``AdamWOptax`` adds it in its update).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from iif_torch.models.layers import IIFNormedLinear, NormedLinear
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


class RMSpropOptax(torch.optim.Optimizer):
    """optax ``add_decayed_weights(wd) -> scale_by_rms(decay, eps) ->
    trace(momentum) -> scale_by_learning_rate``: u = g + wd p; nu =
    (1 - decay) u^2 + decay nu; t = u rsqrt(nu + eps) + momentum t;
    p += -lr t."""

    def __init__(self, params, lr: float = 1.0, momentum: float = 0.9,
                 weight_decay: float = 0.0, decay: float = 0.9,
                 eps: float = 0.0316):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d, m = group["decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                st["nu"] = (1 - d) * (g * g) + d * st["nu"]
                u = torch.rsqrt(st["nu"] + group["eps"]) * g
                st["trace"] = u + m * st["trace"]
                p.add_(st["trace"] * -group["lr"])


class AdamWOptax(torch.optim.Optimizer):
    """optax ``scale_by_adam(b1, b2, eps) -> add_decayed_weights(wd) ->
    scale_by_learning_rate``: mu, nu moving averages of g and g^2, bias
    corrected by 1 - b^count (f32), u = mu_hat / (sqrt(nu_hat) + eps) +
    wd p; p += -lr u."""

    def __init__(self, params, lr: float = 1.0, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      b1=b1, b2=b2, eps=eps,
                                      decay_offset=0.0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                n = np.float32(st["count"])
                c1 = torch.full((), float(np.float32(1) - np.float32(b1) ** n),
                                dtype=p.dtype, device=p.device)
                c2 = torch.full((), float(np.float32(1) - np.float32(b2) ** n),
                                dtype=p.dtype, device=p.device)
                u = (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2)
                                       + group["eps"])
                if group["weight_decay"]:
                    kernel = (p + group["decay_offset"]
                              if group["decay_offset"] else p)
                    u = u + group["weight_decay"] * kernel
                p.add_(u * -group["lr"])


class GlobalNormClip:
    """optax ``clip_by_global_norm(max_norm)`` as an optimizer step
    pre-hook: the global L2 norm over the gradients of the parameters
    that have one, and every gradient scaled by ``max_norm / norm``
    where ``norm >= max_norm``; no epsilon (``torch.nn.utils.
    clip_grad_norm_`` divides by ``norm + 1e-6``). The per-tensor norms
    and the scaling are one multi-tensor kernel each (a few hundred
    tensors a detector), without a host sync; the result is within f32
    rounding of optax's ``(g / norm) * max_norm``. ``last_norm`` is the
    last step's norm, a device tensor (reading it syncs)."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)
        self.last_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def __call__(self, optimizer: torch.optim.Optimizer, args, kwargs
                 ) -> None:
        grads = [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        if not grads:
            return
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.last_norm = norm


def _coupled_decay_offset(optimizer: torch.optim.Optimizer, args, kwargs
                          ) -> None:
    """Step pre-hook: ``wd * decay_offset`` added to the gradients of the
    groups with an offset, so the coupled decay acts on ``p + offset``."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            off = group.get("decay_offset", 0.0)
            if off and group["weight_decay"]:
                grads = [p.grad for p in group["params"]
                         if p.grad is not None]
                if grads:
                    torch._foreach_add_(grads, group["weight_decay"] * off)


def build_optimizer(
    opt_name: str,
    params: Iterable[torch.nn.Parameter],
    lr_schedule: Callable[[int], float],
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    grad_clip: Optional[float] = None,
    no_decay: Iterable[torch.nn.Parameter] = (),
    decay_offset: Iterable[torch.nn.Parameter] = (),
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer of ``opt_name`` (``sgd``, ``nesterov``, ``rmsprop``,
    ``adamw``) over the parameters that require a gradient (the
    trainable mask: a frozen stage has ``requires_grad`` off), and the
    scheduler that sets its rate from ``lr_schedule`` at every step.
    The parameters of ``no_decay`` take no weight decay, those of
    ``decay_offset`` (``flax_offset_params``) a decay of ``p + 1``, each
    a group of its own. With ``grad_clip`` the optimizer's ``grad_clip``
    attribute is its ``GlobalNormClip`` (else None). Other names raise
    ``ValueError``, as JAX's does."""
    name = opt_name.lower()
    skip = {id(p) for p in no_decay}
    offset = {id(p) for p in decay_offset} - skip if weight_decay else set()
    trainable = [p for p in params if p.requires_grad]
    params = [{"params": [p for p in trainable
                          if id(p) not in skip | offset]}]
    if skip:
        params.append({"params": [p for p in trainable if id(p) in skip],
                       "weight_decay": 0.0})
    if offset:
        params.append({"params": [p for p in trainable if id(p) in offset],
                       "decay_offset": 1.0})
    if name in ("sgd", "nesterov"):
        opt = torch.optim.SGD(params, lr=1.0, momentum=momentum,
                              dampening=0.0, weight_decay=weight_decay,
                              nesterov=name == "nesterov")
    elif name == "rmsprop":
        opt = RMSpropOptax(params, momentum=momentum,
                           weight_decay=weight_decay)
    elif name == "adamw":
        opt = AdamWOptax(params, weight_decay=weight_decay)
    else:
        raise ValueError(f"Invalid optimizer {opt_name}. Only SGD and "
                         "RMSprop are supported.")
    opt.grad_clip = GlobalNormClip(grad_clip) if grad_clip else None
    if opt.grad_clip is not None:
        opt.register_step_pre_hook(opt.grad_clip)
    if offset and name != "adamw":          # after the clipping, as JAX
        opt.register_step_pre_hook(_coupled_decay_offset)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule)


def flax_offset_params(model: torch.nn.Module) -> list:
    """The weights whose flax kernel is the weight plus 1 (``NormedLinear``
    and ``IIFNormedLinear``: flax draws U(0, 2) and subtracts 1 in the
    forward), which the weight decay pulls towards -1 in JAX."""
    return [m.weight for m in model.modules()
            if isinstance(m, (NormedLinear, IIFNormedLinear))]


NORM_LAYERS = (torch.nn.modules.batchnorm._NormBase, torch.nn.GroupNorm,
               torch.nn.LayerNorm)


def norm_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it takes weight decay (JAX's
    ``norm_decay_mask``, ``engine/schedules.py:173-``): False for a
    normalisation layer's weight and bias (flax's ``scale`` and the
    ``bias`` beside it), True for every other parameter."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            out[full] = not isinstance(mod, NORM_LAYERS)
    return out


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
