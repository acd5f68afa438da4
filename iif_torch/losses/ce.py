"""Cross-entropy primitives: port of ``iif_tpu/losses/ce.py`` (torch's
reduction semantics)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Per-sample CE from integer targets, in f32 whatever the logits'
    dtype."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    return logz - true_logit


def reduce_loss(per_sample: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return per_sample.mean()
    if reduction == "sum":
        return per_sample.sum()
    if reduction == "none":
        return per_sample
    raise ValueError(f"unknown reduction {reduction!r}")


@dataclass
class CrossEntropyLoss:
    """Plain CE with optional per-class weights; with ``weight`` and
    ``reduction="mean"`` it is ``torch.nn.CrossEntropyLoss(weight=w)``:
    sum(w_y * l) / sum(w_y) (the ``--classif ce --deffered`` path)."""

    weight: Optional[torch.Tensor] = None      # (C,)
    reduction: str = "mean"

    def __call__(self, logits: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        per_sample = softmax_cross_entropy(logits, targets)
        if self.weight is not None:
            w = self.weight.to(per_sample.dtype)[targets.long()]
            per_sample = per_sample * w
            if self.reduction == "mean":
                return per_sample.sum() / w.sum()
        return reduce_loss(per_sample, self.reduction)

    def to(self, device) -> "CrossEntropyLoss":
        return replace(self, weight=None if self.weight is None
                       else self.weight.to(device))
