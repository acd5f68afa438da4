"""Focal / one-hot BCE loss: port of ``iif_tpu/losses/focal.py``.

``gamma == 0`` is BCE with logits on one-hot targets (``--classif bce``),
``gamma > 0`` the focal loss on sigmoid probabilities with an optional
``alpha``. Per-class ``weights`` (deferred re-weighting) multiply the
(B, C) loss matrix; ``reduction="sum"`` divides by the batch size, as the
reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F


def _bce_with_logits(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


@dataclass
class FocalLoss:
    gamma: float = 0.0
    alpha: Optional[float] = None
    reduction: str = "mean"
    weights: Optional[torch.Tensor] = None      # (C,) per-class weights

    def __call__(self, logits: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        y = F.one_hot(targets.long(), logits.shape[-1]).float()
        logits = logits.float()
        batch = targets.shape[0]
        if self.gamma == 0:
            loss = _bce_with_logits(logits, y)
            if self.weights is not None:
                loss = loss * self.weights.to(loss.dtype)[None, :]
            if self.reduction == "sum":
                return loss.sum() / batch
            return loss.mean()
        p = torch.sigmoid(logits)
        eps = 1e-12
        loss = -(y * torch.log(p.clamp(eps, 1.0))
                 + (1.0 - y) * torch.log((1.0 - p).clamp(eps, 1.0)))
        p_t = p * y + (1.0 - p) * (1.0 - y)
        loss = loss * (1.0 - p_t) ** self.gamma
        if self.weights is not None:
            loss = loss * self.weights.to(loss.dtype)[None, :]
        if self.alpha is not None:
            alpha_t = self.alpha * y + (1.0 - self.alpha) * (1.0 - y)
            loss = alpha_t * loss
        if self.reduction == "sum":
            return loss.sum() / batch
        return loss.mean()

    def to(self, device) -> "FocalLoss":
        return replace(self, weights=None if self.weights is None
                       else self.weights.to(device))
