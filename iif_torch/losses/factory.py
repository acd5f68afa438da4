"""Criterion factory: port of ``iif_tpu/losses/factory.py``: ``classif``
in {iif, bce, focal_loss, ce}, with deferred re-weighting (``--deffered``)
injecting per-class weights ``N / n_c``."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from iif_torch.losses.ce import CrossEntropyLoss
from iif_torch.losses.focal import FocalLoss
from iif_torch.losses.iif import IIFLoss


def get_deferred_weights(class_counts: Sequence[int]) -> torch.Tensor:
    """``w_c = N / n_c`` in float64, cast to f32."""
    counts = np.asarray(class_counts, dtype=np.float64)
    return torch.tensor(counts.sum() / counts, dtype=torch.float32)


def get_criterion(classif: str, class_counts: Sequence[int], *,
                  iif_variant: str = "raw", iif_norm: int = 0,
                  gamma: float = 0.0, alpha: Optional[float] = None,
                  reduction: str = "mean", deferred: bool = False):
    weight = get_deferred_weights(class_counts) if deferred else None
    if classif == "iif":
        return IIFLoss.from_counts(class_counts, variant=iif_variant,
                                   iif_norm=iif_norm, reduction=reduction,
                                   class_weights=weight)
    if classif == "bce":
        return FocalLoss(gamma=0.0, reduction=reduction, weights=weight)
    if classif == "focal_loss":
        return FocalLoss(gamma=gamma, alpha=alpha, reduction=reduction,
                         weights=weight)
    return CrossEntropyLoss(weight=weight, reduction=reduction)
