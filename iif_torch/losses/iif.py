"""Inverse Image Frequency (IIF) loss: port of ``iif_tpu/losses/iif.py``.

A fixed per-class weight vector ``w_c`` (from the train set's class
frequencies) scales the logits in the training CE and at inference. The
seven variants are computed in float64 NumPy with the optional Lp norm,
then cast, so the weights equal the JAX package's bit for bit. With
deferred re-weighting each sample's loss is multiplied by its class
weight ``w_y`` before the plain mean over the batch (not the
``sum(w_y)`` of ``CrossEntropyLoss(weight=...)``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch
from scipy.special import ndtri

from iif_torch.losses.ce import reduce_loss, softmax_cross_entropy

IIF_VARIANTS = ("raw", "smooth", "rel", "normit", "gombit", "base2", "base10")


def compute_iif_weights(class_counts: Sequence[int], variant: str = "raw",
                        iif_norm: int = 0,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-class IIF weights from train-set class counts:
    raw log(N/n), smooth log((N+1)/(n+1)) + 1, rel log((N-n)/n), normit
    -ndtri(n/N), gombit -log(-log(1 - n/N)), base2 log2(N/n), base10
    log10(N/n); ``iif_norm`` > 0 divides by the vector's Lp norm."""
    freqs = np.asarray(class_counts, dtype=np.float64)
    if freqs.ndim != 1 or freqs.size == 0:
        raise ValueError("class_counts must be a non-empty 1-D sequence")
    total = freqs.sum()
    p = freqs / total
    if variant == "raw":
        w = np.log(total / freqs)
    elif variant == "smooth":
        w = np.log((total + 1.0) / (freqs + 1.0)) + 1.0
    elif variant == "rel":
        w = np.log((total - freqs) / freqs)
    elif variant == "normit":
        w = -ndtri(p)
    elif variant == "gombit":
        w = -np.log(-np.log(1.0 - p))
    elif variant == "base2":
        w = np.log2(total / freqs)
    elif variant == "base10":
        w = np.log10(total / freqs)
    else:
        raise ValueError(
            f"unknown IIF variant {variant!r}; choose from {IIF_VARIANTS}")
    if iif_norm > 0:
        w = w / np.linalg.norm(w, ord=iif_norm)
    return torch.tensor(w, dtype=dtype)


@dataclass
class IIFLoss:
    """CE on IIF-scaled logits; ``transform`` is the inference-time
    ``logits * w``. ``iif`` marks the criterion for the evaluator."""

    weights: torch.Tensor                       # (C,) IIF vector
    reduction: str = "mean"
    class_weights: Optional[torch.Tensor] = None  # (C,) deferred weights

    iif = True

    @classmethod
    def from_counts(cls, class_counts: Sequence[int], variant: str = "raw",
                    iif_norm: int = 0, reduction: str = "mean",
                    class_weights: Optional[torch.Tensor] = None
                    ) -> "IIFLoss":
        return cls(compute_iif_weights(class_counts, variant, iif_norm),
                   reduction, class_weights)

    def __call__(self, logits: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        scaled = logits * self.weights.to(logits.dtype)
        per_sample = softmax_cross_entropy(scaled, targets)
        if self.class_weights is not None:
            per_sample = per_sample * self.class_weights.to(
                per_sample.dtype)[targets.long()]
        return reduce_loss(per_sample, self.reduction)

    def transform(self, logits: torch.Tensor) -> torch.Tensor:
        return logits * self.weights.to(logits.dtype)

    def to(self, device) -> "IIFLoss":
        return replace(self, weights=self.weights.to(device),
                       class_weights=None if self.class_weights is None
                       else self.class_weights.to(device))
