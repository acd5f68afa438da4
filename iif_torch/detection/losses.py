"""Detection-side IIF losses: port of ``iif_tpu/detection/losses.py``
(``DetIIFLoss``, ``DetCrossEntropyLoss``, ``compute_det_iif_from_counts``,
``load_iif_csv``), the reference's ``mmdet/models/losses/iif_loss.py``.

Per-class weights come from a reference-format CSV (row 0 is a background
placeholder, dropped; the background weight 1.0 is appended) or from class
frequencies. Training loss: CE(score x weights, label); inference
activation: softmax(score x weights) in f32. ``DetCrossEntropyLoss`` is
the plain softmax CE of the stock configs (Faster R-CNN C4) or, with
``use_sigmoid``, the per-channel BCE of the ``configs/activations/``
sigmoid baselines. Each has ``per_class_sums``, FASA's per-class loss
counters.
"""
from __future__ import annotations

import csv
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def load_iif_csv(path: str, variant: str = "raw") -> np.ndarray:
    """Read a reference-format IDF csv column; drop the row-0 background
    placeholder and append bg weight 1.0 (``iif_loss.py:47-50``).

    Returns (C+1,) float32 where the last entry is the background class."""
    with open(path, newline="") as f:
        col = [float(row[variant]) for row in csv.DictReader(f)]
    return np.asarray(col[1:] + [1.0], dtype=np.float32)


DET_IIF_VARIANTS = ("raw", "smooth", "prob", "normit", "gombit",
                    "base2", "base10")


def compute_det_iif_from_counts(counts: Sequence[int],
                                num_images_total: int,
                                variant: str = "raw") -> np.ndarray:
    """Detection IIF weights from per-class frequencies, with the image
    corpus size N as the denominator (``N = 100170`` for LVIS v1 train).
    ``*_obj`` variants take instance counts and their sum as N.

      raw    = log(N / n_c)
      smooth = log((N+1)/(n_c+1)) + 1
      prob   = log((N - n_c)/n_c)
      normit = -ndtri(n_c / N)
      gombit = -log(-log(1 - n_c/N))
      base2  = log2(N / n_c)
      base10 = log10(N / n_c)

    Appends bg weight 1.0; returns (C+1,) float32."""
    from scipy.special import ndtri

    base = variant[:-4] if variant.endswith("_obj") else variant
    n = np.maximum(np.asarray(counts, dtype=np.float64), 1.0)
    total = float(num_images_total)
    if base == "raw":
        w = np.log(total / n)
    elif base == "smooth":
        w = np.log((total + 1.0) / (n + 1.0)) + 1.0
    elif base in ("prob", "rel"):
        w = np.log((total - n) / n)
    elif base == "normit":
        w = -ndtri(n / total)
    elif base == "gombit":
        w = -np.log(-np.log(1.0 - n / total))
    elif base == "base2":
        w = np.log2(total / n)
    elif base == "base10":
        w = np.log10(total / n)
    else:
        raise ValueError(f"unknown detection IIF variant {variant!r}; "
                         f"choose from {DET_IIF_VARIANTS} (+'_obj')")
    return np.concatenate([w, [1.0]]).astype(np.float32)


class DetIIFLoss:
    """IIF CE for the (C+1)-way detection classifier."""

    # mmdet custom-loss protocol: inference takes ``get_activation``
    # (``iif_loss.py:65-78``)
    custom_activation = True

    def __init__(self, weights, loss_weight: float = 1.0):
        self.weights = torch.as_tensor(np.asarray(weights, np.float32))
        self.loss_weight = loss_weight

    def to(self, device) -> "DetIIFLoss":
        self.weights = self.weights.to(device)
        return self

    def __call__(self, cls_score: torch.Tensor, labels: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor: Optional[torch.Tensor] = None,
                 reduction: str = "mean") -> torch.Tensor:
        scaled = cls_score * self.weights.to(cls_score.dtype)
        per = F.cross_entropy(scaled.float(), labels.long(),
                              reduction="none")
        if weight is not None:
            per = per * weight.to(per.dtype)
        if reduction == "none":
            return self.loss_weight * per
        if avg_factor is None:
            avg_factor = (per.new_tensor(float(per.numel())) if weight is None
                          else weight.sum())
        return self.loss_weight * per.sum() / torch.clamp(
            torch.as_tensor(avg_factor, dtype=per.dtype), min=1.0)

    def per_class_sums(self, cls_score: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """FASA's cum-loss counters (``fasa_iif_loss.py:154-161``): the
        per-sample loss summed by label, (C+1,)."""
        return _per_class_sums(self(cls_score, labels, weight=weight,
                                    reduction="none"),
                               labels, self.weights.shape[0])

    def get_activation(self, cls_score: torch.Tensor) -> torch.Tensor:
        """Inference scores = softmax(iif * score) (``iif_loss.py:65-78``)."""
        return torch.softmax(cls_score.float() * self.weights, dim=-1)


class DetCrossEntropyLoss:
    """Plain (C+1)-way CE (the stock mmdet configs' ``CrossEntropyLoss``,
    ``iif_tpu/detection/losses.py:166-220``): per-RoI softmax CE in f32,
    weighted, summed and divided by ``avg_factor`` (at least 1). With
    ``use_sigmoid`` the per-RoI loss is the BCE of each of the C+1
    logits against the one-hot label, summed over the channels,
    background included (mmdet's ``binary_cross_entropy`` with its
    labels one-hot, summed by ``weight_reduce_loss``). Inference is a
    softmax over the logits either way (``custom_activation`` is False,
    as on mmdet's ``CrossEntropyLoss``)."""

    custom_activation = False

    def __init__(self, num_classes: int = 0, loss_weight: float = 1.0,
                 use_sigmoid: bool = False):
        self.num_classes = num_classes
        self.loss_weight = loss_weight
        self.use_sigmoid = use_sigmoid

    def to(self, device) -> "DetCrossEntropyLoss":
        return self

    def __call__(self, cls_score: torch.Tensor, labels: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor: Optional[torch.Tensor] = None,
                 reduction: str = "mean") -> torch.Tensor:
        logits = cls_score.float()
        if self.use_sigmoid:
            # max(s, 0) - s * onehot + log1p(exp(-|s|)) in f32, JAX's order
            onehot = (labels.long()[..., None] == torch.arange(
                logits.shape[-1], device=logits.device)).float()
            per = (torch.clamp(logits, min=0.0) - logits * onehot
                   + torch.log1p(torch.exp(-torch.abs(logits)))).sum(-1)
        else:
            # softmax_cross_entropy (iif_tpu/losses/ce.py:13): logsumexp
            # minus the true logit, in f32
            per = torch.logsumexp(logits, dim=-1) - logits.gather(
                -1, labels.long()[..., None])[..., 0]
        if weight is not None:
            per = per * weight.to(per.dtype)
        if reduction == "none":
            return self.loss_weight * per
        if avg_factor is None:
            avg_factor = (per.new_tensor(float(per.numel())) if weight is None
                          else weight.sum())
        return self.loss_weight * per.sum() / torch.clamp(
            torch.as_tensor(avg_factor, dtype=per.dtype), min=1.0)

    def per_class_sums(self, cls_score: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """As ``DetIIFLoss.per_class_sums`` (``fasa_loss.py:10-101``)."""
        return _per_class_sums(self(cls_score, labels, weight=weight,
                                    reduction="none"),
                               labels, cls_score.shape[-1])

    def get_activation(self, cls_score: torch.Tensor) -> torch.Tensor:
        return torch.softmax(cls_score.float(), dim=-1)


def _per_class_sums(per: torch.Tensor, labels: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """(one_hot(labels, n) * per[:, None]).sum(0), as JAX sums it."""
    onehot = (labels[:, None] == torch.arange(n, device=labels.device)
              ).to(per.dtype)
    return (onehot * per[:, None]).sum(0)
