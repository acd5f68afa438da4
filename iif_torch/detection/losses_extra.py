"""The Seesaw loss: port of ``iif_tpu/detection/losses_extra.py``
(``seesaw_ce_loss``, ``SeesawLoss``), the reference's
``mmdet/models/losses/seesaw_loss.py`` (Seesaw CE for long-tailed
instance segmentation, CVPR 2021).

The classifier emits C+2 channels: C class logits and a 2-way objectness
pair (``get_cls_channels``); inference scores are the class softmax times
P(object), the background P(not object). ``cum_samples`` (C+1, the
background included) counts the labels of weight > 0 seen so far; the
trainer threads it as state (``update_cum`` before the loss reads it,
``detection/detector.py::maskrcnn_loss``), as the JAX package threads it
where the reference mutates a buffer.

Everything computes in f32 in JAX's op order: ``max(cum, 1)``, the
mitigation ``ratio ** p`` only where ``ratio < 1``, the compensation from
the softmax of the detached scores divided by ``max(self_score, eps)`` (a
tensor divisor: PyTorch's CUDA division by a Python scalar multiplies by
its reciprocal), then ``log(seesaw) * (1 - onehot)`` added to the logits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from iif_torch.losses.ce import softmax_cross_entropy

# the counts in a checkpoint's state_dict, under mmdet's buffer name
SEESAW_CUM_KEY = "roi_head.bbox_head.loss_cls.cum_samples"


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    return (labels.long()[..., None] == torch.arange(
        n, device=labels.device)).float()


def seesaw_ce_loss(cls_score: torch.Tensor, labels: torch.Tensor,
                   cum_samples: torch.Tensor, p: float, q: float,
                   eps: float) -> torch.Tensor:
    """Per-sample Seesaw CE (``seesaw_loss.py:12-77``): ``cls_score``
    (N, C) class logits, ``labels`` (N,) in [0, C), ``cum_samples`` (C,).
    Returns the (N,) unreduced losses."""
    num_classes = cls_score.shape[-1]
    cls_score = cls_score.float()
    labels = labels.long()
    onehot = _one_hot(labels, num_classes)
    seesaw = torch.ones((labels.shape[0], num_classes), dtype=torch.float32,
                        device=cls_score.device)
    if p > 0:
        cum = torch.clamp(cum_samples.float(), min=1.0)
        ratio = cum[None, :] / cum[:, None]                 # (C, C)
        sample_w = torch.where(ratio < 1.0, ratio ** p,
                               torch.ones_like(ratio))
        seesaw = seesaw * sample_w[labels]                  # mitigation
    if q > 0:
        scores = torch.softmax(cls_score.detach(), dim=-1)
        self_scores = scores.gather(-1, labels[:, None])
        score_ratio = scores / torch.clamp(self_scores, min=eps)
        comp = torch.where(score_ratio > 1.0, score_ratio ** q,
                           torch.ones_like(score_ratio))
        seesaw = seesaw * comp                              # compensation
    shifted = cls_score + torch.log(seesaw) * (1.0 - onehot)
    return softmax_cross_entropy(shifted, labels)


class SeesawLoss:
    """Seesaw loss with mmdet's custom-loss protocol
    (``seesaw_loss.py:80-262``): ``custom_cls_channels``,
    ``custom_activation`` and ``custom_accuracy``. ``cum_samples`` (C+1,)
    f32; ``with_cum`` gives the loss at another count, ``update_cum`` the
    counts after a step's labels."""

    custom_cls_channels = True
    custom_activation = True
    custom_accuracy = True

    def __init__(self, cum_samples, p: float = 0.8, q: float = 2.0,
                 eps: float = 1e-2, loss_weight: float = 1.0):
        self.cum_samples = torch.as_tensor(cum_samples, dtype=torch.float32)
        self.p, self.q, self.eps = p, q, eps
        self.loss_weight = loss_weight

    @property
    def num_classes(self) -> int:
        return self.cum_samples.shape[0] - 1

    def get_cls_channels(self, num_classes: int) -> int:
        return num_classes + 2

    def to(self, device) -> "SeesawLoss":
        self.cum_samples = self.cum_samples.to(device)
        return self

    def with_cum(self, cum_samples: torch.Tensor) -> "SeesawLoss":
        """The same loss at ``cum_samples`` (JAX's
        ``dataclasses.replace``)."""
        return SeesawLoss(cum_samples, self.p, self.q, self.eps,
                          self.loss_weight)

    def _split(self, cls_score: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return cls_score[..., :-2], cls_score[..., -2:]

    def update_cum(self, labels: torch.Tensor,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cum_samples`` after counting the labels whose weight is > 0."""
        onehot = _one_hot(labels, self.num_classes + 1)
        if weight is not None:
            onehot = onehot * (weight > 0).float()[:, None]
        return self.cum_samples + onehot.sum(0)

    def __call__(self, cls_score: torch.Tensor, labels: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None, reduction: str = "mean") -> torch.Tensor:
        """The classes' loss, a mean over the positives, plus the
        objectness loss, a mean over the valid samples or ``avg_factor``
        (the reference returns them as a dict and the runner adds them)."""
        c = self.num_classes
        labels = labels.long()
        lw = (torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device) if weight is None
              else weight.float())
        score_classes, score_obj = self._split(cls_score)
        pos = (labels < c).float() * (lw > 0)
        per_cls = seesaw_ce_loss(score_classes, torch.clamp(labels, 0, c - 1),
                                 self.cum_samples[:c], self.p, self.q,
                                 self.eps)
        per_obj = softmax_cross_entropy(score_obj, (labels == c).long())
        if reduction == "none":
            return self.loss_weight * (per_cls * pos + per_obj) * lw
        l_classes = (per_cls * pos * lw).sum() / torch.clamp(pos.sum(),
                                                             min=1.0)
        denom = ((lw > 0).float().sum() if avg_factor is None
                 else torch.as_tensor(avg_factor, dtype=torch.float32,
                                      device=lw.device))
        l_obj = (per_obj * lw).sum() / torch.clamp(denom, min=1.0)
        return self.loss_weight * (l_classes + l_obj)

    def get_activation(self, cls_score: torch.Tensor) -> torch.Tensor:
        """(..., C+2) -> (..., C+1) scores: class softmax x P(object),
        the background P(not object) (``seesaw_loss.py:156-176``)."""
        score_classes, score_obj = self._split(cls_score.float())
        cls_sm = torch.softmax(score_classes, dim=-1)
        obj_sm = torch.softmax(score_obj, dim=-1)
        return torch.cat([cls_sm * obj_sm[..., :1], obj_sm[..., 1:]], dim=-1)

    def get_accuracy(self, cls_score: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
        """The positives' top-1 accuracy over the class logits, in %."""
        score_classes, _ = self._split(cls_score)
        pred = score_classes.argmax(-1)
        pos = labels < self.num_classes
        return ((pred == labels) & pos).sum().float() / torch.clamp(
            pos.sum(), min=1).float() * 100.0
