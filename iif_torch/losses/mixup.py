"""Mixup: port of ``iif_tpu/losses/mixup.py``, with the draw apart from
the mix so that a caller (a test) can hand in another draw.

``sample_mixup`` draws lambda ~ Beta(alpha, alpha) on the host from a
NumPy ``RandomState`` (a Python float, which enters the mix as a kernel
scalar: no host sync) and the batch permutation from a
``torch.Generator`` on the batch's device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def sample_mixup(rng: np.random.RandomState, generator: torch.Generator,
                 batch: int, alpha: float) -> Tuple[float, torch.Tensor]:
    """(lam, index): lam ~ Beta(alpha, alpha) (1 when alpha <= 0), rounded
    to f32, and a random permutation of the batch on ``generator``'s
    device."""
    lam = float(np.float32(rng.beta(alpha, alpha))) if alpha > 0 else 1.0
    index = torch.randperm(batch, generator=generator,
                           device=generator.device)
    return lam, index


def mixup_batch(x: torch.Tensor, y: torch.Tensor, lam, index: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]:
    """(mixed_x, y_a, y_b, lam). As in JAX, the f32 ``lam`` promotes a
    bf16 batch: the mix is f32. ``lam`` is rounded to f32 first, so that
    ``1 - lam`` is JAX's f32 difference."""
    lam = float(np.float32(lam))
    index = torch.as_tensor(index, device=x.device).long()
    xf = x.float()
    return lam * xf + (1.0 - lam) * xf[index], y, y[index], lam


def mixup_criterion(criterion: Callable, logits: torch.Tensor,
                    y_a: torch.Tensor, y_b: torch.Tensor,
                    lam: float) -> torch.Tensor:
    return lam * criterion(logits, y_a) + (1.0 - lam) * criterion(logits, y_b)
