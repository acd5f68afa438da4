"""Epoch orders: port of ``iif_tpu/data/samplers.py`` (a seeded
permutation a epoch, DistributedSampler's seed + epoch convention; and
catalyst ``BalanceClassSampler``'s up- and down-sampling), equal to the
JAX package's."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def random_epoch_order(n: int, epoch: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + epoch).permutation(n)


def balanced_epoch_order(targets: Sequence[int], epoch: int,
                         mode: str = "upsampling",
                         seed: int = 0) -> np.ndarray:
    """Each class contributes its largest class's count (``upsampling``,
    drawn with replacement) or its smallest's (``downsampling``), then
    one global shuffle."""
    targets = np.asarray(targets)
    classes, counts = np.unique(targets, return_counts=True)
    per_class = counts.max() if mode == "upsampling" else counts.min()
    rng = np.random.RandomState(seed + epoch)
    chunks = []
    for c in classes:
        idx = np.where(targets == c)[0]
        if mode == "upsampling":
            chunks.append(rng.choice(idx, size=per_class, replace=True))
        else:
            rng.shuffle(idx)
            chunks.append(idx[:per_class])
    order = np.concatenate(chunks)
    rng.shuffle(order)
    return order
