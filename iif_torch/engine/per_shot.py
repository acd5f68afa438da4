"""Shot-stratified accuracy: port of ``iif_tpu/engine/per_shot.py``.
Classes with more than 100 train images are many-shot, fewer than 20
low-shot, the rest median; each bucket reports the mean of its classes'
accuracies."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def shot_acc(preds: np.ndarray, labels: np.ndarray,
             train_targets: Sequence[int], many_shot_thr: int = 100,
             low_shot_thr: int = 20, acc_per_cls: bool = False):
    training_labels = np.asarray(train_targets).astype(int)
    preds = np.asarray(preds)
    labels = np.asarray(labels).astype(int)
    classes = np.unique(labels)
    width = int(max(classes.max(), training_labels.max(initial=0))) + 1
    train_count = np.bincount(training_labels, minlength=width)[classes]
    test_count = np.bincount(labels, minlength=width)[classes]
    correct = np.bincount(labels[preds == labels], minlength=width)[classes]
    class_accs = correct / test_count
    many_m = train_count > many_shot_thr
    low_m = train_count < low_shot_thr
    med_m = ~(many_m | low_m)

    def _mean(mask):
        return float(class_accs[mask].mean()) if mask.any() else 0.0

    if acc_per_cls:
        return _mean(many_m), _mean(med_m), _mean(low_m), class_accs.tolist()
    return _mean(many_m), _mean(med_m), _mean(low_m)
