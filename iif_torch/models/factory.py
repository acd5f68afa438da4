"""Classifier factory: port of ``iif_tpu/models/factory.py``, its 18
classifiers; other names raise ``KeyError``."""
from __future__ import annotations

from typing import Optional

import torch

from iif_torch.models import resnet as _big
from iif_torch.models import resnet_cifar as _cifar

_CLASSIFIER_MODELS = {
    "resnet20": _cifar.resnet20,
    "resnet32": _cifar.resnet32,
    "se_resnet32": _cifar.se_resnet32,
    "resnet44": _cifar.resnet44,
    "resnet56": _cifar.resnet56,
    "resnet110": _cifar.resnet110,
    "resnet1202": _cifar.resnet1202,
    "resnet18": _big.resnet18,
    "resnet34": _big.resnet34,
    "resnet50": _big.resnet50,
    "resnet101": _big.resnet101,
    "resnet152": _big.resnet152,
    "resnext50_32x4d": _big.resnext50_32x4d,
    "resnext101_32x8d": _big.resnext101_32x8d,
    "wide_resnet50_2": _big.wide_resnet50_2,
    "wide_resnet101_2": _big.wide_resnet101_2,
    "se_resnet50": _big.se_resnet50,
    "se_resnext50_32x4d": _big.se_resnext50_32x4d,
}


def build_classifier(name: str, num_classes: int,
                     use_norm: Optional[str] = None, bn_groups: int = 0,
                     compute_dtype: Optional[torch.dtype] = None):
    """``name``'s classifier with ``num_classes`` outputs, the head of
    ``use_norm``, BatchNorm over the whole batch (``bn_groups`` 0, flax's
    ``"bn"``) or over ``bn_groups`` groups of it (``"bn@G"``) and
    convolutions in ``compute_dtype``."""
    if name not in _CLASSIFIER_MODELS:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_CLASSIFIER_MODELS)}")
    return _CLASSIFIER_MODELS[name](
        num_classes=num_classes, use_norm=use_norm,
        bn_groups=bn_groups, compute_dtype=compute_dtype)


def classifier_model_names():
    return sorted(_CLASSIFIER_MODELS)
