"""Fresh classifier weights as the JAX package's ``model.init`` draws
them, each parameter from the family of its flax initialiser
(``iif_torch/detection/init.py`` does the same for the detectors):

- CIFAR ResNet-s convolutions ``variance_scaling(2, fan_in, normal)``
  (``models/layers.py:15``), ImageNet ResNet convolutions ``fan_out``
  (``models/resnet.py:26``), each fan from the kernel as flax holds it:
  a grouped (O, I / groups, kh, kw) weight is flax's (kh, kw, I / groups,
  O), fan-in ``kh kw I / groups``, fan-out ``kh kw O``;
- BN scale 1 (a bottleneck's ``bn3`` and a basic block's ``bn2`` 0),
  bias 0, running mean 0 and variance 1;
- SE dense layers and the plain head's kernel ``variance_scaling(2,
  fan_in, normal)``, its bias 0; ``NormedLinear`` U(-1, 1);
  ``CosNormClassifier`` U(-1, 1) / sqrt(in), its learned scale 5.

The numbers come from a ``torch.Generator``: the same families as flax's,
other draws.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from iif_torch.models.layers import CosNormClassifier, Linear, NormedLinear
from iif_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from iif_torch.models.resnet_cifar import ResNetS
from iif_torch.utils.init import ParamInit, head_of, receptive

def _head(init: ParamInit, head: nn.Module) -> None:
    w = head.weight
    if isinstance(head, Linear):
        init.normal(w, math.sqrt(2.0 / w.shape[1]))
        init.bias(head)
    elif isinstance(head, NormedLinear):
        init.uniform(w, 1.0)
    elif isinstance(head, CosNormClassifier):
        init.uniform(w, 1.0 / math.sqrt(w.shape[1]))
        if head.lr_scale:
            init.const(head.scale, 5.0)
    else:
        raise NotImplementedError(f"no fresh init for {type(head).__name__}")


def classifier_fresh_init_(model: nn.Module,
                           generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BN statistic of a ``ResNetS`` or a
    classifier ``ResNet`` in place."""
    if not isinstance(model, (ResNetS, ResNet)):
        raise NotImplementedError(
            f"no fresh init for {type(model).__name__}")
    fan = "in" if isinstance(model, ResNetS) else "out"
    init = ParamInit(generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                n = w.shape[1] if fan == "in" else w.shape[0]
                init.normal(w, math.sqrt(2.0 / (n * receptive(w))))
            elif isinstance(m, nn.BatchNorm2d):
                init.const(m.weight, 1.0)
                init.const(m.bias, 0.0)
                init.const(m.running_mean, 0.0)
                init.const(m.running_var, 1.0)
            elif isinstance(m, nn.Linear) and m is not head_of(model):
                init.normal(m.weight, math.sqrt(2.0 / m.weight.shape[1]))
        for m in model.modules():
            if isinstance(m, Bottleneck):
                init.const(m.bn3.weight, 0.0)
            elif isinstance(m, BasicBlock):
                init.const(m.bn2.weight, 0.0)
        _head(init, head_of(model))
    missed = [name for name, t in list(model.named_parameters())
              + list(model.named_buffers())
              if t.is_floating_point() and id(t) not in init.done]
    if missed:
        raise NotImplementedError(
            f"no fresh init for {len(missed)} tensors, e.g. {missed[:3]}")
    return model

