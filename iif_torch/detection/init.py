"""Fresh weights as the JAX package's ``model.init`` draws them: each
parameter and BN statistic from the family of its flax initialiser.

- ResNet trunk and C4's res5 (``iif_tpu/models/resnet.py:27, 43, 211``):
  convolutions ``variance_scaling(2, fan_out, normal)``; BN scale 1 (the
  residual ``bn3`` 0, zero-init-residual), bias 0, running mean 0 and
  variance 1.
- FPN (``detection/necks.py:16``): ``xavier_uniform``, bias 0.
- RPN head (``detection/rpn.py:30``): ``normal(0.01)``, bias 0.
- Shared2FC bbox head (``detection/bbox_head.py:69-89``): the shared FCs
  flax's ``Dense`` default, ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1 / fan_in); a linear ``fc_cls`` from
  ``cls_init``, ``("constant", v)`` or ``("normal", std)`` with an
  optional third element for its bias, a normed one (``NormedLinear``,
  ``models/layers.py:35-40``, or ``IIFNormedLinear``, ``:57-63``, whose
  IIF buffer is the dataset's) U(0, 2) less the 1 its forward subtracts,
  so U(-1, 1); ``fc_reg`` ``normal(0.001)``; biases 0.
- FCN mask head (``detection/mask_head.py:52-73``): convolutions
  ``variance_scaling(2, fan_out, normal)``, the transposed convolution
  ``lecun_normal``, a conv ``conv_logits`` ``normal(0.001)``, a normed
  one (``NormedConv2d``, ``mask_head.py:31``) ``lecun_normal`` over its
  (C_in, num_classes) kernel, biases 0.
- HTC's mask head (``detection/htc.py:56-84``): the FCN head as above,
  and its ``conv_res`` flax ``nn.Conv``'s defaults, ``lecun_normal``
  with bias 0.
- Cascade Mask R-CNN and HTC: the trunk and each stage's heads as above.
- C4 bbox head (``detection/c4.py:51-57``): ``fc_cls`` ``normal(0.01)``,
  ``fc_reg`` ``normal(0.001)``, biases 0.

The numbers come from a ``torch.Generator``, not JAX's keys: the same
families, other draws. ``random_init_`` (``detection/detector.py``) stays
for the parity tests and for serving without a checkpoint.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from iif_torch.detection.bbox_head import Shared2FCBBoxHead
from iif_torch.detection.c4 import C4BBoxHead
from iif_torch.detection.mask_head import (
    FCNMaskHead,
    HTCMaskHead,
    NormedConv2d,
)
from iif_torch.detection.necks import FPN
from iif_torch.detection.rpn import RPNHead
from iif_torch.models.layers import IIFNormedLinear, NormedLinear
from iif_torch.models.resnet import Bottleneck, ResLayer, ResNet
from iif_torch.utils.init import ParamInit, receptive

def _conv_fan_out(init: ParamInit, conv: nn.Conv2d) -> None:
    """``variance_scaling(2, fan_out, normal)``: fan_out = out x kh x kw."""
    w = conv.weight
    init.normal(w, math.sqrt(2.0 / (w.shape[0] * receptive(w))))
    init.bias(conv)


def _trunk(init: ParamInit, trunk: nn.Module) -> None:
    for m in trunk.modules():
        if isinstance(m, nn.Conv2d):
            _conv_fan_out(init, m)
        elif isinstance(m, nn.BatchNorm2d):
            init.const(m.weight, 1.0)
            init.const(m.bias, 0.0)
            init.const(m.running_mean, 0.0)
            init.const(m.running_var, 1.0)
    for m in trunk.modules():
        if isinstance(m, Bottleneck):
            init.const(m.bn3.weight, 0.0)


def _fpn(init: ParamInit, fpn: FPN) -> None:
    """``xavier_uniform``: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    for m in fpn.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            fans = (w.shape[0] + w.shape[1]) * receptive(w)
            init.uniform(w, math.sqrt(6.0 / fans))
            init.bias(m)


def _rpn(init: ParamInit, rpn: RPNHead) -> None:
    for conv in (rpn.rpn_conv, rpn.rpn_cls, rpn.rpn_reg):
        init.normal(conv.weight, 0.01)
        init.bias(conv)


def _linear_lecun(init: ParamInit, fc: nn.Linear) -> None:
    init.truncated_normal(fc.weight, math.sqrt(1.0 / fc.weight.shape[1]))
    init.bias(fc)


def _bbox_head(init: ParamInit, head: Shared2FCBBoxHead) -> None:
    for fc in head.shared_fcs:
        _linear_lecun(init, fc)
    if isinstance(head.fc_cls, (NormedLinear, IIFNormedLinear)):
        init.uniform(head.fc_cls.weight, 1.0)
        if isinstance(head.fc_cls, IIFNormedLinear):   # data, not a draw
            init.done.add(id(head.fc_cls.iif))
    else:
        kind, value = head.cls_init[:2]
        if kind == "constant":
            init.const(head.fc_cls.weight, value)
        elif kind == "normal":
            init.normal(head.fc_cls.weight, value)
        else:
            raise ValueError(
                f"cls_init must be constant or normal, got {kind!r}")
        init.bias(head.fc_cls, head.cls_init[2] if len(head.cls_init) > 2
                  else 0.0)
    init.normal(head.fc_reg.weight, 0.001)
    init.bias(head.fc_reg)


def _mask_head(init: ParamInit, head: FCNMaskHead) -> None:
    for m in head.convs:
        _conv_fan_out(init, m.conv)
    up = head.upsample.weight                 # (in, out, kh, kw)
    init.truncated_normal(up, math.sqrt(1.0 / (up.shape[0] * receptive(up))))
    init.bias(head.upsample)
    w = head.conv_logits.weight
    if isinstance(head.conv_logits, NormedConv2d):
        init.truncated_normal(w, math.sqrt(1.0 / w.shape[0]))
        return
    init.normal(w, 0.001)
    init.bias(head.conv_logits)


def _htc_mask_head(init: ParamInit, head: HTCMaskHead) -> None:
    _mask_head(init, head)
    if head.conv_res is not None:
        w = head.conv_res.conv.weight
        init.truncated_normal(w, math.sqrt(1.0 / (w.shape[1] * receptive(w))))
        init.bias(head.conv_res.conv)


def _c4_bbox_head(init: ParamInit, head: C4BBoxHead) -> None:
    init.normal(head.fc_cls.weight, 0.01)
    init.bias(head.fc_cls)
    init.normal(head.fc_reg.weight, 0.001)
    init.bias(head.fc_reg)


_FAMILIES = ((ResNet, _trunk), (ResLayer, _trunk), (FPN, _fpn),
             (RPNHead, _rpn), (Shared2FCBBoxHead, _bbox_head),
             (FCNMaskHead, _mask_head), (HTCMaskHead, _htc_mask_head),
             (C4BBoxHead, _c4_bbox_head))


def fresh_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BN statistic of ``model`` (a detector, or
    any module built of the families above) from its flax initialiser's
    family, in place. Raises ``NotImplementedError`` if a parameter or
    statistic belongs to no known family."""
    init = ParamInit(generator)
    with torch.no_grad():
        for m in model.modules():
            for cls, fill in _FAMILIES:
                if type(m) is cls:
                    fill(init, m)
    missed = [name for name, t in list(model.named_parameters())
              + list(model.named_buffers())
              if t.is_floating_point() and id(t) not in init.done]
    if missed:
        raise NotImplementedError(
            f"no fresh init for {len(missed)} tensors, e.g. {missed[:3]}")
    return model
