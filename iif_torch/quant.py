"""Int8 quantization-aware training: port of ``iif_tpu/quant.py``.

Symmetric int8 fake-quant with a straight-through gradient on the
weights, per output channel:

- ``fake_quant``: clip(round(x / s), -128, 127) * s forward, the incoming
  gradient unchanged backward (an autograd Function);
- ``weight_scale``: max |w| over every axis but the channel axis (or
  over all), at least 1e-8, over 127;
- ``observe_scales`` snapshots the scales (the observer freeze),
  ``fake_quant_params`` fake-quantizes the weights with live or frozen
  scales, ``quantize_tree`` / ``dequantize_tree`` convert to int8 and
  back with the same numbers as the fake-quant (so fake-quant evaluation
  is the converted model's).

What is quantized is what JAX's ``_is_quantizable`` marks: every flax
``kernel`` of rank 2 or more. In the port (``quant_specs``) that is
every convolution's weight, every ``nn.Linear``'s (the SE block's and
the plain heads'), ``NormedLinear``'s and ``CosNormClassifier``'s; not
BatchNorm's parameters, biases or the cosine head's scale. JAX's channel
is the kernel's last axis, which is the port's axis 0 for a convolution
(O, I / g, kh, kw) and a ``Linear`` (out, in), and axis 1 for
``NormedLinear`` (in, out) and ``CosNormClassifier`` (out, in), whose
flax kernel is (out, in) as well. ``NormedLinear`` stores flax's kernel
less 1 (flax draws U(0, 2) and subtracts 1 in its forward): the port
quantizes ``weight + 1`` and subtracts 1 again, so that it quantizes
JAX's tensor.

Parameters are a dict name -> tensor (``dict(model.named_parameters())``
by default); scales and int8 weights are dicts over the quantized names.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from iif_torch.models.layers import CosNormClassifier, NormedLinear

Params = Dict[str, torch.Tensor]


class QuantSpec(NamedTuple):
    axis: int            # the channel axis in the port's layout
    offset: float        # added before quantizing, taken off after


class FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        return torch.clamp(torch.round(x / scale), -128, 127) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize to the int8 grid of ``scale``; the gradient
    passes straight through to ``x``."""
    return FakeQuant.apply(x, scale)


def weight_scale(w: torch.Tensor, axis: Optional[int] = 0,
                 per_channel: bool = True) -> torch.Tensor:
    """Symmetric absmax scale: per channel along ``axis`` (kept as a
    size-1-elsewhere tensor that broadcasts against ``w``), or over the
    whole tensor."""
    w = w.detach()
    if per_channel and w.dim() >= 2:
        dims = tuple(d for d in range(w.dim()) if d != axis % w.dim())
        absmax = w.abs().amax(dim=dims, keepdim=True)
    else:
        absmax = w.abs().amax()
    return torch.clamp_min(absmax, 1e-8) / torch.full(
        (), 127.0, dtype=w.dtype, device=w.device)


def quant_specs(model: nn.Module) -> Dict[str, QuantSpec]:
    """Parameter name -> its ``QuantSpec`` for every weight JAX
    quantizes."""
    specs: Dict[str, QuantSpec] = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            specs[prefix + "weight"] = QuantSpec(0, 0.0)
        elif isinstance(mod, NormedLinear):
            specs[prefix + "weight"] = QuantSpec(1, 1.0)
        elif isinstance(mod, CosNormClassifier):
            specs[prefix + "weight"] = QuantSpec(1, 0.0)
    return specs


def _kernel(p: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    return p + spec.offset if spec.offset else p


def observe_scales(model: nn.Module, params: Optional[Params] = None,
                   per_channel: bool = True) -> Params:
    """The current scale of every quantized weight (the observer
    freeze's snapshot)."""
    params = dict(model.named_parameters()) if params is None else params
    return {name: weight_scale(_kernel(params[name], spec), spec.axis,
                               per_channel)
            for name, spec in quant_specs(model).items()}


def fake_quant_params(model: nn.Module, params: Optional[Params] = None,
                      scales: Optional[Params] = None,
                      per_channel: bool = True) -> Params:
    """Every quantized weight fake-quantized (straight-through
    gradients), with the frozen ``scales`` or, when None, live ones;
    the other parameters unchanged."""
    params = dict(model.named_parameters()) if params is None else params
    out = dict(params)
    for name, spec in quant_specs(model).items():
        k = _kernel(params[name], spec)
        s = (scales[name] if scales is not None
             else weight_scale(k, spec.axis, per_channel))
        q = fake_quant(k, s.detach())
        out[name] = q - spec.offset if spec.offset else q
    return out


def quantize_tree(model: nn.Module, params: Optional[Params] = None,
                  scales: Optional[Params] = None
                  ) -> Tuple[Params, Params]:
    """Convert: every quantized weight to int8 (the others unchanged),
    and the scales."""
    params = dict(model.named_parameters()) if params is None else params
    if scales is None:
        scales = observe_scales(model, params)
    out = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        for name, spec in quant_specs(model).items():
            k = _kernel(params[name], spec)
            out[name] = torch.clamp(torch.round(k / scales[name]), -128,
                                    127).to(torch.int8)
    return out, scales


def dequantize_tree(model: nn.Module, qparams: Params,
                    scales: Params) -> Params:
    """The int8 weights back to f32 (``q * s``, less ``NormedLinear``'s
    offset): equal to ``fake_quant_params`` with the same scales."""
    specs = quant_specs(model)
    out = dict(qparams)
    for name, q in qparams.items():
        if q.dtype == torch.int8:
            v = q.to(torch.float32) * scales[name]
            off = specs[name].offset
            out[name] = v - off if off else v
    return out


class QatConfig(NamedTuple):
    enabled: bool = False
    freeze_observer_epoch: int = 4   # torchvision recipe: epoch >= 4
    freeze_bn_epoch: int = 2         # torchvision recipe: epoch >= 2
    per_channel: bool = True
