"""Parameter-init helpers shared by the detectors' and the classifiers'
fresh init (``detection/init.py``, ``models/init.py``) and the decoupled
schedule (``engine/schedules.py``): draws into tensors as flax's families
do, and the classifier head's names."""
from __future__ import annotations

import math

import torch
from torch import nn

HEAD_NAMES = ("linear", "fc")

# flax's truncated_normal variance scaling divides the standard deviation
# by the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class ParamInit:
    """Draws into tensors from one generator and remembers which it
    filled."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.done = set()

    def _set(self, t: torch.Tensor, value: torch.Tensor) -> None:
        t.copy_(value)
        self.done.add(id(t))

    def const(self, t: torch.Tensor, value: float) -> None:
        self._set(t, torch.full(t.shape, float(value)))

    def normal(self, t: torch.Tensor, std: float) -> None:
        self._set(t, torch.randn(t.shape, generator=self.generator) * std)

    def uniform(self, t: torch.Tensor, limit: float) -> None:
        u = torch.rand(t.shape, generator=self.generator)
        self._set(t, (2.0 * u - 1.0) * limit)

    def truncated_normal(self, t: torch.Tensor, std: float) -> None:
        """A unit normal truncated to [-2, 2] times ``std / _TRUNC_STD``
        (flax's ``truncated_normal``): the draws outside redrawn until
        none is left (4.6% a round), a tenth of ``nn.init.trunc_normal_``'s
        time (its inverse error function) on a (12544, 1024) FC."""
        v = torch.randn(t.numel(), generator=self.generator)
        out = torch.nonzero(v.abs() > 2.0)[:, 0]
        while out.numel():
            redraw = torch.randn(out.numel(), generator=self.generator)
            v[out] = redraw
            out = out[redraw.abs() > 2.0]
        self._set(t, v.reshape(t.shape) * (std / _TRUNC_STD))

    def bias(self, layer: nn.Module, value: float = 0.0) -> None:
        if layer.bias is not None:
            self.const(layer.bias, value)


def receptive(weight: torch.Tensor) -> int:
    return math.prod(weight.shape[2:])


def head_of(model: nn.Module) -> nn.Module:
    """The classifier head (``linear`` or ``fc``)."""
    for name in HEAD_NAMES:
        head = getattr(model, name, None)
        if isinstance(head, nn.Module):
            return head
    raise ValueError(f"{type(model).__name__} has no classifier head")
