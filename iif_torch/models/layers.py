"""Classifier heads and the SE block: port of ``iif_tpu/models/layers.py``
(``NormedLinear``, ``CosNormClassifier`` with and without ``lr_scale``,
``SEBlock``, ``make_classifier_head``), selected by ``--classif_norm`` in
{None, norm, cosine, lr_cosine}, and the detection head's
``IIFNormedLinear``.

dtypes follow flax: the plain head (flax ``Dense`` with ``dtype=None``)
promotes a bf16 pooled feature to f32 against its f32 kernel, so it
computes in f32 on the bf16-rounded feature; the normed and cosine heads
cast their normalised weights to the feature's dtype and compute in it.
The SE block's dense layers likewise compute in f32, and its output is
f32 (the bf16 input times the f32 gate).

Parameters hold the reference's values: ``NormedLinear.weight`` and
``IIFNormedLinear.weight`` (in, out) are flax's kernel less 1 (flax draws
U(0, 2) and subtracts 1 in its forward), ``CosNormClassifier.weight``
(out, in) flax's kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-12


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, w.dtype))


class Linear(nn.Linear):
    """flax ``Dense(dtype=None)``: the input promoted against the f32
    kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_promoted(x, self.weight), self.weight, self.bias)


class NormedLinear(nn.Module):
    """Cosine classifier ``normalize(x) @ normalize(W, columns)``, times a
    fixed ``temperature``."""

    def __init__(self, in_features: int, out_features: int,
                 temperature: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.temperature = temperature

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / (torch.linalg.vector_norm(
            self.weight, dim=0, keepdim=True) + EPS)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
        return self.temperature * (x @ w.to(x.dtype))


class IIFNormedLinear(nn.Module):
    """``NormedLinear`` whose weight columns are multiplied by the IIF
    vector before they are normalised (reference ``normed_predictor.py:
    43-76``): ``normalize(x) @ normalize(W * iif, columns)``, times
    ``temperature``. ``iif`` is a buffer (it comes from the dataset, as
    JAX's static field; not saved in a state_dict), one entry an output.

    A positive entry scales its column and the normalisation divides it
    out again, so the output equals ``NormedLinear``'s to rounding; a zero
    entry zeroes its column. The port computes what JAX computes."""

    def __init__(self, in_features: int, out_features: int, iif_weights,
                 temperature: float = 8.0):
        super().__init__()
        iif = torch.as_tensor(iif_weights, dtype=torch.float32)
        if iif.shape != (out_features,):
            raise ValueError(f"{tuple(iif.shape)} IIF weights for "
                             f"{out_features} outputs")
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.register_buffer("iif", iif.clone(), persistent=False)
        self.temperature = temperature

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * self.iif[None, :]
        w = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + EPS)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
        return self.temperature * (x @ w.to(x.dtype))


class CosNormClassifier(nn.Module):
    """Scaled cosine classifier with ``|x| / (1 + |x|)`` feature squashing;
    with ``lr_scale`` the scale is a parameter (5.0 at init) squared in
    the forward."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 16.0, lr_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.lr_scale = lr_scale
        if lr_scale:
            self.scale = nn.Parameter(torch.full((1,), 5.0))
        else:
            self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm_x = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        ex = (norm_x / (1.0 + norm_x)) * (x / (norm_x + EPS))
        ew = self.weight / (torch.linalg.vector_norm(
            self.weight, dim=-1, keepdim=True) + EPS)
        out = ex @ ew.t().to(x.dtype)
        if self.lr_scale:
            return (self.scale.to(x.dtype) ** 2) * out
        return self.scale * out


class SEBlock(nn.Module):
    """Squeeze-and-excitation on NCHW: global mean, ``fc1`` (C -> C/r),
    ReLU, ``fc2``, sigmoid, a channel gate; no biases."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _promoted(x.mean((2, 3)), self.fc1.weight)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y[:, :, None, None]


def make_classifier_head(in_features: int, num_classes: int,
                         use_norm: Optional[str]) -> nn.Module:
    """The head of ``--classif_norm``."""
    if use_norm == "norm":
        return NormedLinear(in_features, num_classes)
    if use_norm == "cosine":
        return CosNormClassifier(in_features, num_classes)
    if use_norm == "lr_cosine":
        return CosNormClassifier(in_features, num_classes, lr_scale=True)
    if use_norm in (None, "None", "", "linear"):
        return Linear(in_features, num_classes)
    raise ValueError(f"unknown classifier norm {use_norm!r}")
