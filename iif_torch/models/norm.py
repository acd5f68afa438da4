"""BatchNorm with batch statistics, as the JAX package trains it:
``flax.linen.BatchNorm`` (norm spec ``"bn"``) and ``iif_tpu/models/
norm.py::LocalBatchNorm`` (``"bn@G"``: statistics within G equal groups of
the batch axis, the reference's per-GPU BN).

Both compute the statistics in f32 as E[x^2] - E[x]^2 clipped at 0 (flax's
``use_fast_variance``) and round the output to the input's dtype. Their
op orders differ: ``"bn"`` is ``(x - m) * (rsqrt(v + eps) * scale) +
bias``, ``"bn@G"`` is ``((x - m) * rsqrt(v + eps)) * scale + bias``. The
running buffers take the biased variance (``torch.nn.BatchNorm2d`` would
store the unbiased one), for ``"bn@G"`` the mean over the groups of each
group's statistics, with flax's ``momentum=0.9``: ``0.9 * r + 0.1 * s``.

``BatchNormTrain`` is an autograd Function: it saves only the input and
the per-group mean and rsqrt, and takes the analytic backward, where
autograd through the f32 passes would save several f32 copies of every
activation (a b256 SE-ResNet-50 at 224 would not fit in 80 GB). Its
gradient is the same function as JAX's autodiff of the forward, summed in
another order (``tests/test_torch_cls_models.py`` states the tolerance).
"""
from __future__ import annotations

from typing import Tuple

import torch

MOMENTUM = 0.9


def _grouped(t: torch.Tensor, g: int) -> torch.Tensor:
    """(N, C, H, W) -> (g, N/g, C, H, W), a view."""
    return t.unflatten(0, (g, t.shape[0] // g))


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    """(g, C) -> (g, 1, C, 1, 1) to broadcast against the grouped input."""
    return t[:, None, :, None, None]


class BatchNormTrain(torch.autograd.Function):
    """y = BN(x) with the batch's statistics; returns (y, mean, var), the
    per-group f32 statistics (g, C) as outputs without gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, eps: float, groups: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g = max(groups, 1)
        if x.shape[0] % g:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by groups {g}")
        xg = _grouped(x.float(), g)
        dims = (1, 3, 4)
        mean = xg.mean(dims)
        mean2 = (xg * xg).mean(dims)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        w = weight[None, :, None, None]
        b = bias[None, :, None, None]
        if groups == 0:                      # flax BatchNorm
            y = (xg - _per_channel(mean)) * _per_channel(rstd * weight) + b
        else:                                # LocalBatchNorm
            y = ((xg - _per_channel(mean)) * _per_channel(rstd)) * w + b
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.groups = g
        ctx.mark_non_differentiable(mean, var)
        return y.flatten(0, 1).to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy: torch.Tensor, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        g = ctx.groups
        dims = (1, 3, 4)
        r = _per_channel(rstd)
        xhat = (_grouped(x.float(), g) - _per_channel(mean)) * r
        dyg = _grouped(dy.float(), g)
        dbias = dyg.sum((0,) + dims)
        dweight = (dyg * xhat).sum((0,) + dims)
        dxhat = dyg * weight[None, :, None, None]
        dx = r * (dxhat - dxhat.mean(dims, keepdim=True)
                  - xhat * (dxhat * xhat).mean(dims, keepdim=True))
        return dx.flatten(0, 1).to(x.dtype), dweight, dbias, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, eps: float,
                     groups: int) -> torch.Tensor:
    """BN of ``x`` (N, C, H, W) with its batch statistics (``groups`` 0 for
    ``"bn"``, G for ``"bn@G"``); updates the running buffers in place."""
    y, mean, var = BatchNormTrain.apply(x, weight, bias, eps, groups)
    with torch.no_grad():
        running_mean.copy_(MOMENTUM * running_mean
                           + (1 - MOMENTUM) * mean.mean(0))
        running_var.copy_(MOMENTUM * running_var
                          + (1 - MOMENTUM) * var.mean(0))
    return y
