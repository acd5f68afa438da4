"""FCN mask head and mask paste-back: port of
``iif_tpu/detection/mask_head.py`` (``FCNMaskHead`` with
``logits_for_labels``, ``paste_masks``) under mmdet's names
``convs.{i}.conv``, ``upsample``, ``conv_logits``.

The head takes the 14x14 RoI features in the trunk's dtype and computes in
f32 (flax promotes to its f32 parameters).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.detection.necks import ConvModule


class FCNMaskHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_convs: int = 4, conv_out_channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1)
            for i in range(num_convs)])
        self.upsample = nn.ConvTranspose2d(conv_out_channels,
                                           conv_out_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C_in) -> pre-logit features (R, C, 28, 28) NCHW."""
        x = x.permute(0, 3, 1, 2).float()
        for m in self.convs:
            x = F.relu(m.conv(x))
        return F.relu(self.upsample(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C_in) -> mask logits (R, 28, 28, num_classes)."""
        return self.conv_logits(self.features(x)).permute(0, 2, 3, 1)

    def logits_for_labels(self, x: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
        """Inference fast path: only each RoI's predicted-class channel,
        (R, 28, 28)."""
        feats = self.features(x)                               # (R, C, S, S)
        sel = self.conv_logits.weight[:, :, 0, 0][labels]      # (R, C)
        out = torch.einsum("rchw,rc->rhw", feats, sel)
        return out + self.conv_logits.bias[labels][:, None, None]


def _bilinear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """(R, out, in) weights of ``jax.image.scale_and_translate`` along one
    axis, bilinear (triangle kernel), ``antialias=False``: sample
    ``(o + 0.5 - t) / scale - 0.5``, weights normalised by their sum, zero
    where the sample lies outside ``[-0.5, in - 0.5]``."""
    dev = scale.device
    inv = 1.0 / scale[:, None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    sample = (o + 0.5) * inv - translation[:, None] * inv - 0.5   # (R, out)
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(sample[:, :, None] - j), min=0.0)
    total = w.sum(-1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


PASTE_CHUNK = 16    # RoIs per step: bounds the f32 temporaries


def paste_masks(mask_pred: torch.Tensor, boxes: torch.Tensor,
                img_shape: Tuple[int, int], threshold: float = 0.5
                ) -> torch.Tensor:
    """Paste each S x S mask into the image frame (``_do_paste_mask``).

    mask_pred (R, S, S) probabilities, boxes (R, 4) image coordinates.
    Returns (R, H, W) bool. The mask gets a one-cell zero ring and the box
    grows by one bin to match (as in the JAX package), then each RoI is
    resampled separably at the source coordinates of
    ``jax.image.scale_and_translate``, ``PASTE_CHUNK`` RoIs at a time."""
    h, w = img_shape
    s = mask_pred.shape[-1]
    padded = F.pad(mask_pred.float(), (1, 1, 1, 1))
    boxes = boxes.float()
    out = torch.empty((mask_pred.shape[0], h, w), dtype=torch.bool,
                      device=mask_pred.device)
    for lo in range(0, mask_pred.shape[0], PASTE_CHUNK):
        hi = lo + PASTE_CHUNK
        bx = boxes[lo:hi]
        bw = torch.clamp(bx[:, 2] - bx[:, 0], min=1.0) / s
        bh = torch.clamp(bx[:, 3] - bx[:, 1], min=1.0) / s
        wy = _bilinear_weights(s + 2, h, bh, bx[:, 1] - bh)   # (r, H, S+2)
        wx = _bilinear_weights(s + 2, w, bw, bx[:, 0] - bw)   # (r, W, S+2)
        pasted = torch.einsum("rhi,rij,rwj->rhw", wy, padded[lo:hi], wx)
        out[lo:hi] = pasted >= threshold
    return out
