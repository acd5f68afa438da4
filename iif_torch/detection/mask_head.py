"""FCN mask head, its training targets and loss, and mask paste-back:
port of ``iif_tpu/detection/mask_head.py`` (``NormedConv2d``,
``FCNMaskHead`` with the conv and the normed predictor and
``logits_for_labels``, ``mask_targets``, ``mask_head_loss``,
``paste_masks``) under mmdet's names ``convs.{i}.conv``, ``upsample``,
``conv_logits``, and HTC's mask head with its information-flow residual
(``iif_tpu/detection/htc.py::HTCMaskHead``, mmdet's ``conv_res.conv``).

The head takes the 14x14 RoI features in the trunk's dtype and computes in
f32 (flax promotes to its f32 parameters). The normed predictor's
``conv_logits.weight`` is JAX's (C_in, num_classes) kernel as it stands.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iif_torch.detection.necks import ConvModule
from iif_torch.detection.rpn import bce_with_logits


EPS = 1e-12


class NormedConv2d(nn.Module):
    """1x1 cosine conv on channels-last features: the features over their
    L2 norm times the kernel's columns over theirs, scaled by
    ``temperature`` (``normed_predictor.py:78-124``)."""

    def __init__(self, in_channels: int, num_classes: int,
                 temperature: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, num_classes))
        self.temperature = temperature

    def normed_weight(self) -> torch.Tensor:
        return self.weight / (torch.linalg.vector_norm(
            self.weight, dim=0, keepdim=True) + EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., C_in) -> (..., num_classes)."""
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
        return self.temperature * (xn @ self.normed_weight().to(x.dtype))


class FCNMaskHead(nn.Module):
    """``predictor`` is ``"conv"`` (a 1x1 conv with a bias) or
    ``"normed"`` (``NormedConv2d`` at ``temperature``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_convs: int = 4, conv_out_channels: int = 256,
                 predictor: str = "conv", temperature: float = 20.0):
        super().__init__()
        if predictor not in ("conv", "normed"):
            raise NotImplementedError(
                f"mask predictor {predictor!r} is not ported")
        self.predictor = predictor
        self.temperature = temperature
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1)
            for i in range(num_convs)])
        self.upsample = nn.ConvTranspose2d(conv_out_channels,
                                           conv_out_channels, 2, stride=2)
        if predictor == "normed":
            self.conv_logits = NormedConv2d(conv_out_channels, num_classes,
                                            temperature)
        else:
            self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C_in) -> pre-logit features (R, C, 28, 28) NCHW."""
        x = x.permute(0, 3, 1, 2).float()
        for m in self.convs:
            x = F.relu(m.conv(x))
        return F.relu(self.upsample(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C_in) -> mask logits (R, 28, 28, num_classes)."""
        feats = self.features(x)
        if self.predictor == "normed":
            return self.conv_logits(feats.permute(0, 2, 3, 1))
        return self.conv_logits(feats).permute(0, 2, 3, 1)

    def logits_for_labels(self, x: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
        """Only each RoI's own class channel, (R, 28, 28). The normed
        branch normalises the kernel's columns and the features, and
        scales the gathered columns by the temperature, in JAX's order."""
        feats = self.features(x)                               # (R, C, S, S)
        if self.predictor == "normed":
            sel = self.conv_logits.normed_weight().t()[labels]  # (R, C)
            feats = feats / (torch.linalg.vector_norm(
                feats, dim=1, keepdim=True) + EPS)
            return torch.einsum("rchw,rc->rhw", feats,
                                sel * self.temperature)
        sel = self.conv_logits.weight[:, :, 0, 0][labels]      # (R, C)
        out = torch.einsum("rchw,rc->rhw", feats, sel)
        return out + self.conv_logits.bias[labels][:, None, None]


class HTCMaskHead(FCNMaskHead):
    """HTC's FCN mask head (``htc_mask_head.py``): the trunk (the 3x3
    convs) takes the previous stage's trunk output through ``conv_res``, a
    1x1 conv and a ReLU, added to its input. ``with_conv_res=False`` builds
    no ``conv_res``, as mmdet's HTC builds its first stage (the JAX
    package creates one on every stage and never calls stage 0's). Only
    the conv predictor, as JAX's ``logits_for_labels_from_trunk`` reads a
    1x1 conv kernel."""

    def __init__(self, num_classes: int, with_conv_res: bool = True,
                 conv_out_channels: int = 256, predictor: str = "conv"):
        if predictor != "conv":
            raise NotImplementedError(
                f"HTC mask predictor {predictor!r} is not ported")
        super().__init__(num_classes, conv_out_channels=conv_out_channels)
        self.conv_res = (ConvModule(conv_out_channels, conv_out_channels, 1)
                         if with_conv_res else None)

    def trunk(self, x: torch.Tensor,
              res_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(R, 14, 14, C_in) RoI features and the previous stage's trunk
        output (R, C, 14, 14) or None -> this trunk's (R, C, 14, 14) NCHW,
        in f32 as the cascade's mask heads compute."""
        x = x.permute(0, 3, 1, 2).float()
        if res_feat is not None:
            x = x + F.relu(self.conv_res.conv(res_feat))
        for m in self.convs:
            x = F.relu(m.conv(x))
        return x

    def logits_for_labels_from_trunk(self, trunk: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
        """Each RoI's own class channel of the logits on a trunk output,
        (R, 28, 28)."""
        feats = F.relu(self.upsample(trunk))
        sel = self.conv_logits.weight[:, :, 0, 0][labels]      # (R, C)
        out = torch.einsum("rchw,rc->rhw", feats, sel)
        return out + self.conv_logits.bias[labels][:, None, None]


def mask_targets(
    pos_rois: torch.Tensor,      # (R, 5) batch-indexed rois (positives)
    pos_gt_inds: torch.Tensor,   # (R,) matched gt index within its image
    gt_masks: torch.Tensor,      # (B, G, H/s, W/s) binary
    mask_size: int = 28,
    gt_stride: int = 1,
) -> torch.Tensor:
    """Each positive RoI's matched gt mask cropped to ``mask_size``^2 on
    RoIAlign's grid (aligned, 2 samples per bin averaged), thresholded at
    0.5 (``mask_head.py:219-271``). Returns (R, S, S) float32.

    The crop is separable: Wy @ M @ Wx^T with per-RoI tent weights. It
    rounds where the JAX package rounds (the weights and the intermediate
    to bf16, the mask is 0/1 and exact in bf16) and takes each product in
    f32 on those bf16 values, so the only difference left is the order
    of the f32 sums."""
    b, g, h, w = gt_masks.shape
    r, s2 = pos_rois.shape[0], 2
    dev = pos_rois.device
    sel = gt_masks.reshape(b * g, h, w)[
        pos_rois[:, 0].long() * g + pos_gt_inds.long()]
    sel = sel.to(torch.bfloat16).float()                   # (R, H/s, W/s)

    scale = 1.0 / gt_stride
    x1 = pos_rois[:, 1] * scale - 0.5
    y1 = pos_rois[:, 2] * scale - 0.5
    x2 = pos_rois[:, 3] * scale - 0.5
    y2 = pos_rois[:, 4] * scale - 0.5
    jj = (torch.arange(mask_size * s2, dtype=torch.float32, device=dev)
          + 0.5) / s2
    ysamp = torch.clamp(y1[:, None] + (y2 - y1)[:, None] / mask_size * jj,
                        0.0, h - 1.0)                       # (R, 2S)
    xsamp = torch.clamp(x1[:, None] + (x2 - x1)[:, None] / mask_size * jj,
                        0.0, w - 1.0)
    hgrid = torch.arange(h, dtype=torch.float32, device=dev)
    wgrid = torch.arange(w, dtype=torch.float32, device=dev)
    wy = torch.clamp(1.0 - torch.abs(ysamp[:, :, None] - hgrid), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(xsamp[:, :, None] - wgrid), min=0.0)
    wy = wy.reshape(r, mask_size, s2, h).mean(2).to(torch.bfloat16).float()
    wx = wx.reshape(r, mask_size, s2, w).mean(2).to(torch.bfloat16).float()
    a = torch.bmm(wy, sel).to(torch.bfloat16).float()       # (R, S, W/s)
    crops = torch.bmm(a, wx.transpose(1, 2))                 # (R, S, S)
    return (crops >= 0.5).float()


def mask_head_loss(
    mask_pred: torch.Tensor,     # (R, S, S) logits of each RoI's class
    mask_tgt: torch.Tensor,      # (R, S, S)
    pos_weight: torch.Tensor,    # (R,) 1 for real positives
) -> torch.Tensor:
    """Per-pixel BCE averaged per RoI, then over the real positives
    (``mask_head.py:274-295``)."""
    per_roi = bce_with_logits(mask_pred.float(), mask_tgt).mean(dim=(1, 2))
    return (per_roi * pos_weight).sum() / torch.clamp(pos_weight.sum(),
                                                      min=1.0)


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
