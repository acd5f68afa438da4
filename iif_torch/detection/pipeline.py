"""Eval-time image pipeline: port of the ``train=False`` branch of
``iif_tpu/detection/pipeline.py::DetectionPipeline.__call__``.

Keep-ratio resize to the test scale (never past the static canvas), then
pad onto a uint8 canvas with the rounded mean pixel, so the device-side
normalisation (``detector.normalize_if_uint8``) maps the pad to ~0.
Without cv2, the resize is PyTorch's bilinear (``align_corners=False``, no
antialias) on the target device, skipped when the size is unchanged.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
DEFAULT_SCALE = (1333, 800)


def keep_ratio_scale(h: int, w: int, scale: Tuple[int, int]) -> float:
    """mmdet ``rescale_size``: factor = min(max_long/long, max_short/short)."""
    max_long, max_short = max(scale), min(scale)
    return min(max_long / max(h, w), max_short / min(h, w))


class DetectionPipeline:
    def __init__(self, canvas: Tuple[int, int] = (800, 1344),
                 scales: Sequence[Tuple[int, int]] = (DEFAULT_SCALE,)):
        self.canvas = tuple(canvas)
        self.scales = list(scales)
        self._pad_pixel = np.round(IMAGENET_MEAN).astype(np.uint8)

    def __call__(self, image: np.ndarray, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
        """(H0, W0, 3) uint8 RGB -> {image (H, W, 3) uint8 canvas on
        ``device``, img_shape (2,), scale_factor ()}."""
        h0, w0 = image.shape[:2]
        ch, cw = self.canvas
        factor = keep_ratio_scale(h0, w0, self.scales[0])
        factor = min(factor, ch / h0, cw / w0)
        nh, nw = int(h0 * factor + 0.5), int(w0 * factor + 0.5)
        img = torch.from_numpy(np.ascontiguousarray(image)).to(device)
        if (nh, nw) != (h0, w0):
            x = img.permute(2, 0, 1)[None].float()
            x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                              align_corners=False, antialias=False)
            img = x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
        out = torch.empty((ch, cw, 3), dtype=torch.uint8, device=device)
        out[:] = torch.from_numpy(self._pad_pixel).to(device)
        out[:nh, :nw] = img
        return {"image": out,
                "img_shape": np.array([nh, nw], np.int32),
                "scale_factor": np.float32(factor)}
