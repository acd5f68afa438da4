"""Multi-level RoI feature extraction: port of
``iif_tpu/detection/roi_extractor.py`` (``map_roi_levels``,
``SingleRoIExtractor``).

The extractor has one route, the multi-level RoIAlign of
``iif_torch/ops/roi_align_ml.py``: on a CUDA tensor ``RoIAlignML`` (K1
forward, K2 backward; under ``inference_mode`` only K1 runs), on a CPU
tensor its plain version (the JAX package's ``_flat_gather``) under
autograd. The kernels serve 7x7 and 14x14 in f32 and bf16, so the TPU's
VMEM guards (``roi_extractor.py:77-83``) have no counterpart. The result
is in the feature dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from iif_torch.ops.roi_align_ml import map_roi_levels, roi_align_ml

__all__ = ["map_roi_levels", "SingleRoIExtractor"]


class SingleRoIExtractor:
    """Functional: call with the FPN features and padded rois."""

    def __init__(self, output_size: Tuple[int, int] = (7, 7),
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 sampling_ratio: int = 0, finest_scale: float = 56.0):
        self.output_size = tuple(output_size)
        self.featmap_strides = tuple(featmap_strides)
        self.sampling_ratio = sampling_ratio
        self.finest_scale = finest_scale

    @property
    def num_inputs(self) -> int:
        return len(self.featmap_strides)

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor
                 ) -> torch.Tensor:
        """feats: L x (B, H_l, W_l, C); rois (R, 5) = (batch_idx, x1..y2).
        Returns (R, oh, ow, C) in the feature dtype."""
        return roi_align_ml(feats[:self.num_inputs], rois, self.output_size,
                            self.featmap_strides, self.sampling_ratio,
                            self.finest_scale)
