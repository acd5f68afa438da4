"""Multi-level grid anchors (numpy), the port's copy of
``iif_tpu/ops/anchors.py::AnchorGenerator`` as the RPN uses it: scales x
ratios per stride, centred on each cell's corner (mmdet
``anchor_generator.py`` with ``center_offset=0``), and the flags of the
anchors whose centre lies inside the padded image."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class AnchorGenerator:
    def __init__(self, strides: Sequence[int],
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 scales: Sequence[float] = (8.0,)):
        self.strides = list(strides)
        ratios = np.asarray(ratios, np.float32)
        scales = np.asarray(scales, np.float32)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        self.base_anchors = []
        for stride in self.strides:
            size = float(stride)
            ws = (size * w_ratios[:, None] * scales[None, :]).reshape(-1)
            hs = (size * h_ratios[:, None] * scales[None, :]).reshape(-1)
            self.base_anchors.append(
                np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], -1))

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        """Per-level (H*W*A, 4) anchor arrays for the given feature sizes."""
        out = []
        for stride, base, (fh, fw) in zip(self.strides, self.base_anchors,
                                          featmap_sizes):
            shift_x = np.arange(fw, dtype=np.float32) * stride
            shift_y = np.arange(fh, dtype=np.float32) * stride
            xx, yy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([xx.ravel(), yy.ravel(),
                               xx.ravel(), yy.ravel()], axis=-1)
            anchors = (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
            out.append(anchors.astype(np.float32))
        return out

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def valid_flags(self, featmap_sizes: Sequence[Tuple[int, int]],
                    pad_shape: Tuple[int, int]) -> List[np.ndarray]:
        """Per-level (H*W*A,) bool: the anchor's cell corner lies inside
        the padded image."""
        out = []
        for stride, n, (fh, fw) in zip(self.strides, self.num_base_anchors,
                                       featmap_sizes):
            vx = np.arange(fw) * stride < pad_shape[1]
            vy = np.arange(fh) * stride < pad_shape[0]
            vv = (vy[:, None] & vx[None, :]).ravel()
            out.append(np.repeat(vv, n))
        return out
