"""Per-family inference dispatch: port of ``iif_tpu/detection/
simple_test.py::make_simple_test`` for the four ported families."""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import torch

from iif_torch.detection.c4 import C4FasterRCNN, c4_simple_test
from iif_torch.detection.cascade import CascadeMaskRCNN, cascade_simple_test
from iif_torch.detection.detector import MaskRCNN, maskrcnn_simple_test
from iif_torch.detection.htc import HTC, htc_simple_test


def make_simple_test(model, loss_cls, test_cfg
                     ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """``fn(images)`` running the family's simple_test and returning the
    fixed-shape detection dict (boxes/scores/labels/valid [+masks]).
    Families other than ``MaskRCNN``, ``CascadeMaskRCNN`` and ``HTC``
    (every stage with ``loss_cls``, ``simple_test.py:75-83``; HTC before
    its cascade base) and ``C4FasterRCNN`` raise."""
    if isinstance(model, HTC):
        fn = htc_simple_test
    elif isinstance(model, CascadeMaskRCNN):
        fn = cascade_simple_test
    elif isinstance(model, C4FasterRCNN):
        fn = c4_simple_test
    elif isinstance(model, MaskRCNN):
        fn = maskrcnn_simple_test
    else:
        raise NotImplementedError(
            f"no ported simple_test for {type(model).__name__}")
    return partial(fn, model, loss_cls=loss_cls, cfg=test_cfg)
