"""The port's device rule: entry points run on the card unless the caller
asks for the CPU. A missing card is an error, never a silent fallback.

On a CUDA device the float32 precision is full IEEE f32: cuDNN
convolutions and cuBLAS matmuls without TF32 (PyTorch's default lets
cuDNN take TF32's 10-bit mantissas). That is the precision the CPU parity
tests compare against and that ``chip_smoke.py`` measures under. Every
CLI, ``init_detector`` and both trainers resolve their device here.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present. A CUDA device gets full f32 precision."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        # the legacy flags, as chip_smoke.py sets them: mixing them with
        # the newer fp32_precision API warns or raises
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
