"""iif_torch — the PyTorch/CUDA port of iif_tpu for NVIDIA Hopper.

Mirrors the ``iif_tpu`` module layout. Plain tensor code is PyTorch; every
Pallas TPU kernel of the ported path is a CUDA kernel written by hand
under ``iif_torch/csrc`` and built at first use (``iif_torch.ops.build``).
Entry points take ``device`` (default ``"cuda"``) and raise when CUDA is
missing unless given ``device="cpu"``.
"""
from iif_torch.device import resolve_device

__all__ = ["resolve_device"]
