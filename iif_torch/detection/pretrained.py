"""Pretrained backbones: port of ``iif_tpu/models/pretrained.py::
load_torch_checkpoint`` (the ``model`` / ``state_dict`` / ``module.`` /
``prefix`` rules) and ``merge_pretrained``.

The port keeps torchvision's parameter names in its trunk, so a
torchvision ResNet ``.pth`` loads by name under ``backbone.``, its ``fc``
classifier dropped. Parameters the file lacks keep the fresh init's
draw; a name the model lacks raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def load_torch_checkpoint(path: str, prefix: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state_dict (or a trainer checkpoint's ``model`` /
    ``state_dict``), ``module.`` dropped; with ``prefix``, where any key
    has it, only those keys, the prefix stripped (mmdet's ``init_cfg=
    dict(type='Pretrained', prefix='backbone.')``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    ckpt = {k.replace("module.", ""): v for k, v in ckpt.items()}
    if prefix and any(k.startswith(prefix) for k in ckpt):
        ckpt = {k[len(prefix):]: v for k, v in ckpt.items()
                if k.startswith(prefix)}
    return ckpt


def load_pretrained_backbone(model: torch.nn.Module, path: str) -> None:
    """Overlay a torchvision-named ResNet checkpoint on ``model.backbone``
    (``pretrained_backbone``), in place; ``fc.*`` dropped."""
    weights = {k: v for k, v in
               load_torch_checkpoint(path, prefix="backbone.").items()
               if not k.startswith("fc.")}
    own = model.backbone.state_dict()
    unexpected = sorted(set(weights) - set(own))
    if unexpected:
        raise KeyError(f"{path}: {len(unexpected)} names the backbone "
                       f"lacks, among them {unexpected[:5]}")
    model.backbone.load_state_dict(weights, strict=False)
