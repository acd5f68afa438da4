"""Checkpoints: the port's counterpart of ``iif_tpu/utils/checkpoint.py``
(orbax there), as mmdet's runner writes them, so that
``iif_torch/detection/inference.py::load_checkpoint`` serves them:
``<work_dir>/checkpoints/epoch_{n}.pth`` holding ``{"meta": {epoch, iter,
config}, "state_dict": <the model's mmdet names>, "optimizer": ...,
"scheduler": ...}``, and ``latest.pth`` beside it, a link to the newest
(as mmcv's). A state with FASA adds ``"fasa"``, one ``{field: tensor}``
a stage, which ``restore`` puts back and serving ignores. A state with
Seesaw's counts keeps them in the ``state_dict`` under mmdet's buffer
name, ``roi_head.bbox_head.loss_cls.cum_samples`` (``SEESAW_CUM_KEY``):
``restore`` puts them back, the weight loaders leave them out. The
format differs from the JAX package's (orbax needs JAX to be read)."""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

from iif_torch.detection.fasa import fasa_from_state_dict, fasa_state_dict
from iif_torch.detection.losses_extra import SEESAW_CUM_KEY

_EPOCH = re.compile(r"epoch_(\d+)\.pth$")


def save_checkpoint(work_dir: str, epoch: int, model: torch.nn.Module,
                    state, config: str = "",
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``epoch_{epoch}.pth`` (``epoch`` counts finished epochs) and
    point ``latest.pth`` at it; ``state`` is the trainer's state (a step,
    an optimizer, a scheduler); ``meta`` adds entries to the checkpoint's
    ``meta`` (the classification CLI's args). Returns the path."""
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pth")
    ckpt = {"meta": {"epoch": epoch, "iter": state.step,
                     "config": config, **(meta or {})},
            "state_dict": dict(model.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict()}
    if getattr(state, "fasa", None) is not None:
        ckpt["fasa"] = fasa_state_dict(state.fasa)
    if getattr(state, "seesaw_cum", None) is not None:
        ckpt["state_dict"][SEESAW_CUM_KEY] = state.seesaw_cum
    torch.save(ckpt, path)
    latest = os.path.join(ckpt_dir, "latest.pth")
    if os.path.lexists(latest):
        os.remove(latest)
    os.symlink(os.path.basename(path), latest)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest ``n`` of an ``epoch_{n}.pth`` in ``ckpt_dir``, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(ckpt_dir)
              if (m := _EPOCH.match(f))]
    return max(epochs) if epochs else None


def _read(path: str, mmap: bool = False) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap)


def read_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's ``meta`` (its tensors mapped, not read)."""
    return _read(path, mmap=True)["meta"]


def restore(path: str, model: torch.nn.Module, state) -> int:
    """Resume: the model's weights, the optimizer's momentum buffers and
    learning rate, the scheduler's position, ``state.step`` and FASA's
    state and Seesaw's counts (on the model's device) from ``path``, in
    place. Returns the epochs it had finished."""
    ckpt = _read(path)
    weights = dict(ckpt["state_dict"])
    cum = weights.pop(SEESAW_CUM_KEY, None)
    model.load_state_dict(weights)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["meta"]["iter"])
    if "fasa" in ckpt:
        state.fasa = fasa_from_state_dict(
            ckpt["fasa"], next(model.parameters()).device)
    if cum is not None:
        state.seesaw_cum = cum.to(next(model.parameters()).device)
    return int(ckpt["meta"]["epoch"])


def load_weights(path: str, model: torch.nn.Module) -> None:
    """``--load-from``: weights only, by name, from a checkpoint of this
    module or a plain state_dict (``module.`` prefixes and Seesaw's
    counts dropped)."""
    ckpt = _read(path)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    model.load_state_dict({k.replace("module.", ""): v
                           for k, v in ckpt.items() if k != SEESAW_CUM_KEY})
