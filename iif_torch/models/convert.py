"""JAX classifier variables -> the port's state_dict: the inverse of
``iif_tpu/models/pretrained.py::convert_torch_resnet`` extended to what
that converter does not map (the SE blocks, the normed and cosine
heads), beside ``iif_torch/detection/convert.py``. flax's ``layer{s}_{i}``
becomes ``layer{s}.{i}``, HWIO kernels OIHW, ``downsample_conv`` /
``downsample_bn`` ``downsample.0`` / ``.1``, dense kernels transposed,
``NormedLinear``'s kernel less 1 (flax subtracts 1 in its forward), and
the head ``head`` (``linear`` for ResNet-s, ``fc`` for the ImageNet
ResNets).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _bn(out: Dict[str, torch.Tensor], name: str, params: Mapping,
        stats: Mapping) -> None:
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _conv(v) -> torch.Tensor:
    return _t(np.asarray(v).transpose(3, 2, 0, 1))


def _head(out: Dict[str, torch.Tensor], head: str, params: Mapping) -> None:
    if "linear" in params:
        out[f"{head}.weight"] = _t(np.asarray(params["linear"]["kernel"]).T)
        out[f"{head}.bias"] = _t(params["linear"]["bias"])
    elif "NormedLinear_0" in params:
        out[f"{head}.weight"] = _t(params["NormedLinear_0"]["kernel"]) - 1.0
    elif "CosNormClassifier_0" in params:
        p = params["CosNormClassifier_0"]
        out[f"{head}.weight"] = _t(p["kernel"])
        if "scale" in p:
            out[f"{head}.scale"] = _t(p["scale"])
    else:
        raise KeyError(f"no classifier head among {sorted(params)}")


def classifier_state_from_jax(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any],
                              head: Optional[str] = None
                              ) -> Dict[str, torch.Tensor]:
    """The port's state_dict of the JAX classifier ``params`` /
    ``batch_stats`` (a ResNet-s or an ImageNet ResNet)."""
    if head is None:
        head = "fc" if any(k.startswith("layer4_") for k in params) \
            else "linear"
    out: Dict[str, torch.Tensor] = {"conv1.weight": _conv(
        params["conv1"]["kernel"])}
    _bn(out, "bn1", params["bn1"], batch_stats["bn1"])
    for key, blk in params.items():
        if not key.startswith("layer"):
            continue
        stage, idx = key[len("layer"):].split("_")
        base = f"layer{stage}.{idx}"
        stats = batch_stats[key]
        for mod, p in blk.items():
            if mod.startswith("conv"):
                out[f"{base}.{mod}.weight"] = _conv(p["kernel"])
            elif mod.startswith("bn"):
                _bn(out, f"{base}.{mod}", p, stats[mod])
            elif mod == "downsample_conv":
                out[f"{base}.downsample.0.weight"] = _conv(p["kernel"])
            elif mod == "downsample_bn":
                _bn(out, f"{base}.downsample.1", p, stats[mod])
            elif mod == "se":
                for fc in ("fc1", "fc2"):
                    out[f"{base}.se.{fc}.weight"] = _t(
                        np.asarray(p[fc]["kernel"]).T)
            else:
                raise KeyError(f"unknown module {key}/{mod}")
    _head(out, head, params)
    return out
