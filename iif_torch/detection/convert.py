"""Weights carried across from the JAX package: ``maskrcnn_state_from_jax``
and ``c4_state_from_jax`` turn an ``iif_tpu`` MaskRCNN or C4FasterRCNN
(params, batch_stats) pytree of numpy arrays into this port's mmdet-named
state_dict.

It is the inverse of ``iif_tpu.detection.pretrained_det.
convert_mmdet_maskrcnn``: HWIO -> OIHW convolutions, Dense (in, out) ->
Linear (out, in), BN scale/bias/mean/var -> weight/bias/running_mean/
running_var, the HWC -> CHW permutation of the first shared FC undone, and
the flip + transpose of the mask head's transposed conv undone. Every one
of these maps is linear, so a gradient pytree of the params converts the
same way (pass zero ``batch_stats``): the training tests compare JAX's
gradients with the port's under torch names through it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _conv(v) -> torch.Tensor:
    return _t(np.asarray(v).transpose(3, 2, 0, 1))          # HWIO -> OIHW


def _fc(v) -> torch.Tensor:
    return _t(np.asarray(v).T)                               # (in,out)->(out,in)


def _fc_first_shared(v, ch: int = 256, side: int = 7) -> torch.Tensor:
    """(side*side*ch, out) flattened HWC -> (out, ch*side*side) CHW."""
    v = np.asarray(v).T
    out = v.shape[0]
    return _t(v.reshape(out, side, side, ch).transpose(0, 3, 1, 2)
              .reshape(out, ch * side * side))


def _deconv(v) -> torch.Tensor:
    """Flipped HWIO flax transposed-conv kernel -> torch (in, out, kh, kw)."""
    return _t(np.asarray(v)[::-1, ::-1].transpose(2, 3, 0, 1))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, p, s) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(s["mean"])
    sd[prefix + ".running_var"] = _t(s["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _leaf(sd, prefix, p, weight_fn) -> None:
    sd[prefix + ".weight"] = weight_fn(p["kernel"])
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _resnet(sd, prefix: str, params, stats) -> None:
    """A flax ResNet's or ResLayer's stem and ``layer{s}_{i}`` blocks ->
    mmdet's ``{prefix}.conv1``, ``{prefix}.layer{s}.{i}.*``."""
    for name, p in params.items():
        if name == "conv1":
            _leaf(sd, f"{prefix}.conv1", p, _conv)
        elif name == "bn1":
            _bn(sd, f"{prefix}.bn1", p, stats["bn1"])
        else:                                   # layer{s}_{i}
            stage, block = name[len("layer"):].split("_")
            base = f"{prefix}.layer{stage}.{block}"
            for mod, q in p.items():
                if mod == "downsample_conv":
                    _leaf(sd, base + ".downsample.0", q, _conv)
                elif mod == "downsample_bn":
                    _bn(sd, base + ".downsample.1", q, stats[name][mod])
                elif mod.startswith("conv"):
                    _leaf(sd, f"{base}.{mod}", q, _conv)
                else:
                    _bn(sd, f"{base}.{mod}", q, stats[name][mod])


def maskrcnn_state_from_jax(params: Dict[str, Any],
                            batch_stats: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """``iif_tpu`` MaskRCNN variables -> mmdet-named state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, "backbone", params["backbone"], batch_stats["backbone"])
    for name, p in params["neck"].items():
        i = name.rsplit("_", 1)[-1]
        kind = "lateral_convs" if name.startswith("lateral") else "fpn_convs"
        _leaf(sd, f"neck.{kind}.{i}.conv", p, _conv)
    for name, p in params["rpn_head"].items():
        _leaf(sd, f"rpn_head.{name}", p, _conv)
    for name, p in params["bbox_head"].items():
        if name == "shared_fc1":
            _leaf(sd, "roi_head.bbox_head.shared_fcs.0", p, _fc_first_shared)
        elif name == "shared_fc2":
            _leaf(sd, "roi_head.bbox_head.shared_fcs.1", p, _fc)
        else:
            _leaf(sd, f"roi_head.bbox_head.{name}", p, _fc)
    for name, p in params.get("mask_head", {}).items():
        if name == "upsample":
            _leaf(sd, "roi_head.mask_head.upsample", p, _deconv)
        elif name == "conv_logits":
            _leaf(sd, "roi_head.mask_head.conv_logits", p, _conv)
        else:                                   # conv{i}
            _leaf(sd, f"roi_head.mask_head.convs.{name[4:]}.conv", p, _conv)
    return sd


def c4_state_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """``iif_tpu`` C4FasterRCNN variables -> mmdet-named state_dict
    (``backbone.*``, ``rpn_head.*``, ``roi_head.shared_head.layer4.*``,
    ``roi_head.bbox_head.fc_cls|fc_reg``). The JAX package has no mmdet
    C4 converter, so this is the one direction."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, "backbone", params["backbone"], batch_stats["backbone"])
    for name, p in params["rpn_head"].items():
        _leaf(sd, f"rpn_head.{name}", p, _conv)
    _resnet(sd, "roi_head.shared_head", params["shared_head"],
            batch_stats["shared_head"])
    for name, p in params["bbox_head"].items():
        _leaf(sd, f"roi_head.bbox_head.{name}", p, _fc)
    return sd
