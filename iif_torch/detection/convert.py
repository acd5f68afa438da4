"""Weights carried across from the JAX package: ``maskrcnn_state_from_jax``,
``cascade_state_from_jax``, ``htc_state_from_jax`` and
``c4_state_from_jax`` turn an ``iif_tpu`` MaskRCNN, CascadeMaskRCNN, HTC
or C4FasterRCNN (params, batch_stats) pytree of numpy arrays into this
port's mmdet-named state_dict.

It is the inverse of ``iif_tpu.detection.pretrained_det.
convert_mmdet_maskrcnn``: HWIO -> OIHW convolutions, Dense (in, out) ->
Linear (out, in), BN scale/bias/mean/var -> weight/bias/running_mean/
running_var (a grouped kernel (kh, kw, in/G, out) to (out, in/G, kh, kw)
as any other), the HWC -> CHW permutation of the first shared FC undone, and
the flip + transpose of the mask head's transposed conv undone. The
normed predictors keep JAX's (in, out) kernels: ``NormedConv2d``'s as it
stands, ``NormedLinear``'s and ``IIFNormedLinear``'s less the 1 that
JAX's forward subtracts (its kernel is drawn from U(0, 2)); a classifier
of any width crosses as it is (Seesaw's C+2). Every map but that offset is linear, so a
gradient pytree of the params converts the same way with
``gradients=True`` (pass zero ``batch_stats``): the training tests
compare JAX's gradients with the port's under torch names through it.
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


def _trunk(sd, params, batch_stats) -> None:
    _resnet(sd, "backbone", params["backbone"], batch_stats["backbone"])
    for name, p in params["neck"].items():
        i = name.rsplit("_", 1)[-1]
        kind = "lateral_convs" if name.startswith("lateral") else "fpn_convs"
        _leaf(sd, f"neck.{kind}.{i}.conv", p, _conv)
    for name, p in params["rpn_head"].items():
        _leaf(sd, f"rpn_head.{name}", p, _conv)


def _bbox_head(sd, prefix: str, params, gradients: bool) -> None:
    for name, p in params.items():
        if name == "shared_fc1":
            _leaf(sd, prefix + ".shared_fcs.0", p, _fc_first_shared)
        elif name == "shared_fc2":
            _leaf(sd, prefix + ".shared_fcs.1", p, _fc)
        elif name == "fc_cls" and "bias" not in p:     # NormedLinear
            k = np.asarray(p["kernel"])
            sd[prefix + ".fc_cls.weight"] = _t(
                k if gradients else k - np.float32(1.0))
        else:
            _leaf(sd, f"{prefix}.{name}", p, _fc)


def _mask_head(sd, prefix: str, params) -> None:
    for name, p in params.items():
        if name == "upsample":
            _leaf(sd, prefix + ".upsample", p, _deconv)
        elif name == "conv_res":                # HTC's information flow
            _leaf(sd, prefix + ".conv_res.conv", p, _conv)
        elif name == "conv_logits":
            # NormedConv2d's (C_in, num_classes) kernel as it stands
            _leaf(sd, prefix + ".conv_logits", p,
                  _t if np.ndim(p["kernel"]) == 2 else _conv)
        else:                                   # conv{i}
            _leaf(sd, f"{prefix}.convs.{name[4:]}.conv", p, _conv)


def maskrcnn_state_from_jax(params: Dict[str, Any],
                            batch_stats: Dict[str, Any],
                            gradients: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """``iif_tpu`` MaskRCNN variables -> mmdet-named state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _trunk(sd, params, batch_stats)
    _bbox_head(sd, "roi_head.bbox_head", params["bbox_head"], gradients)
    _mask_head(sd, "roi_head.mask_head", params.get("mask_head", {}))
    return sd


def cascade_state_from_jax(params: Dict[str, Any],
                           batch_stats: Dict[str, Any],
                           gradients: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """``iif_tpu`` CascadeMaskRCNN variables (``bbox_head_{i}``,
    ``mask_head_{i}``) -> mmdet's cascade names (``roi_head.bbox_head.
    {i}.*``, ``roi_head.mask_head.{i}.*``). The JAX package has no mmdet
    cascade converter, so this is the one direction."""
    sd: Dict[str, torch.Tensor] = {}
    _trunk(sd, params, batch_stats)
    for name, p in params.items():
        kind, _, i = name.rpartition("_")
        if kind == "bbox_head":
            _bbox_head(sd, f"roi_head.bbox_head.{i}", p, gradients)
        elif kind == "mask_head":
            _mask_head(sd, f"roi_head.mask_head.{i}", p)
    return sd


def htc_state_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                       gradients: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """``iif_tpu`` HTC variables (``bbox_head_{i}``, ``htc_mask_head_{i}``)
    -> mmdet's HTC names (``roi_head.bbox_head.{i}.*``,
    ``roi_head.mask_head.{i}.*`` with ``conv_res.conv``). Stage 0's
    ``conv_res``, which JAX creates and never calls, is dropped: mmdet
    builds none. The one direction, as for the cascade."""
    stages = {}
    for name, p in params.items():
        kind, _, i = name.rpartition("_")
        if kind == "htc_mask_head":
            name = f"mask_head_{i}"
            if i == "0":
                p = {k: v for k, v in p.items() if k != "conv_res"}
        stages[name] = p
    return cascade_state_from_jax(stages, batch_stats, gradients)


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
