"""Augmentations on the device: port of ``iif_tpu/data/augment.py``.

Batches are (B, H, W, C) float tensors on the device, [0, 1] after
``to_float``. Each random op is a draw (``draw_*``: from a
``torch.Generator`` on the batch's device, no host sync) and an apply
that takes the draw, so that a caller (a test) can hand in JAX's draws.

``random_resized_crop`` resamples as ``jax.image.scale_and_translate(...,
method="bilinear")`` does, with its antialiasing when it downsamples: the
same separable weight matrices (``jax/_src/image/scale.py::
compute_weight_mat``), not ``F.interpolate``. ``color_jitter`` runs
brightness, contrast (against the mean grey of the whole image),
saturation, then the YIQ hue rotation, and clips only at the end.

``cutout`` and ``random_erasing`` follow JAX's (a clipped square of side
``length`` about a uniform pixel; torchvision's RandomErasing with its
area, log-ratio and truncations, normal noise in the images' dtype). The
pipelines take ``--auto-augment`` as JAX's CLI does: on CIFAR ``cifar``
adds the CIFAR-10 policy and cutout 16 after crop and flip, ``oneof``
replaces crop and flip by the ten-branch pipeline
(``iif_torch/data/branch_augment.py``); on ImageNet ``imagenet``,
``randaugment`` and ``oneof`` replace ColorJitter
(``iif_torch/data/autoaugment.py``); any other value leaves the plain
pipeline, as JAX does. Random erasing comes after normalisation. The
draw's keys say which ops the apply runs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from iif_torch.data import autoaugment as policies

Draw = Dict[str, object]


def to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> f32 [0, 1]."""
    return images.float() / 255.0


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


# ------------------------------------------------------------ flip, crop
def draw_hflip(generator: torch.Generator, b: int, device) -> torch.Tensor:
    return torch.rand(b, generator=generator, device=device) < 0.5


def random_hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    flip = flip.to(images.device).bool()
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def draw_crop(generator: torch.Generator, b: int, padding: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window origins (oy, ox), each in [0, 2 * padding]."""
    oy = torch.randint(0, 2 * padding + 1, (b,), generator=generator,
                       device=device)
    ox = torch.randint(0, 2 * padding + 1, (b,), generator=generator,
                       device=device)
    return oy, ox


def random_crop(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                padding: int = 4) -> torch.Tensor:
    """torch RandomCrop(H, padding): zero-pad, then the H x W window at
    (oy, ox)."""
    b, h, w, _ = images.shape
    padded = F.pad(images, (0, 0, padding, padding, padding, padding))
    dev = images.device
    rows = oy.to(dev).long()[:, None] + torch.arange(h, device=dev)
    cols = ox.to(dev).long()[:, None] + torch.arange(w, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    return padded[bi, rows[:, :, None], cols[:, None, :]]


# ---------------------------------------------------- cutout, erasing
def draw_cutout(generator: torch.Generator, b: int, h: int, w: int,
                device, n_holes: int = 1) -> Draw:
    """Each hole's centre: (n_holes, B) rows ``cy`` in [0, h) and
    columns ``cx`` in [0, w)."""
    cy, cx = [], []
    for _ in range(n_holes):
        cy.append(torch.randint(0, h, (b,), generator=generator,
                                device=device))
        cx.append(torch.randint(0, w, (b,), generator=generator,
                                device=device))
    return {"cy": torch.stack(cy), "cx": torch.stack(cx)}


def cutout(images: torch.Tensor, draw: Draw, length: int = 16,
           fill: float = 0.0) -> torch.Tensor:
    """Cutout: ``fill`` where both offsets from a hole's centre are at
    most ``length // 2`` (the square clipped by the image), hole by
    hole."""
    _, h, w, _ = images.shape
    dev = images.device
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    fill_t = torch.full((), fill, dtype=images.dtype, device=dev)
    out = images
    for cy, cx in zip(draw["cy"].to(dev), draw["cx"].to(dev)):
        mask = (((yy - cy[:, None, None]).abs() <= length // 2)
                & ((xx - cx[:, None, None]).abs() <= length // 2))
        out = torch.where(mask[..., None], fill_t, out)
    return out


def draw_random_erasing(generator: torch.Generator, shape, dtype, device,
                        prob: float = 0.5,
                        scale: Tuple[float, float] = (0.02, 0.33),
                        ratio: Tuple[float, float] = (0.3, 3.3)) -> Draw:
    """Per image: whether to erase (``prob``), the area's share of the
    image in ``scale``, the log of the aspect ratio, the two offsets'
    uniforms; and normal noise of ``shape`` in ``dtype``."""
    b = shape[0]
    return {
        "apply": torch.rand(b, generator=generator, device=device) < prob,
        "scale": _uniform(generator, (b,), scale[0], scale[1], device),
        "log_r": _uniform(generator, (b,), math.log(ratio[0]),
                          math.log(ratio[1]), device),
        "uy": torch.rand(b, generator=generator, device=device),
        "ux": torch.rand(b, generator=generator, device=device),
        "noise": torch.randn(shape, generator=generator, dtype=dtype,
                             device=device)}


def random_erasing(images: torch.Tensor, draw: Draw) -> torch.Tensor:
    """torchvision RandomErasing as JAX writes it: the rectangle of side
    ``sqrt(area * r)`` x ``sqrt(area / r)`` (truncated, clipped to [1,
    side]) at offsets ``(u * (side - extent))`` truncated, filled with the
    noise, on the images drawn to erase."""
    b, h, w, _ = images.shape
    dev = images.device
    d = {k: v.to(dev) for k, v in draw.items()}
    area = (h * w) * d["scale"].float()
    # f64 exp rounded to f32: the card and the CPU truncate the same sides
    r = torch.exp(d["log_r"].double()).float()
    eh = torch.clamp(torch.sqrt(area * r).to(torch.int32), 1, h)
    ew = torch.clamp(torch.sqrt(area / r).to(torch.int32), 1, w)
    cy = (d["uy"].float() * (h - eh).float()).to(torch.int32)
    cx = (d["ux"].float() * (w - ew).float()).to(torch.int32)
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    inside = ((yy >= cy[:, None, None]) & (yy < (cy + eh)[:, None, None])
              & (xx >= cx[:, None, None]) & (xx < (cx + ew)[:, None, None]))
    inside = inside & d["apply"].bool()[:, None, None]
    return torch.where(inside[..., None], d["noise"].to(images.dtype),
                       images)


# ------------------------------------------------------ resized crop
def draw_resized_crop(generator: torch.Generator, b: int, h: int, w: int,
                      device, scale: Tuple[float, float] = (0.08, 1.0),
                      ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                      ) -> Draw:
    """The box (y0, x0, ch, cw) a image: area in ``scale`` of the image,
    log-uniform aspect in ``ratio``, clamped to [8, side] (no rejection
    loop, as in JAX)."""
    area = h * w * _uniform(generator, (b,), scale[0], scale[1], device)
    log_r = _uniform(generator, (b,), math.log(ratio[0]),
                     math.log(ratio[1]), device)
    r = torch.exp(log_r)
    cw = torch.clamp(torch.sqrt(area * r), 8.0, float(w))
    ch = torch.clamp(torch.sqrt(area / r), 8.0, float(h))
    y0 = torch.rand(b, generator=generator, device=device) * (h - ch)
    x0 = torch.rand(b, generator=generator, device=device) * (w - cw)
    return {"y0": y0, "x0": x0, "ch": ch, "cw": cw}


def scale_weights(input_size: int, output_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """(B, input_size, output_size) bilinear weights of
    ``scale_and_translate`` with antialiasing, one matrix a (scale,
    translation) pair: ``compute_weight_mat``'s op order in f32."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32,
                              device=dev) + 0.5) * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)
    x = torch.abs(sample_f - torch.arange(
        input_size, dtype=torch.float32, device=dev)[:, None]) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def random_resized_crop(images: torch.Tensor, draw: Draw,
                        size: int = 224) -> torch.Tensor:
    """The box of ``draw`` resampled to ``size`` x ``size``: per image
    scale (size / ch, size / cw) and translation (-y0 sy, -x0 sx), as
    ``jax.image.scale_and_translate``, then the two contractions as
    batched matmuls in f32."""
    b, h, w, c = images.shape
    d = {k: v.to(images.device).float() for k, v in draw.items()}
    sy, sx = size / d["ch"], size / d["cw"]
    wy = scale_weights(h, size, sy, -d["y0"] * sy)       # (B, h, size)
    wx = scale_weights(w, size, sx, -d["x0"] * sx)       # (B, w, size)
    rows = torch.bmm(wy.transpose(1, 2), images.reshape(b, h, w * c))
    rows = rows.reshape(b, size, w, c).permute(0, 1, 3, 2)
    out = torch.bmm(rows.reshape(b, size * c, w), wx)     # (B, size*c, size)
    return out.reshape(b, size, c, size).permute(0, 1, 3, 2).contiguous()


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    _, h, w, _ = images.shape
    y0, x0 = (h - size) // 2, (w - size) // 2
    return images[:, y0:y0 + size, x0:x0 + size, :]


# -------------------------------------------------------------- jitter
def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    wts = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * wts).sum(-1, keepdim=True)


_YIQ_FROM_RGB = [[0.299, 0.587, 0.114],
                 [0.596, -0.274, -0.322],
                 [0.211, -0.523, 0.312]]


def draw_color_jitter(generator: torch.Generator, b: int, device,
                      brightness: float = 0.4, contrast: float = 0.4,
                      saturation: float = 0.4, hue: float = 0.0) -> Draw:
    """Per-image factors ~ U[max(0, 1 - v), 1 + v] and the hue angle
    ~ U[-hue, hue] (turns), each only where its strength is > 0."""
    out: Draw = {}
    for name, v in (("brightness", brightness), ("contrast", contrast),
                    ("saturation", saturation)):
        if v > 0:
            out[name] = _uniform(generator, (b, 1, 1, 1), max(0.0, 1 - v),
                                 1 + v, device)
    if hue > 0:
        out["hue"] = _uniform(generator, (b, 1, 1), -hue, hue, device)
    return out


def color_jitter(images: torch.Tensor, draw: Draw) -> torch.Tensor:
    out = images
    if "brightness" in draw:
        out = out * draw["brightness"].to(out)
    if "contrast" in draw:
        mean = _rgb_to_gray(out).mean(dim=(1, 2), keepdim=True)
        out = mean + (out - mean) * draw["contrast"].to(out)
    if "saturation" in draw:
        gray = _rgb_to_gray(out)
        out = gray + (out - gray) * draw["saturation"].to(out)
    if "hue" in draw:
        theta = draw["hue"].to(out) * 2.0 * math.pi
        yiq_from_rgb = torch.tensor(_YIQ_FROM_RGB, dtype=out.dtype,
                                    device=out.device)
        rgb_from_yiq = torch.linalg.inv(yiq_from_rgb)
        yiq = torch.einsum("bhwc,dc->bhwd", out, yiq_from_rgb)
        cos, sin = torch.cos(theta), torch.sin(theta)
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], cos * i - sin * q,
                           sin * i + cos * q], dim=-1)
        out = torch.einsum("bhwd,cd->bhwc", yiq, rgb_from_yiq)
    return torch.clamp(out, 0.0, 1.0)


# ------------------------------------------------------------ pipelines
def draw_cifar(generator: torch.Generator, b: int, device,
               auto_augment: Optional[str] = None,
               random_erase: float = 0.0, h: int = 32, w: int = 32,
               dtype=torch.float32) -> Draw:
    """The CIFAR pipeline's draws: crop and flip, with ``auto_augment``
    ``"cifar"`` the policy and cutout's hole, with ``"oneof"`` the
    ten-branch pipeline's instead; random erasing's when
    ``random_erase`` > 0."""
    out: Draw = {}
    if auto_augment == "oneof":
        from iif_torch.data.branch_augment import draw_one_of

        out["oneof"] = draw_one_of(generator, b, h, w, device)
    else:
        oy, ox = draw_crop(generator, b, 4, device)
        out.update(oy=oy, ox=ox, flip=draw_hflip(generator, b, device))
        if auto_augment == "cifar":
            out["policy"] = policies.draw_policy(
                generator, b, policies.CIFAR10_POLICY, device)
            out["cutout"] = draw_cutout(generator, b, h, w, device)
    if random_erase > 0:
        out["erase"] = draw_random_erasing(generator, (b, h, w, 3), dtype,
                                           device, random_erase)
    return out


def cifar_train_augment(images_u8: torch.Tensor, draw: Draw, mean,
                        std, cutout_len: int = 16) -> torch.Tensor:
    """RandomCrop(32, 4) + HFlip [+ CIFAR-10 policy + Cutout] + Normalize
    [+ RandomErasing]; with a ``"oneof"`` draw the ten-branch pipeline in
    place of crop and flip."""
    x = to_float(images_u8)
    if "oneof" in draw:
        from iif_torch.data.branch_augment import one_of_augment

        x = one_of_augment(x, draw["oneof"])
    else:
        x = random_crop(x, draw["oy"], draw["ox"], 4)
        x = random_hflip(x, draw["flip"])
        if "policy" in draw:
            x = policies.cifar10_policy_augment(x, draw["policy"])
            x = cutout(x, draw["cutout"], length=cutout_len)
    x = normalize(x, mean, std)
    if "erase" in draw:
        x = random_erasing(x, draw["erase"])
    return x


def cifar_eval_transform(images_u8: torch.Tensor, mean,
                         std) -> torch.Tensor:
    return normalize(to_float(images_u8), mean, std)


def draw_imagenet(generator: torch.Generator, b: int, h: int, w: int,
                  device, hue: float = 0.0,
                  auto_augment: Optional[str] = None,
                  random_erase: float = 0.0, size: int = 224,
                  dtype=torch.float32) -> Draw:
    """The ImageNet pipeline's draws: the resized crop and the flip, then
    ColorJitter's factors or, with ``auto_augment`` ``"imagenet"``,
    ``"randaugment"`` or ``"oneof"``, that policy's; random erasing's when
    ``random_erase`` > 0."""
    out: Draw = {"crop": draw_resized_crop(generator, b, h, w, device),
                 "flip": draw_hflip(generator, b, device)}
    if auto_augment == "randaugment":
        out["randaugment"] = policies.draw_randaugment(generator, b, device)
    elif auto_augment == "imagenet":
        out["policy"] = policies.draw_policy(
            generator, b, policies.IMAGENET_POLICY, device)
    elif auto_augment == "oneof":
        from iif_torch.data.branch_augment import draw_one_of

        out["oneof"] = draw_one_of(generator, b, size, size, device)
    else:
        out["jitter"] = draw_color_jitter(generator, b, device, 0.4, 0.4,
                                          0.4, hue)
    if random_erase > 0:
        out["erase"] = draw_random_erasing(generator, (b, size, size, 3),
                                           dtype, device, random_erase)
    return out


def imagenet_train_augment(images_u8: torch.Tensor, draw: Draw, mean, std,
                           size: int = 224) -> torch.Tensor:
    """RandomResizedCrop(size) + HFlip + ColorJitter(0.4, 0.4, 0.4, hue)
    (hue 0.25 for iNat18) or the drawn policy + Normalize [+
    RandomErasing]."""
    x = random_resized_crop(to_float(images_u8), draw["crop"], size)
    x = random_hflip(x, draw["flip"])
    if "randaugment" in draw:
        x = policies.randaugment(x, draw["randaugment"])
    elif "policy" in draw:
        x = policies.imagenet_policy_augment(x, draw["policy"])
    elif "oneof" in draw:
        from iif_torch.data.branch_augment import one_of_augment

        x = one_of_augment(x, draw["oneof"])
    else:
        x = color_jitter(x, draw["jitter"])
    x = normalize(x, mean, std)
    if "erase" in draw:
        x = random_erasing(x, draw["erase"])
    return x


def imagenet_eval_transform(images_u8: torch.Tensor, mean, std,
                            size: int = 224) -> torch.Tensor:
    """CenterCrop(size) (the images come at 256 on the short side) +
    Normalize."""
    x = to_float(images_u8)
    if x.shape[1] != size or x.shape[2] != size:
        x = center_crop(x, size)
    return normalize(x, mean, std)
