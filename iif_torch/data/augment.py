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

Not ported: the policies (``--auto-augment`` cifar / imagenet /
randaugment / oneof), cutout and random erasing; the training CLI refuses
their flags.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Draw = Dict[str, torch.Tensor]


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
def draw_cifar(generator: torch.Generator, b: int, device) -> Draw:
    oy, ox = draw_crop(generator, b, 4, device)
    return {"oy": oy, "ox": ox, "flip": draw_hflip(generator, b, device)}


def cifar_train_augment(images_u8: torch.Tensor, draw: Draw, mean,
                        std) -> torch.Tensor:
    """RandomCrop(32, 4) + HFlip + Normalize."""
    x = random_crop(to_float(images_u8), draw["oy"], draw["ox"], 4)
    return normalize(random_hflip(x, draw["flip"]), mean, std)


def cifar_eval_transform(images_u8: torch.Tensor, mean,
                         std) -> torch.Tensor:
    return normalize(to_float(images_u8), mean, std)


def draw_imagenet(generator: torch.Generator, b: int, h: int, w: int,
                  device, hue: float = 0.0) -> Draw:
    return {"crop": draw_resized_crop(generator, b, h, w, device),
            "flip": draw_hflip(generator, b, device),
            "jitter": draw_color_jitter(generator, b, device, 0.4, 0.4,
                                        0.4, hue)}


def imagenet_train_augment(images_u8: torch.Tensor, draw: Draw, mean, std,
                           size: int = 224) -> torch.Tensor:
    """RandomResizedCrop(size) + HFlip + ColorJitter(0.4, 0.4, 0.4, hue)
    + Normalize (hue 0.25 for iNat18)."""
    x = random_resized_crop(to_float(images_u8), draw["crop"], size)
    x = color_jitter(random_hflip(x, draw["flip"]), draw["jitter"])
    return normalize(x, mean, std)


def imagenet_eval_transform(images_u8: torch.Tensor, mean, std,
                            size: int = 224) -> torch.Tensor:
    """CenterCrop(size) (the images come at 256 on the short side) +
    Normalize."""
    x = to_float(images_u8)
    if x.shape[1] != size or x.shape[2] != size:
        x = center_crop(x, size)
    return normalize(x, mean, std)
