"""The ten-branch OneOf augmentation on the device: port of
``iif_tpu/data/branch_augment.py`` (``--auto-augment oneof``).

A uniform choice a batch among ten branch pipelines (linear contrast +
flip + hue, grayscale + flip + translate, motion blur + contrast + shear,
noise + brightness + shear, cutout + multiply + flip, brightness +
contrast + translate, cutout + noise + scale, coarse dropout + noise +
scale, and identity twice), each a short sequence of the primitives
below, with per-image magnitudes. Images are (B, H, W, C) floats in
[0, 1].

As in ``iif_torch/data/autoaugment.py`` the branch's index is drawn on
the host (``host_rng``, keyed by the step's (seed, step)) and only that
branch's per-image draws come from the device generator; every primitive
takes its draw, so that a test can hand in JAX's. ``coarse_dropout``
upsamples its grid as ``jax.image.resize(..., "nearest")`` does, with
half-pixel centres: ``F.interpolate(mode="nearest-exact")``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from iif_torch.data.augment import (
    Draw,
    color_jitter,
    cutout,
    draw_cutout,
    draw_hflip,
    random_hflip,
)
from iif_torch.data.autoaugment import (
    affine_warp,
    centered,
    host_rng,
    mats_from,
    to_gray,
)

N_BRANCHES = 10


def _u(generator, shape, lo, hi, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) \
        * (hi - lo) + lo


# ----------------------------------------------------------- primitives
def linear_contrast(x, a):
    return torch.clamp(0.5 + a.to(x) * (x - 0.5), 0.0, 1.0)


def add_hue(x, theta):
    """The hue rotation of ``color_jitter`` alone (``theta`` (B, 1, 1)
    in turns, JAX's ``WithHueAndSaturation`` stand-in)."""
    return color_jitter(x, {"hue": theta})


def grayscale_blend(x, a):
    return x + a.to(x) * (to_gray(x) - x)


def translate(x, ty, tx):
    """Per-image translation by (ty, tx) pixels, (B,) each."""
    return affine_warp(x, mats_from(1.0, 0.0, ty.to(x.device), 0.0, 1.0,
                                    tx.to(x.device)))


def shear_deg(x, deg, axis="x"):
    _, h, w, _ = x.shape
    th = deg.to(x.device).float() * float(np.float32(math.pi / 180.0))
    v = torch.tan(th.double()).float()    # f64, as the warps' rotations
    mats = (mats_from(1.0, 0.0, 0.0, v, 1.0, 0.0) if axis == "x"
            else mats_from(1.0, v, 0.0, 0.0, 1.0, 0.0))
    return affine_warp(x, centered(mats, h, w))


def scale_xy(x, sx, sy):
    _, h, w, _ = x.shape
    sx, sy = sx.to(x.device).float(), sy.to(x.device).float()
    return affine_warp(x, centered(mats_from(1.0 / sy, 0.0, 0.0, 0.0,
                                             1.0 / sx, 0.0), h, w))


def gaussian_noise(x, scale, noise):
    return torch.clamp(x + scale.to(x) * noise.to(x), 0.0, 1.0)


def motion_blur(x, horiz, k: int = 5):
    """A horizontal or a vertical box blur of length ``k`` per image,
    SAME zero padding."""
    c = x.shape[-1]
    tap = float(np.float32(1.0) / np.float32(k))
    nchw = x.permute(0, 3, 1, 2)
    kern_h = torch.zeros((c, 1, k, k), dtype=x.dtype, device=x.device)
    kern_h[:, :, k // 2, :] = tap
    kern_v = torch.zeros((c, 1, k, k), dtype=x.dtype, device=x.device)
    kern_v[:, :, :, k // 2] = tap
    blur_h = F.conv2d(nchw, kern_h, padding=k // 2, groups=c)
    blur_v = F.conv2d(nchw, kern_v, padding=k // 2, groups=c)
    out = torch.where(horiz.to(x.device).bool()[:, None, None, None],
                      blur_h, blur_v)
    return out.permute(0, 2, 3, 1)


def multiply_brightness(x, m, a):
    return torch.clamp(x * m.to(x) + a.to(x), 0.0, 1.0)


def coarse_dropout(x, p, grid_u):
    """Zero the cells of a coarse (B, H // 8, W // 8) grid whose uniform
    lies below the image's ``p``, upsampled with half-pixel centres."""
    _, h, w, _ = x.shape
    grid = (grid_u.to(x.device) < p.to(x.device)).to(x.dtype)
    mask = F.interpolate(grid[:, None], size=(h, w), mode="nearest-exact")
    return x * (1.0 - mask[:, 0, :, :, None])


# ------------------------------------------------------------- branches
def _draw_noise(g, shape, dev, max_scale=15.0 / 255.0):
    return {"scale": _u(g, (shape[0], 1, 1, 1), 0.0, max_scale, dev),
            "noise": torch.randn(shape, generator=g, device=dev)}


def _draw_multiply(g, b, dev, mul=(0.5, 1.5), add=(-30 / 255, 30 / 255)):
    return {"m": _u(g, (b, 1, 1, 1), *mul, dev),
            "a": _u(g, (b, 1, 1, 1), *add, dev)}


def _hole(h):
    return max(h // 10, 2)


def draw_branch(generator: torch.Generator, index: int, b: int, h: int,
                w: int, device) -> Draw:
    """The per-image draws of branch ``index``, primitive by primitive
    in the order it applies them."""
    g, dev, shape = generator, device, (b, h, w, 3)
    if index == 0:
        return {"contrast": _u(g, (b, 1, 1, 1), 0.75, 1.25, dev),
                "flip": draw_hflip(g, b, dev),
                "hue": _u(g, (b, 1, 1), -50.0 / 255.0, 50.0 / 255.0, dev)}
    if index == 1:
        return {"gray": _u(g, (b, 1, 1, 1), 0.1, 0.3, dev),
                "flip": draw_hflip(g, b, dev),
                "ty": _u(g, (b,), -0.15, 0.15, dev) * h,
                "tx": torch.zeros(b, device=dev)}
    if index == 2:
        return {"horiz": draw_hflip(g, b, dev),
                "contrast": _u(g, (b, 1, 1, 1), 0.6, 1.4, dev),
                "deg": _u(g, (b,), -10.0, 10.0, dev)}
    if index == 3:
        return {**_draw_noise(g, shape, dev), **_draw_multiply(g, b, dev),
                "deg": _u(g, (b,), -10.0, 10.0, dev)}
    if index == 4:
        return {"cutout": draw_cutout(g, b, h, w, dev, n_holes=2),
                **_draw_multiply(g, b, dev, (0.8, 1.2), (0.0, 0.0)),
                "flip": draw_hflip(g, b, dev)}
    if index == 5:
        return {**_draw_multiply(g, b, dev),
                "contrast": _u(g, (b, 1, 1, 1), 0.6, 1.4, dev),
                "ty": torch.zeros(b, device=dev),
                "tx": _u(g, (b,), -0.25, 0.25, dev) * w}
    if index == 6:
        return {"cutout": draw_cutout(g, b, h, w, dev, n_holes=3),
                **_draw_noise(g, shape, dev),
                "sx": _u(g, (b,), 0.9, 1.1, dev),
                "sy": _u(g, (b,), 0.9, 1.1, dev)}
    if index == 7:
        gh, gw = max(h // 8, 1), max(w // 8, 1)
        return {"p": _u(g, (b, 1, 1), 0.0, 0.05, dev),
                "grid": torch.rand((b, gh, gw), generator=g, device=dev),
                **_draw_noise(g, shape, dev),
                "sx": _u(g, (b,), 0.8, 1.2, dev),
                "sy": _u(g, (b,), 0.8, 1.2, dev)}
    if index in (8, 9):
        return {}
    raise IndexError(f"no branch {index}")


def apply_branch(x: torch.Tensor, index: int, d: Draw) -> torch.Tensor:
    """Branch ``index`` of ``_branches`` on its draws ``d``."""
    h = x.shape[1]
    if index == 0:
        return add_hue(random_hflip(linear_contrast(x, d["contrast"]),
                                    d["flip"]), d["hue"])
    if index == 1:
        return translate(random_hflip(grayscale_blend(x, d["gray"]),
                                      d["flip"]), d["ty"], d["tx"])
    if index == 2:
        return shear_deg(linear_contrast(motion_blur(x, d["horiz"]),
                                         d["contrast"]), d["deg"], "x")
    if index == 3:
        y = gaussian_noise(x, d["scale"], d["noise"])
        return shear_deg(multiply_brightness(y, d["m"], d["a"]), d["deg"],
                         "y")
    if index == 4:
        y = cutout(x, d["cutout"], length=_hole(h), fill=0.5)
        return random_hflip(multiply_brightness(y, d["m"], d["a"]),
                            d["flip"])
    if index == 5:
        y = linear_contrast(multiply_brightness(x, d["m"], d["a"]),
                            d["contrast"])
        return translate(y, d["ty"], d["tx"])
    if index == 6:
        y = cutout(x, d["cutout"], length=_hole(h), fill=0.5)
        return scale_xy(gaussian_noise(y, d["scale"], d["noise"]), d["sx"],
                        d["sy"])
    if index == 7:
        y = gaussian_noise(coarse_dropout(x, d["p"], d["grid"]),
                           d["scale"], d["noise"])
        return scale_xy(y, d["sx"], d["sy"])
    if index in (8, 9):
        return x
    raise IndexError(f"no branch {index}")


def draw_one_of(generator: torch.Generator, b: int, h: int, w: int,
                device, index: Optional[int] = None) -> Draw:
    """The batch's branch (``index``, from ``host_rng`` unless given) and
    its draws."""
    if index is None:
        index = int(host_rng(generator).randint(N_BRANCHES))
    return {"index": index,
            "draw": draw_branch(generator, index, b, h, w, device)}


def one_of_augment(images: torch.Tensor, draw: Draw) -> torch.Tensor:
    """The drawn branch on the batch."""
    return apply_branch(images, draw["index"], draw["draw"])
