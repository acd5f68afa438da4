"""AutoAugment / RandAugment policies on the device: port of
``iif_tpu/data/autoaugment.py`` (the 15 ops of ``_OPS`` at JAX's
magnitudes, ``CIFAR10_POLICY``, ``IMAGENET_POLICY``, ``_apply_policy``,
``randaugment``).

Images are (B, H, W, C) float tensors in [0, 1]. Each random choice is a
draw and an apply that takes it, as in ``iif_torch/data/augment.py``, so
that a test can hand in JAX's draws:

- an op is ``OPS[name](x, level, sign)``; ``sign`` is the per-image
  direction (B,) of +1 / -1 (``draw_signs``), read only by the signed
  ops (the warps and the enhancements);
- a policy draws one sub-policy a batch (JAX's ``lax.switch``) and, for
  each of its two ops, the per-image application (a Bernoulli of the op's
  probability) and the signs. The sub-policy's index is drawn on the host
  from ``host_rng``, keyed by the step's (seed, step), so that Python
  picks the branch without reading the device; the per-image draws come
  from the step's device generator.

The warps follow ``_affine_warp``: per-image inverse matrices, the source
point ``M @ [y, x, 1]`` in f32, bilinear as ``map_coordinates(order=1)``
(the four taps in its order), and the mid-grey 0.5 wherever the source
point lies outside ``[0, h-1] x [0, w-1]``. Cosines, sines and tangents
are taken in f64 of the f32 angle and rounded to f32, so that the card
and the CPU build the same matrices (their f32 transcendentals differ by
an ulp, which a warp of a noisy image turns into 1e-5). Equalize, posterize and
solarize keep JAX's integer semantics (``(x * 255)`` truncated); equalize
builds its per-(image, channel) histograms with one ``index_add_`` on the
device. Constants that divide are 0-dim tensors on the images' device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Draw = Dict[str, object]

_FILL = 0.5
_LEVELS = 10
GRAY = (0.299, 0.587, 0.114)


def host_rng(generator: torch.Generator) -> np.random.RandomState:
    """The host's stream of a step: a ``RandomState`` keyed by the
    generator's seed, which the trainer makes from (seed, step), and a
    stream number of its own (mixup's lambda is keyed by (seed, step)
    alone)."""
    s = generator.initial_seed()
    return np.random.RandomState([s >> 32, s & 0xFFFFFFFF, 1])


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor on ``like``'s device (no copy from the
    host: a fill)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def to_gray(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1): the three weighted channels summed in order."""
    return (x[..., 0:1] * GRAY[0] + x[..., 1:2] * GRAY[1]) \
        + x[..., 2:3] * GRAY[2]


# ------------------------------------------------------------ warping
def source_points(mats: torch.Tensor, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sy, sx), each (B, H * W): ``M @ [y, x, 1]`` for every output
    pixel, in f32, in the order ``m @ coords`` sums."""
    dev = mats.device
    m = mats.float()
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w).reshape(1, -1)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w).reshape(1, -1)
    sy = (m[:, 0, 0:1] * yy + m[:, 0, 1:2] * xx) + m[:, 0, 2:3]
    sx = (m[:, 1, 0:1] * yy + m[:, 1, 1:2] * xx) + m[:, 1, 2:3]
    return sy, sx


def near_boundary(mats: torch.Tensor, h: int, w: int,
                  tol: float = 1e-4) -> torch.Tensor:
    """(B, H, W): the output pixels whose source point lies within
    ``tol`` of an edge of ``[0, h-1] x [0, w-1]``, where a rounding can
    move it between the image and the grey fill."""
    sy, sx = source_points(mats, h, w)
    dy = torch.minimum(sy.abs(), (sy - (h - 1)).abs())
    dx = torch.minimum(sx.abs(), (sx - (w - 1)).abs())
    near = (dy < tol) & (sx >= -tol) & (sx <= w - 1 + tol)
    near |= (dx < tol) & (sy >= -tol) & (sy <= h - 1 + tol)
    return near.reshape(-1, h, w)


def affine_warp(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """out(y, x) = in(M @ [y, x, 1]) for per-image (B, 2, 3) inverse
    matrices; bilinear, mid-grey where the source point is outside."""
    b, h, w, c = images.shape
    sy, sx = source_points(mats.to(images.device), h, w)
    inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    # inside the image a tap outside it has weight 0, so clamped taps
    # give map_coordinates' constant mode there
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = (y0.long() + 1).clamp(0, h - 1)
    ix0 = x0.long().clamp(0, w - 1)
    ix1 = (x0.long() + 1).clamp(0, w - 1)
    flat = images.reshape(b, h * w, c)

    def tap(iy, ix):
        idx = (iy * w + ix)[..., None].expand(b, h * w, c)
        return torch.gather(flat, 1, idx)

    out = ((wy0 * wx0)[..., None] * tap(iy0, ix0)
           + (wy0 * wx1)[..., None] * tap(iy0, ix1)) \
        + (wy1 * wx0)[..., None] * tap(iy1, ix0) \
        + (wy1 * wx1)[..., None] * tap(iy1, ix1)
    out = torch.where(inside[..., None], out, _const(_FILL, out))
    return out.reshape(b, h, w, c).to(images.dtype)


def mats_from(a00, a01, a02, a10, a11, a12) -> torch.Tensor:
    """(B, 2, 3) from six entries: (B,) tensors, or Python numbers
    filled to their shape."""
    ref = next(v for v in (a00, a01, a02, a10, a11, a12)
               if isinstance(v, torch.Tensor))
    rows = [v.float() if isinstance(v, torch.Tensor) else torch.full(
        ref.shape, float(v), dtype=torch.float32, device=ref.device)
        for v in (a00, a01, a02, a10, a11, a12)]
    return torch.stack(rows, dim=1).reshape(-1, 2, 3)


def centered(mats: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The affine map conjugated by the translation to the image centre
    ((h - 1) / 2, (w - 1) / 2): t + c - A c."""
    cy, cx = float(np.float32((h - 1) / 2.0)), float(np.float32(
        (w - 1) / 2.0))
    a = mats[:, :, :2]
    t = (mats[:, :, 2] + torch.stack([_const(cy, mats),
                                      _const(cx, mats)])) \
        - (a[:, :, 0] * cy + a[:, :, 1] * cx)
    return torch.cat([a, t[:, :, None]], dim=-1)


# ---------------------------------------------------------------- ops
def warp_matrix(name: str, h: int, w: int, level: int,
                sign: torch.Tensor) -> torch.Tensor:
    """The (B, 2, 3) inverse matrices of the geometric op ``name``
    (shear 0.3, translate 150/331 of the side, rotate 30 degrees, each
    times level / 9 and the image's sign; shears and rotations about the
    centre)."""
    sign = sign.float()
    if name == "shearX":
        return centered(mats_from(1.0, 0.0, 0.0, 0.3 * level
                                  / (_LEVELS - 1) * sign, 1.0, 0.0), h, w)
    if name == "shearY":
        return centered(mats_from(1.0, 0.3 * level / (_LEVELS - 1) * sign,
                                  0.0, 0.0, 1.0, 0.0), h, w)
    if name == "translateX":
        v = 150.0 / 331.0 * w * level / (_LEVELS - 1) * sign
        return mats_from(1.0, 0.0, 0.0, 0.0, 1.0, v)
    if name == "translateY":
        v = 150.0 / 331.0 * h * level / (_LEVELS - 1) * sign
        return mats_from(1.0, 0.0, v, 0.0, 1.0, 0.0)
    if name == "rotate":
        deg = 30.0 * level / (_LEVELS - 1) * sign
        th = (deg * float(np.float32(math.pi / 180.0))).double()
        cos, sin = torch.cos(th).float(), torch.sin(th).float()
        return centered(mats_from(cos, -sin, 0.0, sin, cos, 0.0), h, w)
    raise KeyError(f"{name!r} is not a geometric op")


WARPS = ("shearX", "shearY", "translateX", "translateY", "rotate")


def _warp_op(name: str):
    def op(x, level, sign):
        return affine_warp(x, warp_matrix(name, x.shape[1], x.shape[2],
                                          level, sign.to(x.device)))
    op.__name__ = name
    return op


def _blend(a, b, factor):
    return torch.clamp(a + (b - a) * factor, 0.0, 1.0)


def _enh_factor(level, sign, x):
    f = 1.0 + 0.9 * level / (_LEVELS - 1) * sign.to(x.device).float()
    return f[:, None, None, None]


def color(x, level, sign):
    return _blend(to_gray(x).expand(x.shape), x, _enh_factor(level, sign, x))


def contrast(x, level, sign):
    mean = to_gray(x).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(mean.expand(x.shape), x, _enh_factor(level, sign, x))


def brightness(x, level, sign):
    return torch.clamp(x * _enh_factor(level, sign, x), 0.0, 1.0)


def _depthwise_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A (k, k) kernel over each channel of NHWC ``x``, SAME zero
    padding (odd k)."""
    c, k = x.shape[-1], kernel.shape[0]
    weight = kernel.to(x)[None, None].expand(c, 1, k, k)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=k // 2, groups=c)
    return out.permute(0, 2, 3, 1)


def sharpness(x, level, sign):
    side = float(np.float32(1.0) / np.float32(13.0))
    mid = float(np.float32(5.0) / np.float32(13.0))
    kernel = torch.full((3, 3), side, dtype=torch.float32, device=x.device)
    kernel[1, 1] = mid
    return _blend(_depthwise_same(x, kernel), x, _enh_factor(level, sign, x))


def autocontrast(x, level, sign):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo + 1e-12),
                        torch.ones_like(hi))
    off = torch.where(hi > lo, lo, torch.zeros_like(lo))
    return torch.clamp((x - off) * scale, 0.0, 1.0)


def _to_byte_grid(x):
    """(x * 255) truncated, as JAX's ``astype(int32)``, clipped to
    [0, 255]."""
    return torch.clamp((x * 255.0).to(torch.int32), 0, 255)


def equalize(x, level, sign):
    """Per-channel histogram equalization with PIL's LUT: step = (sum -
    hist[255]) / 255, lut = (cdf - hist) / step + 0.5 truncated, the
    identity where step is 0."""
    b, h, w, c = x.shape
    xi = _to_byte_grid(x)                                   # (B, H, W, C)
    plane = (torch.arange(b, device=x.device)[:, None] * c
             + torch.arange(c, device=x.device)[None, :]) * 256
    idx = (xi.long() + plane[:, None, None, :]).reshape(-1)
    hist = torch.zeros(b * c * 256, dtype=torch.float32, device=x.device)
    hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    hist = hist.reshape(b, c, 256)
    step = (hist.sum(-1, keepdim=True) - hist[..., 255:]) \
        / _const(255.0, hist)
    cdf = torch.cumsum(hist, -1)
    lut = torch.clamp(((cdf - hist) / torch.clamp_min(step, 1e-8)
                       + 0.5).to(torch.int32), 0, 255)
    lut = torch.where(step > 0, lut, torch.arange(
        256, dtype=torch.int32, device=x.device))
    out = torch.gather(lut.reshape(b * c, 256), 1,
                       xi.permute(0, 3, 1, 2).reshape(b * c, -1).long())
    out = out.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return out.to(x.dtype) / _const(255.0, x)


def invert(x, level, sign):
    return 1.0 - x


def posterize(x, level, sign):
    bits = int(round(8 - 4 * level / (_LEVELS - 1)))
    shift = 8 - bits
    xi = (x * 255.0).to(torch.uint8)
    xi = torch.bitwise_left_shift(torch.bitwise_right_shift(xi, shift),
                                  shift)
    return xi.to(x.dtype) / _const(255.0, x)


def solarize(x, level, sign):
    thresh = float(np.float32((256.0 - 256.0 * level / (_LEVELS - 1))
                              / 255.0))
    return torch.where(x >= thresh, 1.0 - x, x)


def identity_op(x, level, sign):
    return x


OPS = {
    **{name: _warp_op(name) for name in WARPS}, "color": color,
    "posterize": posterize, "solarize": solarize, "contrast": contrast,
    "sharpness": sharpness, "brightness": brightness,
    "autocontrast": autocontrast, "equalize": equalize, "invert": invert,
    "identity": identity_op,
}

# AutoAugment CIFAR-10 policy (25 sub-policies of 2 (op, prob, level)).
CIFAR10_POLICY: List[Tuple] = [
    (("invert", 0.1, 7), ("contrast", 0.2, 6)),
    (("rotate", 0.7, 2), ("translateX", 0.3, 9)),
    (("sharpness", 0.8, 1), ("sharpness", 0.9, 3)),
    (("shearY", 0.5, 8), ("translateY", 0.7, 9)),
    (("autocontrast", 0.5, 8), ("equalize", 0.9, 2)),
    (("shearY", 0.2, 7), ("posterize", 0.3, 7)),
    (("color", 0.4, 3), ("brightness", 0.6, 7)),
    (("sharpness", 0.3, 9), ("brightness", 0.7, 9)),
    (("equalize", 0.6, 5), ("equalize", 0.5, 1)),
    (("contrast", 0.6, 7), ("sharpness", 0.6, 5)),
    (("color", 0.7, 7), ("translateX", 0.5, 8)),
    (("equalize", 0.3, 7), ("autocontrast", 0.4, 8)),
    (("translateY", 0.4, 3), ("sharpness", 0.2, 6)),
    (("brightness", 0.9, 6), ("color", 0.2, 8)),
    (("solarize", 0.5, 2), ("invert", 0.0, 3)),
    (("equalize", 0.2, 0), ("autocontrast", 0.6, 0)),
    (("equalize", 0.2, 8), ("equalize", 0.6, 4)),
    (("color", 0.9, 9), ("equalize", 0.6, 6)),
    (("autocontrast", 0.8, 4), ("solarize", 0.2, 8)),
    (("brightness", 0.1, 3), ("color", 0.7, 0)),
    (("solarize", 0.4, 5), ("autocontrast", 0.9, 3)),
    (("translateY", 0.9, 9), ("translateY", 0.7, 9)),
    (("autocontrast", 0.9, 2), ("solarize", 0.8, 3)),
    (("equalize", 0.8, 8), ("invert", 0.1, 3)),
    (("translateY", 0.7, 9), ("autocontrast", 0.9, 1)),
]

# AutoAugment ImageNet policy.
IMAGENET_POLICY: List[Tuple] = [
    (("posterize", 0.4, 8), ("rotate", 0.6, 9)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
    (("posterize", 0.6, 7), ("posterize", 0.6, 6)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("equalize", 0.4, 4), ("rotate", 0.8, 8)),
    (("solarize", 0.6, 3), ("equalize", 0.6, 7)),
    (("posterize", 0.8, 5), ("equalize", 1.0, 2)),
    (("rotate", 0.2, 3), ("solarize", 0.6, 8)),
    (("equalize", 0.6, 8), ("posterize", 0.4, 6)),
    (("rotate", 0.8, 8), ("color", 0.4, 0)),
    (("rotate", 0.4, 9), ("equalize", 0.6, 2)),
    (("equalize", 0.0, 7), ("equalize", 0.8, 8)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("rotate", 0.8, 8), ("color", 1.0, 2)),
    (("color", 0.8, 8), ("solarize", 0.8, 7)),
    (("sharpness", 0.4, 7), ("invert", 0.6, 8)),
    (("shearX", 0.6, 5), ("equalize", 1.0, 9)),
    (("color", 0.4, 0), ("equalize", 0.6, 3)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
]

POLICIES = {"cifar": CIFAR10_POLICY, "imagenet": IMAGENET_POLICY}

RANDAUG_OPS = ["identity", "autocontrast", "equalize", "rotate", "solarize",
               "color", "posterize", "contrast", "brightness", "sharpness",
               "shearX", "shearY", "translateX", "translateY"]


# -------------------------------------------------------------- draws
def draw_signs(generator: torch.Generator, b: int, device) -> torch.Tensor:
    """(B,) +1 / -1, each with probability 1/2 (JAX's ``_signs``)."""
    heads = torch.rand(b, generator=generator, device=device) < 0.5
    return torch.where(heads, 1.0, -1.0)


def draw_policy(generator: torch.Generator, b: int,
                policy: Sequence[Tuple], device,
                index: Optional[int] = None) -> Draw:
    """The batch's sub-policy (``index``, from ``host_rng`` unless given)
    and, for each of its ops, the per-image application and signs."""
    if index is None:
        index = int(host_rng(generator).randint(len(policy)))
    ops = []
    for _name, prob, _level in policy[index]:
        ops.append({
            "apply": torch.rand(b, generator=generator, device=device)
            < prob,
            "sign": draw_signs(generator, b, device)})
    return {"index": index, "ops": ops}


def apply_policy(images: torch.Tensor, draw: Draw,
                 policy: Sequence[Tuple]) -> torch.Tensor:
    """The drawn sub-policy: each op applied to the images it drew."""
    x = images
    for (name, _prob, level), d in zip(policy[draw["index"]], draw["ops"]):
        applied = OPS[name](x, level, d["sign"])
        x = torch.where(d["apply"].to(x.device)[:, None, None, None],
                        applied, x)
    return x


def cifar10_policy_augment(images: torch.Tensor, draw: Draw
                           ) -> torch.Tensor:
    return apply_policy(images, draw, CIFAR10_POLICY)


def imagenet_policy_augment(images: torch.Tensor, draw: Draw
                            ) -> torch.Tensor:
    return apply_policy(images, draw, IMAGENET_POLICY)


def draw_randaugment(generator: torch.Generator, b: int, device,
                     num_ops: int = 2,
                     indices: Optional[Sequence[int]] = None) -> Draw:
    """RandAugment's ``num_ops`` ops for the batch (indices into
    ``RANDAUG_OPS``, from ``host_rng`` unless given) and their signs."""
    if indices is None:
        rng = host_rng(generator)
        indices = [int(rng.randint(len(RANDAUG_OPS)))
                   for _ in range(num_ops)]
    return {"ops": [{"index": int(i), "sign": draw_signs(generator, b,
                                                         device)}
                    for i in indices]}


def randaugment(images: torch.Tensor, draw: Draw,
                magnitude: int = 9) -> torch.Tensor:
    """RandAugment(N=2, M=9): the drawn ops in turn at ``magnitude``."""
    x = images
    for d in draw["ops"]:
        x = OPS[RANDAUG_OPS[d["index"]]](x, magnitude, d["sign"])
    return x
