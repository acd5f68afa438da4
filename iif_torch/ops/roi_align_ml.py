"""Multi-level aligned RoIAlign forward: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``iif_tpu/ops/pallas/roi_align_kernel.py::roi_align_pallas_ml``
(the TPU kernel ``_make_ml_kernel`` / ``_pallas_ml_call``). The kernel,
``iif_torch/csrc/roi_align_ml.cu``, computes what
``SingleRoIExtractor._flat_gather`` computes
(``iif_tpu/detection/roi_extractor.py:97-166``): each RoI's FPN level from
``map_roi_levels``, box = roi / stride - 0.5, out x out bins of s x s
samples, each sample clamped into the map and read bilinearly with the
high corner clamped, the mean over samples.

What bounds it on an H100: HBM bytes, i.e. the feature bytes read plus the
(R, out, out, C) output written; it does a few FLOPs per byte. The design
reads each bilinear corner as one coalesced row of C channels (NHWC, two
channels a thread), keeps the per-sample geometry of a block in shared
memory, accumulates in f32 and writes the output once in the feature type.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple, Union

import torch

from iif_torch.ops import build

KERNEL = "roi_align_ml"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: float = 56.0) -> torch.Tensor:
    """(R, 5) rois -> (R,) int32 target FPN level
    (``roi_extractor.py:26-31``)."""
    scale = torch.sqrt((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2]))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int32)


def _pair(size: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(size, int):
        return size, size
    return int(size[0]), int(size[1])


def roi_align_ml_reference(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                           output_size=(7, 7),
                           strides: Sequence[int] = (4, 8, 16, 32),
                           sampling_ratio: int = 0,
                           finest_scale: float = 56.0) -> torch.Tensor:
    """Plain version: a transcription of ``_flat_gather``.

    feats: L x (B, H_l, W_l, C); rois (R, 5) = (batch_idx, x1, y1, x2, y2)
    in image pixels. Returns (R, oh, ow, C) float32 (features of a narrower
    type promote to f32, as in JAX)."""
    num_levels = len(strides)
    out_h, out_w = _pair(output_size)
    s = sampling_ratio if sampling_ratio > 0 else 2
    b, c = feats[0].shape[0], feats[0].shape[-1]
    r = rois.shape[0]
    dev = rois.device

    lv = map_roi_levels(rois, num_levels, finest_scale).long()
    heights = [f.shape[1] for f in feats[:num_levels]]
    widths = [f.shape[2] for f in feats[:num_levels]]
    offsets = [0]
    for h, w in zip(heights[:-1], widths[:-1]):
        offsets.append(offsets[-1] + h * w)
    tot = offsets[-1] + heights[-1] * widths[-1]
    flat = torch.cat([f.reshape(b, -1, c) for f in feats[:num_levels]], 1)

    h_l = torch.tensor(heights, dtype=torch.float32, device=dev)[lv]
    w_l = torch.tensor(widths, dtype=torch.float32, device=dev)[lv]
    off_l = torch.tensor(offsets, dtype=torch.int64, device=dev)[lv]
    stride_l = torch.tensor(strides, dtype=torch.float32, device=dev)[lv]
    w_int = torch.tensor(widths, dtype=torch.int64, device=dev)[lv]

    # Divisors are tensors on purpose: PyTorch's CUDA division by a Python
    # scalar multiplies by the reciprocal, which moves a sample by an ulp,
    # and at a coordinate of a few hundred cells that ulp shows in the
    # output. A tensor divisor keeps the rounding of a true division.
    def div(a, d):
        return a / torch.tensor(float(d), dtype=torch.float32, device=dev)

    scale = 1.0 / stride_l          # strides are powers of 2: exact
    x1 = rois[:, 1] * scale - 0.5
    y1 = rois[:, 2] * scale - 0.5
    x2 = rois[:, 3] * scale - 0.5
    y2 = rois[:, 4] * scale - 0.5
    bin_w = div(x2 - x1, out_w)
    bin_h = div(y2 - y1, out_h)

    iy = div(torch.arange(out_h * s, dtype=torch.float32, device=dev) + 0.5, s)
    ix = div(torch.arange(out_w * s, dtype=torch.float32, device=dev) + 0.5, s)
    ys = y1[:, None] + bin_h[:, None] * iy[None, :]          # (R, Ty)
    xs = x1[:, None] + bin_w[:, None] * ix[None, :]          # (R, Tx)
    ys = torch.minimum(torch.clamp(ys, min=0.0), (h_l - 1.0)[:, None])
    xs = torch.minimum(torch.clamp(xs, min=0.0), (w_l - 1.0)[:, None])
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1i = torch.minimum(y0 + 1.0, (h_l - 1.0)[:, None])
    x1i = torch.minimum(x0 + 1.0, (w_l - 1.0)[:, None])
    ly = (ys - y0)[:, :, None]                               # (R, Ty, 1)
    lx = (xs - x0)[:, :, None]                               # (R, Tx, 1)

    flat2 = flat.reshape(b * tot, c)
    gbase = (rois[:, 0].to(torch.int64) * tot + off_l)[:, None, None]

    def take(yy, xx):
        gidx = (gbase + yy.long()[:, :, None] * w_int[:, None, None]
                + xx.long()[:, None, :])
        ty, tx = gidx.shape[1], gidx.shape[2]
        return flat2.index_select(0, gidx.reshape(-1)).reshape(r, ty, tx, c)

    v00 = take(y0, x0)
    v01 = take(y0, x1i)
    v10 = take(y1i, x0)
    v11 = take(y1i, x1i)
    lyb = ly[:, :, None, :]                                  # (R, Ty, 1, 1)
    lxb = lx[:, None, :, :]                                  # (R, 1, Tx, 1)
    taps = (v00 * (1 - lyb) * (1 - lxb) + v01 * (1 - lyb) * lxb
            + v10 * lyb * (1 - lxb) + v11 * lyb * lxb)
    taps = taps.reshape(r, out_h, s, out_w, s, c)
    return taps.mean(dim=(2, 4))


def _kernel_fn():
    fn = build.load(KERNEL).iif_roi_align_ml_fwd
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([vp] * 4 + [ci] * 8 + [cf] * 4 + [vp] * 4
                       + [ci] * 5 + [vp])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(feats, rois, out_h, out_w, strides):
    if out_h != out_w:
        raise ValueError(f"kernel takes square outputs, got {out_h}x{out_w}")
    if len(feats) != 4 or len(strides) != 4:
        raise ValueError("kernel takes 4 levels, one stride each")
    f0 = feats[0]
    if f0.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {f0.dtype}")
    b, c = f0.shape[0], f0.shape[-1]
    if c % 2:
        raise ValueError(f"kernel takes an even channel count, got {c}")
    for f in feats:
        if f.device != rois.device or f.dtype != f0.dtype or f.dim() != 4:
            raise ValueError("levels must be 4-D, of one dtype, on the "
                             "rois' device")
        if f.shape[0] != b or f.shape[-1] != c:
            raise ValueError("levels must share batch and channels")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous (B, H, W, C)")
        if f.data_ptr() % (2 * f.element_size()):
            raise ValueError("level storage must be aligned to a channel "
                             "pair")
    if (rois.dtype != torch.float32 or rois.dim() != 2
            or rois.shape[1] != 5 or not rois.is_contiguous()):
        raise ValueError("rois must be a contiguous (R, 5) float32 tensor")


def roi_align_ml(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 output_size=(7, 7),
                 strides: Sequence[int] = (4, 8, 16, 32),
                 sampling_ratio: int = 0,
                 finest_scale: float = 56.0) -> torch.Tensor:
    """Multi-level RoIAlign in the feature dtype, (R, oh, ow, C).

    CPU tensors take ``roi_align_ml_reference``; CUDA tensors launch the
    kernel (which takes 4 contiguous NHWC levels, f32 or bf16, and square
    outputs) or raise."""
    feats = tuple(feats[:len(strides)])
    out_h, out_w = _pair(output_size)
    s = sampling_ratio if sampling_ratio > 0 else 2
    if rois.device.type == "cpu":
        return roi_align_ml_reference(
            feats, rois, (out_h, out_w), strides, s,
            finest_scale).to(feats[0].dtype)
    if rois.device.type != "cuda":
        raise ValueError(f"unsupported device {rois.device}")
    _check_cuda_inputs(feats, rois, out_h, out_w, strides)
    r = rois.shape[0]
    c = feats[0].shape[-1]
    out = torch.empty((r, out_h, out_w, c), dtype=feats[0].dtype,
                      device=rois.device)
    if r == 0:
        return out
    lvl = map_roi_levels(rois, len(strides), finest_scale)
    bidx = rois[:, 0].to(torch.int32)
    dims = []
    for f in feats:
        dims += [f.shape[1], f.shape[2]]
    with torch.cuda.device(rois.device):    # the launch uses the current one
        err = _kernel_fn()(
            *[f.data_ptr() for f in feats], *dims,
            *[float(st) for st in strides],
            rois.data_ptr(), lvl.data_ptr(), bidx.data_ptr(), out.data_ptr(),
            r, c, out_h, s, _DTYPES[feats[0].dtype],
            torch.cuda.current_stream(rois.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    roi_align_ml.launches_by_size[out_h] = (
        roi_align_ml.launches_by_size.get(out_h, 0) + 1)
    return out


# Kernel launches per output size (7 or 14); CPU calls do not count.
roi_align_ml.launches_by_size: Dict[int, int] = {}


def reset_launches() -> None:
    roi_align_ml.launches_by_size = {}
