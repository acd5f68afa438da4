"""Multi-level aligned RoIAlign: the CUDA kernels' wrappers, the autograd
pairing and the plain PyTorch versions.

K1, the forward, replaces ``iif_tpu/ops/pallas/roi_align_kernel.py::
roi_align_pallas_ml`` (the TPU kernel ``_make_ml_kernel`` /
``_pallas_ml_call``). It computes what ``SingleRoIExtractor._flat_gather``
computes (``iif_tpu/detection/roi_extractor.py:97-166``): each RoI's FPN
level from ``map_roi_levels``, box = roi / stride - 0.5, out x out bins of
s x s samples, each sample clamped into the map and read bilinearly with
the high corner clamped, the mean over samples.

K2, the backward, replaces the custom VJP ``_ml_bwd`` (TPU kernel
``_make_ml_bwd_kernel`` / ``_pallas_ml_bwd_call``): the levels' gradient
(none for the RoIs, which come from stop-gradient proposals and gt
boxes), accumulated in f32 with atomics and cast to the feature dtype.

Both kernels live in ``iif_torch/csrc/roi_align_ml.cu``. What bounds them
on an H100 is HBM bytes: K1 reads the touched feature rows and writes the
(R, out, out, C) output; K2 reads g and read-modify-writes the touched f32
accumulator rows, then writes the levels' gradient. Both touch each
bilinear corner as one coalesced row of C channels (NHWC) with the sample
geometry in shared memory, eight channels a thread with 16-byte accesses
(``kernel_path``: two a thread for any other layout). K1 takes one block
a RoI. K2 computes each RoI's window as the TPU kernel does, dF = Wy^T g
Wx: the RoI's distinct rows and columns at its level with their bins'
summed weights built once, then one float4 atomic per touched (row,
column) and 4 channels.

``roi_align_ml`` is differentiable: on a CPU tensor it is the plain
version under autograd; on a CUDA tensor it is ``RoIAlignML``, whose
forward launches K1 and whose backward launches K2, or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple, Union

import torch

from iif_torch.ops import build
from iif_torch.ops.roi_align import count_path, kernel_path

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


def roi_align_ml_grad_reference(feats: Sequence[torch.Tensor],
                                rois: torch.Tensor, grad_out: torch.Tensor,
                                output_size=(7, 7),
                                strides: Sequence[int] = (4, 8, 16, 32),
                                sampling_ratio: int = 0,
                                finest_scale: float = 56.0
                                ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K2: ``torch.autograd.grad`` of
    ``roi_align_ml_reference`` at ``grad_out`` (R, oh, ow, C), taken on
    f32 copies of the levels so that the sums run in f32, then cast to
    each level's dtype. Only the levels' shapes and dtype matter."""
    with torch.enable_grad():
        f32 = [f.detach().float().requires_grad_(True)
               for f in feats[:len(strides)]]
        out = roi_align_ml_reference(f32, rois, output_size, strides,
                                     sampling_ratio, finest_scale)
        grads = torch.autograd.grad(out, f32, grad_out.float())
    return tuple(g.to(f.dtype) for g, f in zip(grads, feats))


def _fn(symbol: str, argtypes: list):
    fn = getattr(build.load(KERNEL), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _CI, _CF, _CLL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
_FWD_ARGS = [_VP] * 4 + [_CI] * 8 + [_CF] * 4 + [_VP] * 4 + [_CI] * 6 + [_VP]
_BWD_ARGS = ([_VP] * 2 + [_CLL] * 5 + [_CI] * 8 + [_CF] * 4 + [_VP] * 4
             + [_CI] * 6 + [_VP])


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


def _roi_meta(rois, num_levels, finest_scale):
    """Each RoI's level (the plain version's ``map_roi_levels``, never a
    device log2 near a level boundary) and batch index, int32."""
    return (map_roi_levels(rois, num_levels, finest_scale),
            rois[:, 0].to(torch.int32))


def _level_dims(shapes) -> list:
    dims = []
    for shp in shapes:
        dims += [int(shp[1]), int(shp[2])]
    return dims


def _count(counter: Dict[int, int], out_size: int) -> None:
    counter[out_size] = counter.get(out_size, 0) + 1


def _launch_fwd(feats, rois, lvl, bidx, out_size, s, strides):
    """K1 on validated inputs: (R, out, out, C) in the feature dtype."""
    r, c = rois.shape[0], feats[0].shape[-1]
    out = torch.empty((r, out_size, out_size, c), dtype=feats[0].dtype,
                      device=rois.device)
    if r == 0:
        return out
    path = kernel_path(*feats, out)
    with torch.cuda.device(rois.device):    # the launch uses the current one
        err = _fn("iif_roi_align_ml_fwd", _FWD_ARGS)(
            *[f.data_ptr() for f in feats], *_level_dims(
                [f.shape for f in feats]),
            *[float(st) for st in strides],
            rois.data_ptr(), lvl.data_ptr(), bidx.data_ptr(), out.data_ptr(),
            r, c, out_size, s, _DTYPES[feats[0].dtype],
            int(path == "vec8"),
            torch.cuda.current_stream(rois.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} forward launch failed: cudaError {err}")
    _count(roi_align_ml.launches_by_size, out_size)
    count_path(roi_align_ml.launches_by_path, path)
    return out


def _bwd_buffers(shapes, dtype, grad_out):
    """K2's buffers for levels of ``shapes`` in ``dtype``: one f32
    accumulator holding the levels back to back, the result (the
    accumulator itself for f32), g as the contiguous ``dtype`` tensor the
    kernel reads, and the kernel path they allow (``kernel_path``)."""
    dev = grad_out.device
    c = int(shapes[0][-1])
    total = sum(math.prod(shp) for shp in shapes)
    acc = torch.empty(total, dtype=torch.float32, device=dev)
    out = acc if dtype == torch.float32 else torch.empty(
        total, dtype=dtype, device=dev)
    g = grad_out.to(dtype).contiguous()
    return acc, out, g, kernel_path(g, acc.view(-1, c))


def _bwd_call(acc, out, g, path, shapes, rois, lvl, bidx, out_size, s,
              strides):
    """K2's C entry on its buffers: zero ``acc``, scatter into it and, for
    bf16, cast it into ``out``. No allocation and no count: a CUDA graph
    of it times the kernel."""
    dev = rois.device
    sizes = [math.prod(shp) for shp in shapes]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    with torch.cuda.device(dev):
        err = _fn("iif_roi_align_ml_bwd", _BWD_ARGS)(
            acc.data_ptr(), out.data_ptr(), acc.numel(), *offs,
            *_level_dims(shapes), *[float(st) for st in strides],
            rois.data_ptr(), lvl.data_ptr(), bidx.data_ptr(), g.data_ptr(),
            rois.shape[0], int(shapes[0][-1]), out_size, s,
            _DTYPES[g.dtype], int(path == "vec8"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} backward launch failed: cudaError {err}")


def _launch_bwd(shapes, dtype, rois, lvl, bidx, grad_out, out_size, s,
                strides):
    """K2 on validated inputs: the four levels' gradient in ``dtype``."""
    acc, out, g, path = _bwd_buffers(shapes, dtype, grad_out)
    _bwd_call(acc, out, g, path, shapes, rois, lvl, bidx, out_size, s,
              strides)
    _count(grad_launches_by_size, out_size)
    count_path(grad_launches_by_path, path)
    sizes = [math.prod(shp) for shp in shapes]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    return tuple(out[o:o + n].view(shp)
                 for o, n, shp in zip(offs, sizes, shapes))


class RoIAlignML(torch.autograd.Function):
    """K1 forward, K2 backward, on CUDA tensors. The RoIs get no
    gradient."""

    @staticmethod
    def forward(ctx, rois, output_size, strides, sampling_ratio,
                finest_scale, *feats):
        lvl, bidx = _roi_meta(rois, len(strides), finest_scale)
        out = _launch_fwd(feats, rois, lvl, bidx, output_size,
                          sampling_ratio, strides)
        ctx.save_for_backward(rois, lvl, bidx)
        ctx.shapes = [tuple(f.shape) for f in feats]
        ctx.dtype = feats[0].dtype
        ctx.cfg = (output_size, sampling_ratio, tuple(strides))
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rois, lvl, bidx = ctx.saved_tensors
        out_size, s, strides = ctx.cfg
        grads = _launch_bwd(ctx.shapes, ctx.dtype, rois, lvl, bidx,
                            grad_out, out_size, s, strides)
        return (None,) * 5 + grads


def roi_align_ml(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 output_size=(7, 7),
                 strides: Sequence[int] = (4, 8, 16, 32),
                 sampling_ratio: int = 0,
                 finest_scale: float = 56.0) -> torch.Tensor:
    """Multi-level RoIAlign in the feature dtype, (R, oh, ow, C),
    differentiable in ``feats``.

    CPU tensors take ``roi_align_ml_reference`` under autograd; CUDA
    tensors take ``RoIAlignML`` (K1 forward, K2 backward; 4 contiguous
    NHWC levels, f32 or bf16, square outputs) or raise."""
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
    return RoIAlignML.apply(rois, out_h, tuple(strides), s, finest_scale,
                            *feats)


# Kernel launches per output size (7 or 14): K1's, and K2's (launched
# only by ``RoIAlignML.backward``); each also per ``kernel_path``. CPU
# calls do not count.
roi_align_ml.launches_by_size: Dict[int, int] = {}
roi_align_ml.launches_by_path: Dict[str, int] = {}
grad_launches_by_size: Dict[int, int] = {}
grad_launches_by_path: Dict[str, int] = {}


def reset_launches() -> None:
    roi_align_ml.launches_by_size = {}
    roi_align_ml.launches_by_path = {}
    grad_launches_by_size.clear()
    grad_launches_by_path.clear()
