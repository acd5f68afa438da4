"""Single-level RoIAlign: the CUDA kernels' wrappers, the autograd pairing
and the plain PyTorch versions.

K3, the forward, replaces ``iif_tpu/ops/pallas/roi_align_kernel.py::
roi_align_pallas`` (the TPU kernel ``_make_kernel`` / ``_pallas_call``),
whose function off the TPU is ``iif_tpu/ops/roi_align.py::roi_align``.
Both JAX functions have one counterpart here, ``roi_align``: each RoI's
box = roi * spatial_scale - offset (0.5 when ``aligned``; without it the
box is at least one cell wide and high), out_h x out_w bins of s x s
samples (``sampling_ratio`` 0 means 2), each sample clamped into the map
and read bilinearly with the high corner clamped, the mean over samples.
The result is float32 whatever the features' dtype, as in JAX (the Pallas
call casts to f32, the XLA path promotes bf16 x f32 weights).

K4, the backward, replaces ``roi_align_pallas_grad``'s VJP (``_rapg_bwd``;
TPU kernel ``_make_bwd_kernel`` / ``_pallas_bwd_call``): the map's
gradient, none for the RoIs. The JAX C4 loss differentiates the XLA
gather of ``ops/roi_align.py::roi_align`` (a scatter-add), which is the
function that ``_rapg_bwd`` computes off the TPU and K4 computes here: f32
sums into a zeroed (B, H, W, C) buffer, cast once to the map's dtype.

None of the TPU machinery is semantics: the 32x40 DMA window (which
clamps the taps of wider RoIs), the 8-aligned x origin, the one-hot MXU
matmuls and the backward's read-add-write of a window have no
counterpart, and non-square outputs take the kernels too. Both kernels
live in ``iif_torch/csrc/roi_align.cu``. Their least time on an H100 is
set by HBM bytes, mostly the f32 output K3 writes and the f32 gradient K4
reads. K3 is built to that bound's instruction budget: one block a RoI
with its taps computed once, eight channels a thread with 16-byte loads
and stores (``kernel_path``: two a thread for any other layout), s=2
unrolled, a separable blend in FMAs. K4 computes each RoI's window as
the TPU kernel does, dF = Wy^T g Wx: the RoI's distinct map rows and
columns with their bins' summed weights built once, then one vector
atomic per touched (row, column), eight channels a thread likewise
(``PERF.md``).

``roi_align`` is differentiable in the map: on a CPU tensor it is the
plain version under autograd; on a CUDA tensor it is ``RoIAlign``, whose
forward launches K3 and whose backward launches K4, or it raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple, Union

import torch

from iif_torch.ops import build

KERNEL = "roi_align"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 64                      # output side * sampling ratio


def _pair(size: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(size, int):
        return size, size
    return int(size[0]), int(size[1])


def roi_align_reference(features: torch.Tensor, rois: torch.Tensor,
                        output_size=(7, 7), spatial_scale: float = 1.0,
                        sampling_ratio: int = 0,
                        aligned: bool = True) -> torch.Tensor:
    """Plain version: a transcription of ``iif_tpu/ops/roi_align.py::
    roi_align`` and its ``_bilinear_gather_batched``, in their op order.

    features (B, H, W, C) f32 or bf16; rois (R, 5) = (batch_idx, x1, y1,
    x2, y2) in image pixels. Returns (R, oh, ow, C) float32."""
    out_h, out_w = _pair(output_size)
    s = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    b, h, w, c = features.shape
    r = rois.shape[0]
    dev = rois.device

    # Divisors are tensors on purpose: PyTorch's CUDA division by a Python
    # scalar multiplies by the reciprocal, which can move a sample by an
    # ulp. A tensor divisor keeps the rounding of a true division.
    def div(a, d):
        return a / torch.tensor(float(d), dtype=torch.float32, device=dev)

    # the batch index truncates as astype(int32); clamped into the batch
    # as JAX's gather clamps an index past the end
    bidx = rois[:, 0].to(torch.int64).clamp(0, b - 1)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:                 # legacy: at least one cell
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = div(roi_w, out_w)
    bin_h = div(roi_h, out_h)

    iy = div(torch.arange(out_h * s, dtype=torch.float32, device=dev) + 0.5, s)
    ix = div(torch.arange(out_w * s, dtype=torch.float32, device=dev) + 0.5, s)
    ys = y1[:, None] + bin_h[:, None] * iy[None, :]          # (R, Ty)
    xs = x1[:, None] + bin_w[:, None] * ix[None, :]          # (R, Tx)
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1i = torch.clamp(y0 + 1.0, max=h - 1.0)
    x1i = torch.clamp(x0 + 1.0, max=w - 1.0)
    ly = ys - y0
    lx = xs - x0

    flat = features.reshape(b * h * w, c)
    base = (bidx * (h * w))[:, None, None]

    def take(yy, xx):
        gidx = base + yy.long()[:, :, None] * w + xx.long()[:, None, :]
        return flat.index_select(0, gidx.reshape(-1)).reshape(
            r, yy.shape[1], xx.shape[1], c)

    v00 = take(y0, x0)
    v01 = take(y0, x1i)
    v10 = take(y1i, x0)
    v11 = take(y1i, x1i)
    lyb = ly[:, :, None, None]                               # (R, Ty, 1, 1)
    lxb = lx[:, None, :, None]                               # (R, 1, Tx, 1)
    taps = (v00 * (1 - lyb) * (1 - lxb) + v01 * (1 - lyb) * lxb
            + v10 * lyb * (1 - lxb) + v11 * lyb * lxb)
    taps = taps.reshape(r, out_h, s, out_w, s, c)
    return taps.mean(dim=(2, 4))


def roi_align_grad_reference(features: torch.Tensor, rois: torch.Tensor,
                             grad_out: torch.Tensor, output_size=(7, 7),
                             spatial_scale: float = 1.0,
                             sampling_ratio: int = 0,
                             aligned: bool = True) -> torch.Tensor:
    """Plain version of K4: ``torch.autograd.grad`` of
    ``roi_align_reference`` at ``grad_out`` (R, oh, ow, C), taken on an f32
    copy of the map so that the sums run in f32, then cast to the map's
    dtype. Only the map's shape and dtype matter."""
    with torch.enable_grad():
        f32 = features.detach().float().requires_grad_(True)
        out = roi_align_reference(f32, rois, output_size, spatial_scale,
                                  sampling_ratio, aligned)
        grad, = torch.autograd.grad(out, f32, grad_out.float())
    return grad.to(features.dtype)


def _fn(symbol: str, argtypes: list):
    fn = getattr(build.load(KERNEL), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_VP] + [_CI] * 4 + [_VP] * 2 + [_CI] * 4 + [_CF] + [_CI] * 3 \
    + [_VP]
_BWD_ARGS = [_VP] + [_CI] * 4 + [_VP] * 2 + [_CI] * 4 + [_CF] + [_CI] * 2 \
    + [_VP]


def kernel_path(*tensors: torch.Tensor) -> str:
    """Which instantiation of a RoIAlign kernel takes these channels-last
    tensors (for K1 and K3 the map or levels and the output; for K2 and K4
    g and the f32 accumulator): ``"vec8"`` (eight channels a thread,
    16-byte loads and stores, float4 atomics) when every one has a
    multiple of 8 channels and starts on 16 bytes, else ``"pair"`` (two
    channels a thread), e.g. for C=258 or a view whose storage offset is
    an odd number of channel pairs."""
    if all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
           for t in tensors):
        return "vec8"
    return "pair"


def _check_cuda_inputs(features, rois, out_h, out_w, s):
    if features.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got "
                        f"{features.dtype}")
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError("features must be a contiguous (B, H, W, C) tensor")
    if features.shape[-1] % 2:
        raise ValueError(f"kernel takes an even channel count, got "
                         f"{features.shape[-1]}")
    if features.data_ptr() % (2 * features.element_size()):
        raise ValueError("feature storage must be aligned to a channel pair")
    if (rois.dtype != torch.float32 or rois.dim() != 2
            or rois.shape[1] != 5 or not rois.is_contiguous()):
        raise ValueError("rois must be a contiguous (R, 5) float32 tensor")
    if features.device != rois.device:
        raise ValueError("features and rois must be on one device")
    if max(out_h, out_w) * s > MAX_TAPS:
        raise ValueError(f"kernel takes at most {MAX_TAPS} samples a side, "
                         f"got {max(out_h, out_w)} x {s}")


def _count(counter: Dict[Tuple[int, int], int], out_h: int,
           out_w: int) -> None:
    counter[(out_h, out_w)] = counter.get((out_h, out_w), 0) + 1


def count_path(counter: Dict[str, int], path: str) -> None:
    counter[path] = counter.get(path, 0) + 1


def _launch(features, rois, out_h, out_w, s, spatial_scale, aligned):
    """K3 on validated inputs: (R, out_h, out_w, C) float32."""
    bsz, h, w, c = features.shape
    r = rois.shape[0]
    out = torch.empty((r, out_h, out_w, c), dtype=torch.float32,
                      device=rois.device)
    if r == 0:
        return out
    path = kernel_path(features, out)
    with torch.cuda.device(rois.device):    # the launch uses the current one
        err = _fn("iif_roi_align_fwd", _FWD_ARGS)(
            features.data_ptr(), bsz, h, w, c, rois.data_ptr(),
            out.data_ptr(), r, out_h, out_w, s, float(spatial_scale),
            int(bool(aligned)), _DTYPES[features.dtype],
            int(path == "vec8"),
            torch.cuda.current_stream(rois.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    _count(roi_align.launches_by_size, out_h, out_w)
    count_path(roi_align.launches_by_path, path)
    return out


def _bwd_buffers(shape, grad_out):
    """K4's buffers for a map of ``shape``: the f32 accumulator, g as the
    contiguous f32 tensor the kernel reads, and the kernel path they
    allow (``kernel_path``: a g view that starts off 16 bytes, or C % 8,
    sends it to ``"pair"``)."""
    acc = torch.empty(shape, dtype=torch.float32, device=grad_out.device)
    g = grad_out.float().contiguous()
    return acc, g, kernel_path(g, acc)


def _bwd_call(acc, g, path, rois, out_h, out_w, s, spatial_scale, aligned):
    """K4's C entry on its buffers: zero ``acc`` and scatter into it. No
    allocation and no count: a CUDA graph of it times the kernel."""
    bsz, h, w, c = acc.shape
    dev = rois.device
    with torch.cuda.device(dev):
        err = _fn("iif_roi_align_bwd", _BWD_ARGS)(
            acc.data_ptr(), bsz, h, w, c, rois.data_ptr(), g.data_ptr(),
            rois.shape[0], out_h, out_w, s, float(spatial_scale),
            int(bool(aligned)), int(path == "vec8"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} backward launch failed: cudaError "
                           f"{err}")


def _launch_bwd(shape, dtype, rois, grad_out, out_h, out_w, s,
                spatial_scale, aligned):
    """K4 on validated inputs: the map's gradient, (B, H, W, C) in
    ``dtype`` (summed in f32, cast once)."""
    acc, g, path = _bwd_buffers(shape, grad_out)
    _bwd_call(acc, g, path, rois, out_h, out_w, s, spatial_scale, aligned)
    _count(grad_launches_by_size, out_h, out_w)
    count_path(grad_launches_by_path, path)
    return acc.to(dtype)


class RoIAlign(torch.autograd.Function):
    """K3 forward, K4 backward, on CUDA tensors. The RoIs get no
    gradient, as in the reference CUDA op; the map is not saved, only its
    shape and dtype."""

    @staticmethod
    def forward(ctx, features, rois, out_h, out_w, sampling_ratio,
                spatial_scale, aligned):
        out = _launch(features, rois, out_h, out_w, sampling_ratio,
                      spatial_scale, aligned)
        ctx.save_for_backward(rois)
        ctx.shape = tuple(features.shape)
        ctx.dtype = features.dtype
        ctx.cfg = (out_h, out_w, sampling_ratio, spatial_scale, aligned)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rois, = ctx.saved_tensors
        grad = _launch_bwd(ctx.shape, ctx.dtype, rois, grad_out, *ctx.cfg)
        return (grad,) + (None,) * 6


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              output_size=(7, 7), spatial_scale: float = 1.0,
              sampling_ratio: int = 0, aligned: bool = True) -> torch.Tensor:
    """Single-level RoIAlign, (R, oh, ow, C) float32, differentiable in
    ``features``.

    CPU tensors take ``roi_align_reference`` under autograd; CUDA tensors
    take ``RoIAlign`` (K3 forward, K4 backward; a contiguous NHWC map in
    f32 or bf16, an even channel count) or raise."""
    out_h, out_w = _pair(output_size)
    s = sampling_ratio if sampling_ratio > 0 else 2
    if rois.device.type == "cpu":
        return roi_align_reference(features, rois, (out_h, out_w),
                                   spatial_scale, s, aligned)
    if rois.device.type != "cuda":
        raise ValueError(f"unsupported device {rois.device}")
    _check_cuda_inputs(features, rois, out_h, out_w, s)
    return RoIAlign.apply(features, rois, out_h, out_w, s,
                          float(spatial_scale), bool(aligned))


# Kernel launches per (out_h, out_w): K3's, and K4's (launched only by
# ``RoIAlign.backward``); each also per ``kernel_path``. CPU calls do not
# count.
roi_align.launches_by_size: Dict[Tuple[int, int], int] = {}
roi_align.launches_by_path: Dict[str, int] = {}
grad_launches_by_size: Dict[Tuple[int, int], int] = {}
grad_launches_by_path: Dict[str, int] = {}


def reset_launches() -> None:
    roi_align.launches_by_size = {}
    roi_align.launches_by_path = {}
    grad_launches_by_size.clear()
    grad_launches_by_path.clear()
