"""K1 and K2 (``iif_torch/csrc/roi_align_ml.cu``) against their plain
versions at the FPN level shapes of each of the six canvas buckets of the
headline recipe (640 .. 800 x 1344: levels H/4 x 336 .. H/32 x 42), at
the training shapes (B=4; 7x7 with R=2048, 14x14 with R=512), f32 and
bf16, every launch on the eight-channel path. Tolerances as the kernel
phase's: K1 f32 to 1e-5, bf16 within one bf16 ulp of the value after the
cast; K2 f32 within 1e-5 of the largest gradient, bf16 also within 2^-8
of each value (its atomics add in an order that changes between runs).

On the card only (``cuda`` marker; this file imports nothing from
``tests.*``)::

    python3 -m pytest tests/test_torch_roi_align_buckets.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from iif_torch.ops.roi_align_ml import (
    grad_launches_by_path,
    reset_launches,
    roi_align_ml,
    roi_align_ml_grad_reference,
    roi_align_ml_reference,
)

BUCKETS = (640, 672, 704, 736, 768, 800)        # canvas heights, W 1344
WIDTH = 1344


def _levels(h):
    return [(h // s, WIDTH // s) for s in (4, 8, 16, 32)]


def _rois(rng, r, h):
    """Log-uniform sizes 16-512 px and aspects 1/4-4 inside the bucket's
    canvas, over 4 images."""
    c = rng.rand(r, 2) * [WIDTH - 1, h - 1]
    size = np.exp(rng.uniform(np.log(16), np.log(512), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    half = np.stack([size * np.sqrt(aspect), size / np.sqrt(aspect)], 1) / 2
    lo = np.clip(c - half, 0, [WIDTH - 1, h - 1])
    hi = np.clip(c + half, 0, [WIDTH - 1, h - 1])
    rois = np.concatenate([rng.randint(0, 4, (r, 1)), lo, hi], 1)
    return torch.tensor(rois, dtype=torch.float32, device="cuda")


def _inputs(h, o, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(h + o)
    feats = [torch.from_numpy(rng.randn(4, lh, lw, 256).astype(np.float32))
             .to("cuda", dtype) for lh, lw in _levels(h)]
    return rng, feats, _rois(rng, 2048 if o == 7 else 512, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [7, 14])
@pytest.mark.parametrize("h", BUCKETS)
def test_k1_on_bucket_levels(h, o, dtype):
    _, feats, rois = _inputs(h, o, dtype)
    reset_launches()
    got = roi_align_ml(feats, rois, (o, o)).float()
    torch.cuda.synchronize()
    assert roi_align_ml.launches_by_path == {"vec8": 1}
    want = roi_align_ml_reference(feats, rois, (o, o))
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        cast = want.to(dtype).float()
        ulp = torch.pow(2.0, torch.floor(torch.log2(cast.abs().clamp(
            min=2.0 ** -126))) - 7)
        assert bool(((got - cast).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [7, 14])
@pytest.mark.parametrize("h", BUCKETS)
def test_k2_on_bucket_levels(h, o, dtype):
    rng, feats, rois = _inputs(h, o, dtype)
    g = torch.from_numpy(rng.randn(rois.shape[0], o, o, 256).astype(
        np.float32)).to("cuda", dtype)
    leaves = [f.clone().requires_grad_() for f in feats]
    reset_launches()
    roi_align_ml(leaves, rois, (o, o)).backward(g)
    torch.cuda.synchronize()
    assert grad_launches_by_path == {"vec8": 1}
    want = roi_align_ml_grad_reference([f.float() for f in feats], rois,
                                       g.float(), (o, o))
    scale = max(w.abs().max().item() for w in want)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        err = (leaf.grad.float() - w).abs()
        bound = 1e-5 * scale
        if dtype == torch.bfloat16:
            bound = bound + 2.0 ** -8 * w.abs()
        assert bool((err <= bound).all())
