"""The multi-level RoIAlign's gradient: the port's plain backward (autograd
of ``roi_align_ml_reference``) against ``jax.grad`` of the JAX package's
``SingleRoIExtractor(use_pallas="ml")``, which on the CPU runs
``_flat_gather``; a gradcheck in f64; and the CPU route of
``roi_align_ml``'s autograd. K2 itself runs only on the card: its test is
beside K1's in ``tests/test_torch_roi_align.py``. This file imports no
other test module (a ``tests`` package elsewhere on ``sys.path`` would
shadow it), so it keeps its own copy of that file's RoI maker."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.ops.roi_align_ml import (
    grad_launches_by_size,
    roi_align_ml,
    roi_align_ml_grad_reference,
    roi_align_ml_reference,
)

torch.set_num_threads(1)

LVIS_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
SMALL_LEVELS = [(16, 24), (8, 12), (4, 6), (2, 3)]


def make_rois(rng, r, canvas_hw, scale_range):
    """RoIs as in tests/test_pallas_roi_align.py: log-uniform size and
    aspect, the first four at aspect 8, 12, 1/8 and 16, clamped to the
    canvas (so some touch its border), batch index 0 or 1."""
    h, w = canvas_hw
    centers = rng.rand(r, 2) * [w - 44, h - 20]
    scale_px = np.exp(rng.uniform(np.log(scale_range[0]),
                                  np.log(scale_range[1]), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    aspect[:4] = [8.0, 12.0, 1.0 / 8.0, 16.0]
    w_px = scale_px * np.sqrt(aspect)
    h_px = scale_px / np.sqrt(aspect)
    x1 = np.clip(centers[:, 0] - w_px / 2, 0, w - 1)
    y1 = np.clip(centers[:, 1] - h_px / 2, 0, h - 1)
    x2 = np.clip(centers[:, 0] + w_px / 2, 0, w - 1)
    y2 = np.clip(centers[:, 1] + h_px / 2, 0, h - 1)
    bidx = rng.randint(0, 2, r)
    bidx[:2] = 1
    return np.stack([bidx, x1, y1, x2, y2], 1).astype(np.float32)


def _jax_grad(feats, rois, g, o):
    from iif_tpu.detection.roi_extractor import SingleRoIExtractor as JaxExt

    ext = JaxExt((o, o), use_pallas="ml")

    def f(fs):
        return jnp.sum(ext(list(fs), jnp.asarray(rois)) * jnp.asarray(g))

    return [np.asarray(x) for x in jax.jit(jax.grad(f))(
        tuple(jnp.asarray(x) for x in feats))]


def _plain_grad(feats, rois, g, o):
    return [x.numpy() for x in roi_align_ml_grad_reference(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(g), (o, o))]


@pytest.mark.parametrize("o", [7, 14])
def test_plain_backward_matches_jax_small_canvas(o):
    """atol 3e-5. Below 24 cells an ulp of a sample position is below
    2e-6 cells, but jitted XLA on the CPU rounds the positions through a
    reciprocal multiply and a fused multiply-add (the forward's cause,
    ROADMAP Queue 3), and a level cell sums the weights of up to dozens
    of samples: measured 1.1e-5."""
    rng = np.random.RandomState(20 + o)
    feats = [rng.randn(2, h, w, 8).astype(np.float32)
             for h, w in SMALL_LEVELS]
    rois = make_rois(rng, 48, (64, 96), (4, 96))
    g = rng.randn(48, o, o, 8).astype(np.float32)
    for got, want in zip(_plain_grad(feats, rois, g, o),
                         _jax_grad(feats, rois, g, o)):
        np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("o", [7, 14])
def test_plain_backward_matches_jax_lvis_coordinates(o):
    """The LVIS levels (800x1344 canvas, narrow C), with RoIs of aspect
    8, 12, 1/8 and 16 among them. atol 2e-4 for the forward's reason
    (ROADMAP Queue 3): XLA on the CPU rounds the sample positions through
    a reciprocal multiply and a fused multiply-add, an ulp (3e-5 cells)
    away from the port's at ~336 cells, which moves each bilinear weight
    by as much."""
    rng = np.random.RandomState(30 + o)
    feats = [rng.randn(2, h, w, 4).astype(np.float32)
             for h, w in LVIS_LEVELS]
    rois = make_rois(rng, 96, (800, 1344), (16, 512))
    g = rng.randn(96, o, o, 4).astype(np.float32)
    got = _plain_grad(feats, rois, g, o)
    want = _jax_grad(feats, rois, g, o)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=2e-4)
    assert sum(np.abs(w).max() > 0 for w in want) >= 3


def test_gradcheck_f64_tiny_map():
    """The plain version is linear in the levels: its autograd passes
    ``torch.autograd.gradcheck`` in f64."""
    rng = np.random.RandomState(40)
    levels = [(6, 8), (3, 4), (2, 2), (1, 1)]
    feats = tuple(torch.from_numpy(rng.randn(1, h, w, 2)).requires_grad_()
                  for h, w in levels)
    rois = torch.tensor([[0, 1.0, 2.0, 20.0, 18.0], [0, 0.0, 0.0, 31.0, 23.0],
                         [0, 10.0, 3.0, 30.0, 9.0]], dtype=torch.float32)

    def f(*fs):
        return roi_align_ml_reference(fs, rois, (2, 2))

    assert torch.autograd.gradcheck(f, feats, eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_routes_are_the_plain_backward(dtype):
    """On CPU tensors ``roi_align_ml`` differentiates through the plain
    version: its levels' gradient has the level's dtype and shape and, in
    f32, equals the plain backward exactly (in bf16 CPU autograd sums in
    bf16, the plain backward in f32); no launch is counted."""
    rng = np.random.RandomState(41)
    feats = [torch.from_numpy(rng.randn(2, h, w, 8).astype(np.float32))
             .to(dtype) for h, w in SMALL_LEVELS]
    rois = torch.from_numpy(make_rois(rng, 16, (64, 96), (4, 96)))
    g = torch.from_numpy(rng.randn(16, 7, 7, 8).astype(np.float32))
    before = (dict(roi_align_ml.launches_by_size),
              dict(grad_launches_by_size))
    want = roi_align_ml_grad_reference(feats, rois, g)
    assert all(w.dtype == dtype for w in want)
    leaves = [f.clone().requires_grad_() for f in feats]
    roi_align_ml(leaves, rois).backward(g.to(dtype))
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        if dtype == torch.float32:
            assert torch.equal(leaf.grad, w)
    assert (dict(roi_align_ml.launches_by_size),
            dict(grad_launches_by_size)) == before
