"""The single-level RoIAlign's gradient with respect to the map: the port's
plain backward ``roi_align_grad_reference`` (kernel K4's plain version)
against ``jax.vjp`` of the JAX package's ``iif_tpu.ops.roi_align.
roi_align`` (the XLA gather the C4 loss differentiates) and against
``jax.grad`` through ``roi_align_pallas_grad``, whose VJP off the TPU is
that same scatter-add (``_rapg_bwd``); a gradcheck in f64; and the CPU
route of ``roi_align``'s autograd. K4 itself runs only on the card: its
tests are beside K3's in ``tests/test_torch_roi_align_single.py``. This
file imports no other test module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.ops.roi_align import (
    grad_launches_by_size,
    roi_align,
    roi_align_grad_reference,
    roi_align_reference,
)

torch.set_num_threads(1)

C4_MAP = (50, 84)                  # the C4 map of an 800x1344 canvas


def make_rois(rng, r, map_hw, scale, batch=2):
    """RoIs in image pixels for a (H, W) map at ``scale``: log-uniform
    size from a fifth of a cell to the whole map and log-uniform aspect;
    first the whole map, RoIs on and past its edges, two wholly outside,
    two under one cell a side, a zero-size one, and eight piled onto one
    cell (so that many samples add into the same corners)."""
    h, w = map_hw[0] / scale, map_hw[1] / scale
    cell = 1.0 / scale
    centers = rng.rand(r, 2) * [w, h]
    size = np.exp(rng.uniform(np.log(0.2 * cell), np.log(min(h, w)), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    boxes = np.stack([centers[:, 0] - bw / 2, centers[:, 1] - bh / 2,
                      centers[:, 0] + bw / 2, centers[:, 1] + bh / 2], 1)
    special = [
        [0.0, 0.0, w, h],                               # the whole map
        [-3 * cell, -2 * cell, 2 * cell, 3 * cell],     # past the top left
        [w - 2 * cell, h - 3 * cell, w + 4 * cell, h + cell],
        [w + cell, h + cell, w + 5 * cell, h + 4 * cell],   # outside
        [-6 * cell, -5 * cell, -cell, -2 * cell],           # outside
        [5.1 * cell, 2.2 * cell, 5.4 * cell, 2.3 * cell],   # sub-cell
        [0.5 * cell, 0.5 * cell, 0.9 * cell, 0.6 * cell],   # sub-cell
        [3.3 * cell, 1.7 * cell, 3.3 * cell, 1.7 * cell],   # zero size
    ] + [[(2.1 + 0.05 * i) * cell, (1.2 + 0.04 * i) * cell,
          (2.8 + 0.02 * i) * cell, (1.9 + 0.03 * i) * cell]
         for i in range(8)]                         # piled onto one cell
    boxes[:len(special)] = special
    bidx = rng.randint(0, batch, r)
    return np.concatenate([bidx[:, None], boxes], 1).astype(np.float32)


def _jax_grads(feats, rois, g, out, scale, sr, aligned):
    """The map's gradient from both JAX entry points, f32."""
    from iif_tpu.ops.pallas.roi_align_kernel import roi_align_pallas_grad
    from iif_tpu.ops.roi_align import roi_align as jax_roi_align

    def by_vjp(f, rr, gg):
        _, vjp = jax.vjp(lambda x: jax_roi_align(x, rr, out, scale, sr,
                                                 aligned), f)
        return vjp(gg)[0]

    def by_grad(f, rr, gg):
        return jax.grad(lambda x: jnp.sum(roi_align_pallas_grad(
            x, rr, out, scale, sr, aligned) * gg))(f)

    def both(*args):
        return by_vjp(*args), by_grad(*args)

    args = (jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(g))
    return [np.asarray(x) for x in jax.jit(both)(*args)]


def _plain_grad(feats, rois, g, out, scale, sr, aligned,
                dtype=torch.float32):
    return roi_align_grad_reference(
        torch.from_numpy(feats).to(dtype), torch.from_numpy(rois),
        torch.from_numpy(g), out, scale, sr, aligned)


@pytest.mark.parametrize("sr", [0, 1, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_plain_backward_matches_jax_small_map(sr, aligned):
    """f32, a 12x20 map at scale 1/4, 7x7 bins, against both JAX entry
    points: atol 3e-5. Coordinates stay within about 25 cells, where an
    ulp of a sample position is below 2e-6 cells, but jitted XLA on the
    CPU rounds the positions through a reciprocal multiply and a fused
    multiply-add (the forward's cause, ROADMAP Queue 3), and a cell sums
    the weights of dozens of samples (eight RoIs are piled onto one):
    measured 1.1e-5 at most (sampling ratio 4)."""
    rng = np.random.RandomState(50 + sr)
    feats = rng.randn(2, 12, 20, 8).astype(np.float32)
    rois = make_rois(rng, 40, (12, 20), 1 / 4)
    g = rng.randn(40, 7, 7, 8).astype(np.float32)
    got = _plain_grad(feats, rois, g, (7, 7), 1 / 4, sr, aligned).numpy()
    for want in _jax_grads(feats, rois, g, (7, 7), 1 / 4, sr, aligned):
        np.testing.assert_allclose(got, want, atol=3e-5)
    assert np.abs(got).max() > 1.0


def test_plain_backward_matches_jax_c4_coordinates():
    """The C4 training geometry: a 50x84 map at scale 1/16, 14x14, s=2,
    aligned, RoIs up to the whole map. atol 2e-4 for the forward's
    reason: at 84 cells an ulp of a sample position is 8e-6 cells, and
    XLA's reciprocal/FMA rewrite moves it by as much, which moves each
    bilinear weight by as much in a cell that sums up to hundreds of
    them: measured 3.8e-5 (the largest gradient is about 29)."""
    rng = np.random.RandomState(60)
    feats = rng.randn(2, *C4_MAP, 4).astype(np.float32)
    rois = make_rois(rng, 96, C4_MAP, 1 / 16)
    g = rng.randn(96, 14, 14, 4).astype(np.float32)
    got = _plain_grad(feats, rois, g, (14, 14), 1 / 16, 0, True).numpy()
    for want in _jax_grads(feats, rois, g, (14, 14), 1 / 16, 0, True):
        np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("aligned", [True, False])
def test_plain_backward_matches_jax_non_square(aligned):
    """5x9 bins (``roi_align_pallas_grad`` takes XLA's path for them on
    any backend): atol 3e-5, as at small coordinates (measured 8.6e-6)."""
    rng = np.random.RandomState(70)
    feats = rng.randn(2, 12, 20, 8).astype(np.float32)
    rois = make_rois(rng, 40, (12, 20), 1 / 4)
    g = rng.randn(40, 5, 9, 8).astype(np.float32)
    got = _plain_grad(feats, rois, g, (5, 9), 1 / 4, 2, aligned).numpy()
    for want in _jax_grads(feats, rois, g, (5, 9), 1 / 4, 2, aligned):
        np.testing.assert_allclose(got, want, atol=3e-5)


def test_bf16_map_gradient_within_one_ulp():
    """For a bf16 map the port sums in f32 and rounds once: within one
    bf16 ulp of JAX's f32 gradient rounded once to bf16. (JAX's own bf16
    route scatter-adds in bf16, ROADMAP Queue 3, so it is not the
    yardstick.)"""
    rng = np.random.RandomState(80)
    feats = rng.randn(2, 12, 20, 8).astype(np.float32)
    rois = make_rois(rng, 40, (12, 20), 1 / 4)
    g = rng.randn(40, 7, 7, 8).astype(np.float32)
    got = _plain_grad(feats, rois, g, (7, 7), 1 / 4, 0, True,
                      torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 12, 20, 8)
    want32 = _jax_grads(feats, rois, g, (7, 7), 1 / 4, 0, True)[0]
    want = torch.from_numpy(want32.copy()).to(torch.bfloat16).float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp(min=2.0 ** -126))) - 7)
    assert ((got.float() - want).abs() <= ulp).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_rois(dtype):
    """R=0: a zero gradient of the map's shape and dtype."""
    feats = torch.zeros(1, 6, 8, 4, dtype=dtype)
    got = roi_align_grad_reference(feats, torch.zeros(0, 5),
                                   torch.zeros(0, 14, 14, 4), (14, 14),
                                   1 / 16)
    assert got.dtype == dtype and got.shape == feats.shape
    assert not got.any()


def test_gradcheck_f64_tiny_map():
    """The plain version is linear in the map: its autograd passes
    ``torch.autograd.gradcheck`` in f64, aligned and not."""
    rng = np.random.RandomState(90)
    feats = torch.from_numpy(rng.randn(2, 5, 7, 2)).requires_grad_()
    rois = torch.tensor([[0, 1.0, 2.0, 20.0, 18.0], [1, 0.0, 0.0, 27.0, 19.0],
                         [1, 10.0, 3.0, 11.0, 3.5], [0, 9.0, 9.0, 9.0, 9.0]])
    for aligned in (True, False):
        assert torch.autograd.gradcheck(
            lambda f: roi_align_reference(f, rois, (2, 3), 1 / 4, 2,
                                          aligned),
            (feats,), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_the_plain_backward(dtype):
    """On CPU tensors ``roi_align`` differentiates through the plain
    version: the map's gradient has its dtype and shape and, in f32,
    equals the plain backward exactly (in bf16 CPU autograd sums in bf16,
    the plain backward in f32); the RoIs get none; no launch counted."""
    rng = np.random.RandomState(91)
    feats = torch.from_numpy(rng.randn(2, 12, 20, 8).astype(np.float32)
                             ).to(dtype).requires_grad_()
    rois = torch.from_numpy(make_rois(rng, 24, (12, 20), 1 / 4))
    g = torch.from_numpy(rng.randn(24, 14, 14, 8).astype(np.float32))
    before = (dict(roi_align.launches_by_size), dict(grad_launches_by_size))
    roi_align(feats, rois, (14, 14), 1 / 4).backward(g)
    want = roi_align_grad_reference(feats, rois, g, (14, 14), 1 / 4)
    assert feats.grad.dtype == dtype and feats.grad.shape == want.shape
    if dtype == torch.float32:
        assert torch.equal(feats.grad, want)
    assert rois.grad is None
    assert (dict(roi_align.launches_by_size),
            dict(grad_launches_by_size)) == before
