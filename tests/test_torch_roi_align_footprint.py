"""A NumPy model of the RoIAlign backward kernels' algebra (K2 and K4,
``iif_torch/csrc/roi_align_common.cuh``): each RoI's gradient window as the
separable product dF = Wy^T g Wx over its footprint, the distinct map rows
and columns that its taps touch with a nonzero weight, each with its bins'
summed weights (the 1/s^2 of the mean folded into the rows, a tap clamped
at the last cell giving both weights to it), walked as the kernels walk it:
a row slot at a time, the bins in order, h = Wy g once a bin into a
window of pending columns. Held against the port's plain backwards and
against ``jax.vjp`` of
the JAX package's functions at tiny sizes, on the CPU. The kernels
themselves run only on the card (``tests/test_torch_roi_align*.py``,
``cuda`` marker)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.ops.roi_align import roi_align_grad_reference
from iif_torch.ops.roi_align_ml import (
    map_roi_levels,
    roi_align_ml_grad_reference,
)

torch.set_num_threads(1)

F32 = np.float32
SMALL_LEVELS = [(16, 24), (8, 12), (4, 6), (2, 3)]
WINDOW = 4                         # kWindow: columns of pending sums


def taps(start, extent, out, s, n):
    """``make_tap`` for one axis in f32, in its op order: bin = extent /
    out, pos = (t + 0.5) / s, v = start + bin * pos clamped into [0, n-1],
    lo = floor(v), hi = min(lo + 1, n-1), frac = v - lo."""
    bin_ = F32(extent) / F32(out)
    pos = (np.arange(out * s, dtype=F32) + F32(0.5)) / F32(s)
    v = np.minimum(np.maximum(F32(start) + bin_ * pos, F32(0)), F32(n - 1))
    lo = np.floor(v)
    hi = np.minimum(lo + F32(1), F32(n - 1))
    return lo.astype(np.int64), hi.astype(np.int64), v - lo


def footprint(lo, hi, frac, out, s, scale):
    """The distinct cells with a nonzero weight, in increasing order, and
    each one's weights per bin (slot x out): the tap entries (lo with 1 -
    frac, hi with frac) times ``scale``, summed in tap order."""
    entries = [(cell, t // s, w * F32(scale)) for t in range(lo.size)
               for cell, w in ((lo[t], F32(1) - frac[t]), (hi[t], frac[t]))
               if w != 0]
    cells = sorted({cell for cell, _, _ in entries})
    weights = np.zeros((len(cells), out), F32)
    for cell, b, w in entries:
        weights[cells.index(cell), b] += w
    return np.array(cells, np.int64), weights


def scatter_roi(acc, g, ys, xs):
    """One RoI's window added into ``acc`` (H, W, C) as the kernels walk
    it: a row slot at a time; the bins pw in order, h = sum_ph Wy[k, ph]
    g[ph, pw] once a bin, h times each touched column's weight into a
    window of WINDOW columns of pending sums, flushed as the window moves
    past them; a bin whose columns do not fit adds its own."""
    rows, wy = ys
    cols, wx = xs
    out_w = wx.shape[1]
    for k in range(rows.size):
        ph = np.flatnonzero(wy[k])
        target = rows[k]
        window = np.zeros((WINDOW, g.shape[-1]))
        base = 0

        def flush(c):
            if 0 <= base + c < cols.size:
                acc[target, cols[base + c]] += window[c]
            window[c] = 0

        for pw in range(out_w):
            touched = np.flatnonzero(wx[:, pw])
            j0, j1 = touched.min(), touched.max()
            h = wy[k, ph[0]:ph[-1] + 1] @ g[ph[0]:ph[-1] + 1, pw]
            if j1 - j0 >= WINDOW:
                for j in range(j0, j1 + 1):
                    acc[target, cols[j]] += wx[j, pw] * h
                continue
            if j0 < base:
                for c in range(WINDOW):
                    flush(c)
                base = j1 - (WINDOW - 1)
            while j1 >= base + WINDOW:
                flush(0)
                window = np.roll(window, -1, axis=0)
                base += 1
            for j in range(j0, j1 + 1):
                window[j - base] += wx[j, pw] * h
        for c in range(WINDOW):
            flush(c)


def k4_model(shape, rois, g, out, scale, sr, aligned):
    """K4's algebra: the map's gradient (B, H, W, C), float64 sums."""
    b, h, w, _ = shape
    s = sr if sr > 0 else 2
    off = F32(0.5 if aligned else 0.0)
    acc = np.zeros(shape)
    for roi, g_roi in zip(rois, g):
        x1, y1, x2, y2 = (F32(v) * F32(scale) - off for v in roi[1:])
        roi_w, roi_h = x2 - x1, y2 - y1
        if not aligned:
            roi_w, roi_h = max(roi_w, F32(1)), max(roi_h, F32(1))
        ys = footprint(*taps(y1, roi_h, out[0], s, h), out[0], s,
                       1.0 / (s * s))
        xs = footprint(*taps(x1, roi_w, out[1], s, w), out[1], s, 1.0)
        scatter_roi(acc[min(max(int(roi[0]), 0), b - 1)], g_roi, ys, xs)
    return acc


def k2_model(shapes, rois, g, o, sr):
    """K2's algebra: the four levels' gradients, each RoI at its level
    (``map_roi_levels``), box = roi / stride - 0.5."""
    s = sr if sr > 0 else 2
    accs = [np.zeros(shp) for shp in shapes]
    lvl = map_roi_levels(torch.from_numpy(rois), 4).numpy()
    for roi, g_roi, l in zip(rois, g, lvl):
        _, h, w, _ = shapes[l]
        scale = F32(1.0 / (4 << l))
        x1, y1, x2, y2 = (F32(v) * scale - F32(0.5) for v in roi[1:])
        ys = footprint(*taps(y1, y2 - y1, o, s, h), o, s, 1.0 / (s * s))
        xs = footprint(*taps(x1, x2 - x1, o, s, w), o, s, 1.0)
        scatter_roi(accs[l][int(roi[0])], g_roi, ys, xs)
    return accs


def single_rois(rng, r, map_hw, scale, batch=2):
    """RoIs in image pixels for a (H, W) map at ``scale``: log-uniform
    size and aspect, then the whole map, RoIs on and past its edges,
    wholly outside, sub-cell, zero-size, reversed (x2 < x1, y2 < y1) and a
    pile of identical ones."""
    h, w = map_hw[0] / scale, map_hw[1] / scale
    cell = 1.0 / scale
    c = rng.rand(r, 2) * [w, h]
    size = np.exp(rng.uniform(np.log(0.2 * cell), np.log(min(h, w)), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    boxes = np.stack([c[:, 0] - bw / 2, c[:, 1] - bh / 2,
                      c[:, 0] + bw / 2, c[:, 1] + bh / 2], 1)
    special = [[0.0, 0.0, w, h], [-3 * cell, -2 * cell, 2 * cell, 3 * cell],
               [w - 2 * cell, h - 3 * cell, w + 4 * cell, h + cell],
               [w + cell, h + cell, w + 5 * cell, h + 4 * cell],
               [5.1 * cell, 2.2 * cell, 5.4 * cell, 2.3 * cell],
               [3 * cell, 2 * cell, 3 * cell, 2 * cell],
               [6.5 * cell, 4.5 * cell, 2.5 * cell, 1.5 * cell]]
    special += [[2.2 * cell, 1.4 * cell, 7.7 * cell, 5.1 * cell]] * 4
    boxes[:len(special)] = special
    bidx = rng.randint(0, batch, r)
    return np.concatenate([bidx[:, None], boxes], 1).astype(np.float32)


def ml_rois(rng, r):
    """RoIs on a 64x96 canvas over 2 images, every one of them on the
    finest level (the canvas is below 112 px), and 4 identical ones."""
    c = rng.rand(r, 2) * [96, 64]
    size = np.exp(rng.uniform(np.log(2), np.log(64), r))
    boxes = np.clip(np.stack([c[:, 0] - size / 2, c[:, 1] - size / 3,
                              c[:, 0] + size / 2, c[:, 1] + size / 3], 1),
                    0, [95, 63, 95, 63])
    boxes[:4] = [40.5, 20.25, 70.75, 41.5]
    bidx = rng.randint(0, 2, r)
    return np.concatenate([bidx[:, None], boxes], 1).astype(np.float32)


def test_footprint_of_the_taps():
    """The footprint's cells are the distinct cells with a nonzero weight,
    in increasing order, for increasing and decreasing taps (x2 < x1)
    alike; each bin's weights sum to s (times the scale); a RoI past the
    map's end puts every tap on the last cell (hi == lo), which takes both
    weights."""
    for start, extent in ((2.3, 4.6), (6.9, -4.6)):
        lo, hi, frac = taps(F32(start), F32(extent), 7, 2, 12)
        cells, w = footprint(lo, hi, frac, 7, 2, 0.25)
        dense = np.zeros((12, 7))
        for t in range(14):
            dense[lo[t], t // 2] += 1 - frac[t]
            dense[hi[t], t // 2] += frac[t]
        assert cells.tolist() == np.flatnonzero(dense.any(1)).tolist()
        np.testing.assert_allclose(w, dense[cells] * 0.25, rtol=1e-6)
        np.testing.assert_allclose(w.sum(0), 0.5, rtol=1e-6)
    lo, hi, frac = taps(F32(13.0), F32(3.0), 7, 2, 12)
    assert (lo == 11).all() and (hi == 11).all() and (frac == 0).all()
    cells, w = footprint(lo, hi, frac, 7, 2, 0.25)
    assert cells.tolist() == [11]
    np.testing.assert_array_equal(w, [[0.5] * 7])


@pytest.mark.parametrize("out,sr,aligned", [((14, 14), 0, True),
                                            ((7, 7), 1, False),
                                            ((5, 9), 3, True),
                                            ((7, 7), 4, False)])
def test_k4_model_matches_plain_backward(out, sr, aligned):
    """K4's algebra against ``roi_align_grad_reference`` on a 12x20 map at
    1/4: within 1e-5 of the largest gradient (the kernel's own tolerance;
    the two sum in other orders)."""
    rng = np.random.RandomState(sr + out[1])
    rois = single_rois(rng, 40, (12, 20), 1 / 4)
    g = rng.randn(rois.shape[0], *out, 4).astype(F32)
    want = roi_align_grad_reference(
        torch.zeros(2, 12, 20, 4), torch.from_numpy(rois),
        torch.from_numpy(g), out, 1 / 4, sr, aligned).numpy()
    got = k4_model((2, 12, 20, 4), rois, g, out, 1 / 4, sr, aligned)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("o,sr", [(7, 0), (14, 0), (7, 1)])
def test_k2_model_matches_plain_backward(o, sr):
    """K2's algebra against ``roi_align_ml_grad_reference``: within 1e-5
    of the largest gradient."""
    rng = np.random.RandomState(o + sr)
    rois = ml_rois(rng, 24)
    g = rng.randn(rois.shape[0], o, o, 4).astype(F32)
    shapes = [(2, h, w, 4) for h, w in SMALL_LEVELS]
    want = roi_align_ml_grad_reference(
        [torch.zeros(shp) for shp in shapes], torch.from_numpy(rois),
        torch.from_numpy(g), (o, o), sampling_ratio=sr)
    got = k2_model(shapes, rois, g, o, sr)
    scale = max(np.abs(x.numpy()).max() for x in want)
    for a, b in zip(got, want):
        assert np.abs(a - b.numpy()).max() <= 1e-5 * scale


def test_k4_model_matches_jax_vjp():
    """K4's algebra against ``jax.vjp`` of the JAX package's
    ``iif_tpu.ops.roi_align.roi_align`` (14x14, s=2, aligned, 1/4): atol
    3e-5, as the plain backward's test holds it (XLA rewrites the sample
    positions by an ulp)."""
    from iif_tpu.ops.roi_align import roi_align as jax_roi_align

    rng = np.random.RandomState(7)
    rois = single_rois(rng, 24, (12, 20), 1 / 4)
    g = rng.randn(rois.shape[0], 14, 14, 4).astype(F32)
    @jax.jit
    def grad(x, rr, gg):
        _, vjp = jax.vjp(lambda f: jax_roi_align(f, rr, (14, 14), 1 / 4, 0,
                                                 True), x)
        return vjp(gg)[0]

    want = np.asarray(grad(jnp.zeros((2, 12, 20, 4), jnp.float32),
                           jnp.asarray(rois), jnp.asarray(g)))
    got = k4_model((2, 12, 20, 4), rois, g, (14, 14), 1 / 4, 0, True)
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_k2_model_matches_jax_vjp():
    """K2's algebra against ``jax.vjp`` of the JAX package's
    ``SingleRoIExtractor(use_pallas="ml")`` (7x7, s=2): atol 3e-5, as the
    plain backward's test holds it."""
    from iif_tpu.detection.roi_extractor import SingleRoIExtractor as JaxExt

    rng = np.random.RandomState(8)
    rois = ml_rois(rng, 16)
    g = rng.randn(rois.shape[0], 7, 7, 4).astype(F32)
    shapes = [(2, h, w, 4) for h, w in SMALL_LEVELS]
    ext = JaxExt((7, 7), use_pallas="ml")

    @jax.jit
    def grad(fs, rr, gg):
        _, vjp = jax.vjp(lambda x: ext(list(x), rr), fs)
        return vjp(gg)[0]

    want = grad(tuple(jnp.zeros(shp, jnp.float32) for shp in shapes),
                jnp.asarray(rois), jnp.asarray(g))
    for a, b in zip(k2_model(shapes, rois, g, 7, 0), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5)
