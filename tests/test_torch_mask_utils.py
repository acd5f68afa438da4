"""``iif_torch/detection/mask_utils.py`` against ``iif_tpu.detection.
mask_utils`` (numpy, no JAX compile): the RLE codec, areas and mask IoU
equal; the cv2-free polygon fill equal, pixel for pixel, to the JAX
package's ``cv2.fillPoly`` (``polygons_to_bitmap``, and ``fill_poly``
against ``cv2.fillPoly`` on the integer vertices the stride-2 mask path
hands it) on 300 seeded polygons of each kind: convex, concave,
self-intersecting, 2-point, off the canvas, multi-part; the vectorised
Bresenham against a loop transcription of OpenCV's ``LineIterator``."""
import cv2
import numpy as np
import pytest
import torch

from iif_torch.detection import mask_utils as tm

torch.set_num_threads(1)

KINDS = ("convex", "concave", "self_intersecting", "two_point",
         "off_canvas", "multi_part")


def _star(rng, n, cx, cy, r, convex):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r if convex else r * rng.uniform(0.2, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).ravel()


def _polygons(rng, kind, h, w):
    """One COCO polygon segmentation (a list of float parts)."""
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    r = rng.uniform(2, max(h, w) / 2)
    if kind == "convex":
        return [_star(rng, rng.randint(3, 9), cx, cy, r, True)]
    if kind == "concave":
        return [_star(rng, rng.randint(5, 16), cx, cy, r, False)]
    if kind == "self_intersecting":
        return [rng.uniform(0, [w, h] * 6)]
    if kind == "two_point":
        return [rng.uniform(0, [w, h] * 2)]
    if kind == "off_canvas":
        n = rng.randint(3, 9)
        return [rng.uniform([-0.5 * w, -0.5 * h] * n, [1.5 * w, 1.5 * h] * n)]
    return [_star(rng, rng.randint(3, 10), rng.uniform(-5, w + 5),
                  rng.uniform(-5, h + 5), rng.uniform(2, max(h, w) / 3),
                  rng.rand() < 0.5) for _ in range(rng.randint(2, 4))]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("kind", KINDS)
def test_polygons_to_bitmap_matches_jax(kind, seed):
    """60 polygons a case (300 a kind), at odd canvas sizes: equal."""
    from iif_tpu.detection.mask_utils import polygons_to_bitmap

    rng = np.random.RandomState(1000 * KINDS.index(kind) + seed)
    for _ in range(60):
        h, w = rng.randint(8, 90), rng.randint(8, 90)
        polys = [p.round(2).tolist() for p in _polygons(rng, kind, h, w)]
        want = polygons_to_bitmap(polys, h, w)
        got = tm.polygons_to_bitmap(polys, h, w)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=str(polys))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_fill_poly_matches_cv2_fill_poly(kind, seed):
    """The stride-2 path's call, one part at a time on integer vertices
    from ``np.round(q / 2)``, and every part in one call: equal."""
    rng = np.random.RandomState(7000 + 100 * KINDS.index(kind) + seed)
    for _ in range(40):
        h, w = rng.randint(4, 70), rng.randint(4, 70)
        parts = [np.round(np.asarray(p, np.float32).reshape(-1, 2) / 2)
                 .astype(np.int32)
                 for p in _polygons(rng, kind, 2 * h, 2 * w)]
        for polys in [[p] for p in parts] + [parts]:
            want = np.zeros((h, w), np.uint8)
            cv2.fillPoly(want, polys, 1)
            got = tm.fill_poly(np.zeros((h, w), np.uint8), polys)
            np.testing.assert_array_equal(got, want)


def _line_iterator(x1, y1, x2, y2):
    """OpenCV's ``LineIterator`` (8-connected, left to right) as a loop,
    for end points inside the image."""
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y, out = x1, y1, []
    for _ in range(dx + 1):
        out.append((y, x))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += int(minor)
        else:
            x += 1
            y += sy * int(minor)
    return out


def test_line_pixels_match_loop_bresenham():
    rng = np.random.RandomState(3)
    seg = rng.randint(0, 40, (400, 4))
    ys, xs = tm.line_pixels((40, 40), *seg.T)
    want = [p for s in seg for p in _line_iterator(*s)]
    assert list(zip(ys.tolist(), xs.tolist())) == want


def test_fill_poly_degenerate_inputs():
    """No contour, a single point and a repeated one: as cv2; an empty
    contour raises, as cv2's assertion does."""
    for polys in ([], [np.array([[3, 4]], np.int32)],
                  [np.array([[3, 4], [3, 4], [3, 4]], np.int32)]):
        want = np.zeros((9, 9), np.uint8)
        if polys:
            cv2.fillPoly(want, polys, 1)
        got = tm.fill_poly(np.zeros((9, 9), np.uint8), polys)
        np.testing.assert_array_equal(got, want)
    empty = [np.zeros((0, 2), np.int32)]
    with pytest.raises(cv2.error):
        cv2.fillPoly(np.zeros((9, 9), np.uint8), empty, 1)
    with pytest.raises(ValueError, match="empty contour"):
        tm.fill_poly(np.zeros((9, 9), np.uint8), empty)


def _random_mask(rng, h, w, kind):
    if kind == "empty":
        return np.zeros((h, w), np.uint8)
    if kind == "full":
        return np.ones((h, w), np.uint8)
    if kind == "noise":
        return (rng.rand(h, w) < 0.5).astype(np.uint8)
    coarse = rng.rand(h // 4 + 1, w // 4 + 1) < 0.4
    return np.kron(coarse, np.ones((4, 4)))[:h, :w].astype(np.uint8)


@pytest.mark.parametrize("kind", ["empty", "full", "noise", "blobs"])
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (37, 23), (64, 96)])
def test_rle_round_trip_matches_jax(kind, hw):
    """Compressed strings, raw and compressed decodes, and areas equal."""
    from iif_tpu.detection import mask_utils as jm

    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    m = _random_mask(rng, *hw, kind)
    want = jm.rle_encode(m)
    got = tm.rle_encode(m)
    assert got == want
    np.testing.assert_array_equal(tm.rle_decode(got), m)
    counts = jm._decompress_counts(want["counts"])
    assert tm._decompress_counts(got["counts"]) == counts
    assert tm._compress_counts(counts) == want["counts"]
    raw = {"size": list(hw), "counts": counts}
    np.testing.assert_array_equal(tm.rle_decode(raw), jm.rle_decode(raw))
    assert tm.mask_area(got) == jm.mask_area(want) == int(m.sum())
    np.testing.assert_array_equal(tm.segm_to_bitmap(got, *hw),
                                  jm.segm_to_bitmap(want, *hw))


def test_rle_iou_matches_jax():
    from iif_tpu.detection import mask_utils as jm

    rng = np.random.RandomState(0)
    dt = [tm.rle_encode(_random_mask(rng, 30, 40, "blobs"))
          for _ in range(5)]
    gt = [tm.rle_encode(_random_mask(rng, 30, 40, k))
          for k in ("blobs", "noise", "empty")]
    crowd = [False, True, False]
    np.testing.assert_array_equal(tm.rle_iou(dt, gt, crowd),
                                  jm.rle_iou(dt, gt, crowd))
    assert tm.rle_iou([], gt, crowd).shape == (0, 3)
    with pytest.raises(TypeError):
        tm.segm_to_bitmap("polygon?", 3, 3)
