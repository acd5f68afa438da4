"""Mask encodings: port of ``iif_tpu/detection/mask_utils.py`` (the COCO
RLE codec, polygon rasterisation, areas and mask IoU), without cv2.

- uncompressed RLE: ``{"counts": [int, ...], "size": [h, w]}``;
- compressed RLE: ``{"counts": str, ...}``, COCO's LEB128-style base-48
  varint string (byte-compatible with pycocotools);
- polygons: ``[[x1, y1, x2, y2, ...], ...]``.

The JAX package fills polygons with ``cv2.fillPoly``; the card's machine
has no cv2, so ``fill_poly`` is a NumPy transcription of OpenCV's rule
for integer vertices (``shift=0``, ``LINE_8``; ``drawing.cpp``:
``CollectPolyEdges``, ``FillEdgeCollection``, ``LineIterator``,
``clipLine``):

- every edge's outline is drawn as an 8-connected Bresenham line between
  its integer end points, left to right, clipped to the image;
- every non-horizontal edge becomes a 16-bit fixed-point edge from its
  end points' x (for an edge that leaves the image, its clipped end
  points' x, and their y where those differ) with a slope truncated
  toward zero;
- each scanline fills, inclusively, between consecutive pairs of the
  active edges' x sorted, the left end rounded up and the right one down
  (even-odd over every contour of one call).

It runs once a call, vectorised over edges and scanlines.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> compressed RLE dict (column-major order,
    matching COCO)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).ravel(order="F")
    # run lengths, starting with a (possibly zero-length) run of 0s
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(starts).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w], "counts": _compress_counts(counts)}


def rle_decode(rle: Dict) -> np.ndarray:
    """RLE dict (compressed or raw counts) -> binary (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decompress_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def _compress_counts(counts: Sequence[int]) -> str:
    """COCO's variable-length delta encoding (pycocotools rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and \
                not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _decompress_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


# ------------------------------------------------------------ rasterising
def _outcode(x, y, right, bottom):
    return ((x < 0) + (x > right) * 2 + (y < 0) * 4
            + (y > bottom) * 8).astype(np.int64)


def _trunc_mul_div(a, b, c):
    """``(int64)((double)a * b / c)`` elementwise (C truncation)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        q = np.trunc(a.astype(np.float64) * b / c)
    return np.where(np.isfinite(q), q, 0).astype(np.int64)


def clip_lines(size: Tuple[int, int], x1, y1, x2, y2):
    """OpenCV's ``clipLine`` on int64 arrays of segments in an image of
    ``size`` = (h, w): the end points after its clipping steps, in its
    order (the second end point's steps see the first's result), and
    whether each segment ends inside the image."""
    h, w = size
    right, bottom = w - 1, h - 1
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))
    c1, c2 = _outcode(x1, y1, right, bottom), _outcode(x2, y2, right, bottom)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + _trunc_mul_div(a - y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, _outcode(x1, 0, right, bottom), c1)
    m = todo & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + _trunc_mul_div(a - y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, _outcode(x2, 0, right, bottom), c2)
    todo &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + _trunc_mul_div(a - x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = todo & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + _trunc_mul_div(a - x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def line_pixels(size: Tuple[int, int], x1, y1, x2, y2
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of every pixel OpenCV's 8-connected ``LineIterator``
    (left to right) visits on each segment, clipped to ``size``."""
    h, w = size
    x1, y1, x2, y2 = (np.asarray(v, np.int64) for v in (x1, y1, x2, y2))
    out = ((x1 < 0) | (x1 >= w) | (y1 < 0) | (y1 >= h)
           | (x2 < 0) | (x2 >= w) | (y2 < 0) | (y2 >= h))
    cx1, cy1, cx2, cy2, inside = clip_lines(size, x1, y1, x2, y2)
    x1, y1 = np.where(out, cx1, x1), np.where(out, cy1, y1)
    x2, y2 = np.where(out, cx2, x2), np.where(out, cy2, y2)
    keep = ~out | inside
    x1, y1, x2, y2 = x1[keep], y1[keep], x2[keep], y2[keep]
    swap = x2 < x1                                   # left to right
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major, minor = np.maximum(dx, dy), np.minimum(dx, dy)
    n = major + 1
    seg = np.repeat(np.arange(len(n)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    big, small = major[seg], minor[seg]
    # minor steps after k major ones: the smallest m with
    # 2*major*m >= 2*minor*k - major (Bresenham's err = dx - 2dy start)
    m = np.where(big > 0,
                 -((big - 2 * small * k) // np.maximum(2 * big, 1)), 0)
    v = vert[seg]
    xs = x1[seg] + np.where(v, m, k)
    ys = y1[seg] + np.where(v, k, m) * sy[seg]
    return ys, xs


def fill_poly(mask: np.ndarray, polys: Sequence[np.ndarray],
              value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, value)`` for int32 (N, 2) vertex arrays
    (``shift=0``, ``LINE_8``), in place; returns ``mask``."""
    h, w = mask.shape[:2]
    polys = [np.asarray(p, np.int64).reshape(-1, 2) for p in polys]
    if not all(len(p) for p in polys):
        raise ValueError("fill_poly: an empty contour (cv2.fillPoly's "
                         "assertion)")
    if not polys:
        return mask
    v1 = np.concatenate(polys)
    v0 = np.concatenate([np.roll(p, 1, axis=0) for p in polys])
    x0, y0, x1, y1 = v0[:, 0], v0[:, 1], v1[:, 0], v1[:, 1]
    ys, xs = line_pixels((h, w), x0, y0, x1, y1)
    mask[ys, xs] = value

    # the fill's edges, 16-bit fixed point
    out = ((x0 < 0) | (x0 >= w) | (y0 < 0) | (y0 >= h)
           | (x1 < 0) | (x1 >= w) | (y1 < 0) | (y1 >= h))
    cx0, cy0, cx1, cy1, _ = clip_lines((h, w), x0, y0, x1, y1)
    moved = out & (cy0 != cy1)
    p0x = np.where(out, cx0, x0) << XY_SHIFT
    p1x = np.where(out, cx1, x1) << XY_SHIFT
    p0y = np.where(moved, cy0, y0)
    p1y = np.where(moved, cy1, y1)
    e = y0 != y1
    if e.sum() < 2:
        return mask
    p0x, p1x, p0y, p1y = p0x[e], p1x[e], p0y[e], p1y[e]
    y0, y1 = y0[e], y1[e]
    num, den = p1x - p0x, p1y - p0y
    dx = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))
    down = y0 < y1
    ey0 = np.where(down, y0, y1)
    ey1 = np.where(down, y1, y0)
    ex = np.where(down, p0x + (y0 - p0y) * dx, p1x + (y1 - p1y) * dx)

    rows = np.arange(max(ey0.min(), 0), min(ey1.max(), h))
    if not len(rows):
        return mask
    active = (ey0[None] <= rows[:, None]) & (rows[:, None] < ey1[None])
    xs = ex[None] + (rows[:, None] - ey0[None]) * dx[None]
    xs = np.sort(np.where(active, xs, np.iinfo(np.int64).max), axis=1)
    pairs = active.sum(1) // 2
    k = np.arange(xs.shape[1] // 2)
    lo = (xs[:, 0:2 * len(k):2] + XY_ONE - 1) >> XY_SHIFT
    hi = xs[:, 1:2 * len(k):2] >> XY_SHIFT
    ok = (k[None] < pairs[:, None]) & (lo < w) & (hi >= 0) & (lo <= hi)
    r = np.broadcast_to(np.arange(len(rows))[:, None], ok.shape)[ok]
    if not r.size:
        return mask
    lo, hi = np.maximum(lo[ok], 0), np.minimum(hi[ok], w - 1)
    c0, c1 = lo.min(), hi.max() + 1
    marks = np.zeros((len(rows), c1 - c0 + 1), np.int32)
    np.add.at(marks, (r, lo - c0), 1)
    np.add.at(marks, (r, hi + 1 - c0), -1)
    fill = np.cumsum(marks[:, :-1], axis=1) > 0
    mask[rows[0]:rows[-1] + 1, c0:c1][fill] = value
    return mask


def polygons_to_bitmap(polygons: Sequence[Sequence[float]], h: int, w: int
                       ) -> np.ndarray:
    """Rasterize COCO polygon segmentation to a binary (H, W) mask."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def segm_to_bitmap(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygons / RLE / raw counts) -> bitmap."""
    if isinstance(segm, list):
        return polygons_to_bitmap(segm, h, w)
    if isinstance(segm, dict):
        return rle_decode(segm)
    raise TypeError(f"unsupported segmentation type {type(segm)}")


def mask_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decompress_counts(counts)
    return int(sum(counts[1::2]))


def rle_iou(dt: Sequence[Dict], gt: Sequence[Dict],
            iscrowd: Sequence[bool]) -> np.ndarray:
    """Pairwise mask IoU matrix (D, G): decode + bitwise ops."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))
    d_masks = [rle_decode(d).astype(bool) for d in dt]
    g_masks = [rle_decode(g).astype(bool) for g in gt]
    out = np.zeros((len(dt), len(gt)))
    d_areas = [m.sum() for m in d_masks]
    g_areas = [m.sum() for m in g_masks]
    for j, gm in enumerate(g_masks):
        for i, dm in enumerate(d_masks):
            inter = np.logical_and(dm, gm).sum()
            if iscrowd[j]:
                union = d_areas[i]
            else:
                union = d_areas[i] + g_areas[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
