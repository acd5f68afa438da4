"""ctypes bindings for the C++ RLE codec (``rle.cpp``): port of
``iif_tpu/native/rle_native.py``.

Compiled with g++ at first use (``iif_torch/native/build.py``); a missing
compiler or a failed build raises, with no fallback. The NumPy codec and
IoU in ``iif_torch/detection/mask_utils.py`` give the same results and
stay as the plain versions the tests hold these against. The
run-intersection IoU never decodes masks: O(runs) instead of O(pixels).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import numpy as np

from iif_torch.native.build import load


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("rle")
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rle_decompress_counts.restype = i64
    lib.rle_decompress_counts.argtypes = [ctypes.c_char_p, i64, p_i64, i64]
    lib.rle_compress_counts.restype = i64
    lib.rle_compress_counts.argtypes = [p_i64, i64, ctypes.c_char_p, i64]
    lib.rle_encode_mask_colmajor.restype = i64
    lib.rle_encode_mask_colmajor.argtypes = [p_u8, i64, i64, p_i64, i64]
    lib.rle_decode_mask.restype = None
    lib.rle_decode_mask.argtypes = [p_i64, i64, i64, i64, p_u8]
    lib.rle_area.restype = i64
    lib.rle_area.argtypes = [p_i64, i64]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [p_i64, p_i64, p_i64, i64,
                                   p_i64, p_i64, p_i64, i64, p_u8, p_f64]
    return lib


def _counts_of(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        s = counts.encode("ascii") if isinstance(counts, str) else counts
        buf = np.empty(len(s) + 2, np.int64)
        n = _lib().rle_decompress_counts(s, len(s), buf, buf.size)
        if n < 0:
            raise ValueError("RLE counts overflow")
        return buf[:n]
    return np.asarray(counts, np.int64)


def rle_encode_native(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> compressed RLE dict, equal to
    ``mask_utils.rle_encode``. The mask is read column-major, the order
    the runs run in: a Fortran-ordered mask (the read-back) is not
    copied."""
    lib = _lib()
    h, w = mask.shape
    if mask.dtype == np.bool_:
        mask = mask.view(np.uint8)
    cols = np.ascontiguousarray(np.asfortranarray(mask).T, np.uint8)
    counts = np.empty(h * w + 2, np.int64)
    n = lib.rle_encode_mask_colmajor(cols, h, w, counts, counts.size)
    if n < 0:
        raise ValueError("RLE counts overflow")
    out = ctypes.create_string_buffer(int(6 * n + 16))
    m2 = lib.rle_compress_counts(counts[:n].copy(), n, out, len(out))
    if m2 < 0:
        raise ValueError("RLE compress overflow")
    return {"size": [h, w], "counts": out.raw[:m2].decode("ascii")}


def rle_decode_native(rle: Dict) -> np.ndarray:
    """RLE dict (compressed or raw counts) -> binary (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = np.ascontiguousarray(_counts_of(rle))
    mask = np.empty((h, w), np.uint8)
    _lib().rle_decode_mask(counts, len(counts), h, w, mask)
    return mask


def rle_area_native(rle: Dict) -> int:
    """Pixels of an RLE (the sum of its 1-runs), equal to
    ``mask_utils.mask_area``."""
    counts = np.ascontiguousarray(_counts_of(rle))
    return int(_lib().rle_area(counts, len(counts)))


def rle_iou_native(dt: Sequence[Dict], gt: Sequence[Dict],
                   iscrowd: Sequence[bool]) -> np.ndarray:
    """(D, G) mask IoU (IoF for crowd gts), equal to
    ``mask_utils.rle_iou``."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))

    def _flatten(rles):
        counts = [np.ascontiguousarray(_counts_of(r)) for r in rles]
        lens = np.asarray([len(c) for c in counts], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64)
        flat = np.concatenate(counts).astype(np.int64)
        return np.ascontiguousarray(flat), offsets, lens

    d_flat, d_off, d_len = _flatten(dt)
    g_flat, g_off, g_len = _flatten(gt)
    crowd = np.asarray(iscrowd, np.uint8)
    out = np.zeros((len(dt), len(gt)), np.float64)
    _lib().rle_iou_matrix(d_flat, d_off, d_len, len(dt),
                          g_flat, g_off, g_len, len(gt), crowd, out)
    return out
