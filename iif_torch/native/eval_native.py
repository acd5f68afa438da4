"""ctypes bindings for the C++ greedy eval matcher (``evalmatch.cpp``):
port of ``iif_tpu/native/eval_native.py``.

Compiled with g++ at first use (``iif_torch/native/build.py``); a missing
compiler or a failed build raises, with no fallback. The pure-Python
matcher ``iif_torch/detection/evaluation.py::_greedy_match_py`` gives the
same matches and stays as the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from iif_torch.native.build import load


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("evalmatch")
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.greedy_match.restype = None
    lib.greedy_match.argtypes = [p_f64, i64, i64, p_u8, p_u8,
                                 p_f64, i64, p_i64]
    lib.greedy_match_batch.restype = None
    lib.greedy_match_batch.argtypes = [
        p_f64, p_i64, p_i64, p_i64, p_i64, p_i64, i64, i64,
        p_u8, p_u8, p_u8, p_f64, i64, p_u8, p_u8]
    return lib


def greedy_match_native(ious: np.ndarray, g_ignore: np.ndarray,
                        iscrowd: np.ndarray,
                        iou_thrs: np.ndarray) -> np.ndarray:
    """(T, D) matched-gt index (-1 = unmatched); gts sorted real-first."""
    D, G = ious.shape
    T = len(iou_thrs)
    out = np.empty((T, D), np.int64)
    _lib().greedy_match(
        np.ascontiguousarray(ious, np.float64), D, G,
        np.ascontiguousarray(g_ignore, np.uint8),
        np.ascontiguousarray(iscrowd, np.uint8),
        np.ascontiguousarray(iou_thrs, np.float64), T, out)
    return out


def greedy_match_batch_native(
    ious_flat: np.ndarray, iou_off: np.ndarray,
    d_cnt: np.ndarray, g_cnt: np.ndarray,
    d_off: np.ndarray, g_off: np.ndarray,
    g_ignore_flat: np.ndarray, iscrowd_flat: np.ndarray,
    dt_unmatched_ignore_flat: np.ndarray,
    iou_thrs: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched greedy match over P (img, cat) pairs in one call: (matched,
    ignored) as (T, N) bool arrays with detection columns in pair order
    (N = total detections). Gts arrive in their original order; each
    pair's stable real-first order is taken in C++."""
    P = len(d_cnt)
    N = int(d_cnt.sum())
    T = len(iou_thrs)
    matched = np.empty((T, N), np.uint8)
    ignored = np.empty((T, N), np.uint8)
    _lib().greedy_match_batch(
        np.ascontiguousarray(ious_flat, np.float64),
        np.ascontiguousarray(iou_off, np.int64),
        np.ascontiguousarray(d_cnt, np.int64),
        np.ascontiguousarray(g_cnt, np.int64),
        np.ascontiguousarray(d_off, np.int64),
        np.ascontiguousarray(g_off, np.int64), P, N,
        np.ascontiguousarray(g_ignore_flat, np.uint8),
        np.ascontiguousarray(iscrowd_flat, np.uint8),
        np.ascontiguousarray(dt_unmatched_ignore_flat, np.uint8),
        np.ascontiguousarray(iou_thrs, np.float64), T, matched, ignored)
    return matched.astype(bool), ignored.astype(bool)
