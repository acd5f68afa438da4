"""The port's host C++ for evaluation (``iif_torch/native``): the greedy
matcher against the plain Python one, the RLE codec (encoder from
row- and column-major masks, areas) and the run-intersection IoU against the
NumPy ``mask_utils`` and against the JAX package's ``iif_tpu/native`` on
the same seeded inputs, all equal; the
libraries build under ``build/iif_torch_native/`` and a failed build
raises."""
import numpy as np
import pytest

from iif_torch.detection import evaluation
from iif_torch.detection.mask_utils import (
    mask_area,
    rle_decode,
    rle_encode,
    rle_iou,
)
from iif_torch.native import build, eval_native, rle_native
from iif_tpu.native import rle_native as jax_rle_native

THRS = np.linspace(0.5, 0.95, 10)


def _masks(rng, n, h, w):
    """``n`` masks: rectangles, noise, empty and full, first pixel set."""
    out = []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h), rng.randint(0, w)
            m[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = 1
        elif kind == 1:
            m = (rng.rand(h, w) < 0.4).astype(np.uint8)
        elif kind == 2:
            m = np.zeros((h, w), np.uint8)
        elif kind == 3:
            m = np.ones((h, w), np.uint8)
        else:
            m = (rng.rand(h, w) < 0.2).astype(np.uint8)
            m[0, 0] = 1
        out.append(m)
    return out


@pytest.mark.parametrize("hw", [(1, 1), (7, 5), (37, 53), (120, 96)])
def test_rle_codec_equals_numpy_and_jax(hw):
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    for m in _masks(rng, 10, *hw):
        got = rle_native.rle_encode_native(m)
        assert got == rle_encode(m) == jax_rle_native.rle_encode_native(m)
        assert rle_native.rle_encode_native(m.astype(bool)) == got
        # column-major masks (the transposed read-back) are read in place
        assert rle_native.rle_encode_native(np.asfortranarray(m)) == got
        assert rle_native.rle_encode_native(
            np.ascontiguousarray(m.T.astype(bool)).T) == got
        assert rle_native.rle_area_native(got) == mask_area(got) == m.sum()
        assert np.array_equal(rle_native.rle_decode_native(got), m)
        assert np.array_equal(rle_decode(got), m)
        raw = {"size": list(hw), "counts": [int(c) for c in np.diff(
            np.flatnonzero(np.diff(np.concatenate(
                [[-1], m.ravel(order="F"), [-1]])) != 0))]}
        if m.ravel(order="F")[0] == 1:
            raw["counts"] = [0] + raw["counts"]
        assert np.array_equal(rle_native.rle_decode_native(raw), m)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_iou_equals_numpy_and_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = 40, 56
    dt = [rle_encode(m) for m in _masks(rng, 9, h, w)]
    gt = [rle_encode(m) for m in _masks(rng, 6, h, w)]
    crowd = [bool(c) for c in rng.rand(6) < 0.4]
    got = rle_native.rle_iou_native(dt, gt, crowd)
    assert got.dtype == np.float64 and got.shape == (9, 6)
    assert np.array_equal(got, rle_iou(dt, gt, crowd))
    assert np.array_equal(got, jax_rle_native.rle_iou_native(dt, gt, crowd))
    assert rle_native.rle_iou_native([], gt, crowd).shape == (0, 6)
    assert rle_native.rle_iou_native(dt, [], []).shape == (9, 0)


def _match_case(rng, d, g):
    ious = rng.rand(d, g) * rng.choice([0.6, 1.0])
    ious[rng.rand(d, g) < 0.2] = 0.75        # ties, at a threshold too
    g_ignore = np.sort(rng.rand(g) < 0.3)    # real gts first
    iscrowd = g_ignore & (rng.rand(g) < 0.5)
    return ious, g_ignore, iscrowd


@pytest.mark.parametrize("dg", [(0, 0), (0, 3), (4, 0), (1, 1), (7, 5),
                                (30, 12)])
def test_greedy_match_equals_python(dg):
    rng = np.random.RandomState(dg[0] * 31 + dg[1])
    for _ in range(5):
        ious, g_ignore, iscrowd = _match_case(rng, *dg)
        got = eval_native.greedy_match_native(ious, g_ignore, iscrowd, THRS)
        want = evaluation._greedy_match_py(ious, g_ignore, iscrowd, THRS)
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_greedy_match_batch_equals_per_pair_python():
    """Gts in their original order (the batch reorders real-first per
    pair, stably): the flags of every pair equal the per-pair Python
    matcher's after the stable sort."""
    rng = np.random.RandomState(7)
    sizes = [(3, 2), (0, 4), (5, 0), (8, 6), (1, 1), (12, 3)]
    ious, g_ign, crowd, uig = [], [], [], []
    for d, g in sizes:
        iou, gi, cr = _match_case(rng, d, g)
        perm = rng.permutation(g)
        ious.append(iou[:, perm])
        g_ign.append(gi[perm])
        crowd.append(cr[perm])
        uig.append(rng.rand(d) < 0.3)
    d_cnt = np.array([d for d, _ in sizes], np.int64)
    g_cnt = np.array([g for _, g in sizes], np.int64)
    off = lambda c: np.concatenate([[0], np.cumsum(c)[:-1]]).astype(np.int64)
    matched, ignored = eval_native.greedy_match_batch_native(
        np.concatenate([i.ravel() for i in ious]), off(d_cnt * g_cnt),
        d_cnt, g_cnt, off(d_cnt), off(g_cnt), np.concatenate(g_ign),
        np.concatenate(crowd), np.concatenate(uig), THRS)
    cols = 0
    for p, (d, _) in enumerate(sizes):
        order = np.argsort(g_ign[p], kind="stable")
        best = evaluation._greedy_match_py(ious[p][:, order],
                                           g_ign[p][order],
                                           crowd[p][order], THRS)
        m, ig = evaluation._flags_from_match(best, g_ign[p][order], uig[p])
        assert np.array_equal(matched[:, cols:cols + d], m)
        assert np.array_equal(ignored[:, cols:cols + d], ig)
        cols += d
    assert cols == matched.shape[1]


def test_libraries_build_under_build_dir():
    for name in ("rle", "evalmatch"):
        path = build.build(name)
        assert path.parent == build.REPO_ROOT / "build" / "iif_torch_native"
        assert path.is_file() and path.name.startswith(f"lib{name}-")
    assert build.SRC_DIR == build.REPO_ROOT / "iif_torch" / "native"


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No g++ on PATH and nothing built: the first call raises; nothing
    falls back to Python."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    rle_native._lib.cache_clear()
    eval_native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            rle_native.rle_encode_native(np.ones((2, 2), np.uint8))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            eval_native.greedy_match_native(
                np.ones((1, 1)), np.zeros(1, bool), np.zeros(1, bool), THRS)
    finally:
        rle_native._lib.cache_clear()
        eval_native._lib.cache_clear()
    assert not (tmp_path / "native").exists() or not list(
        (tmp_path / "native").glob("*.so"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "rle.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError,
                       match=r"(?s)g\+\+ failed for rle\.cpp:\n.*error"):
        build.load("rle")
    assert not list((tmp_path / "out").glob("*.so"))
