"""The train branch of ``iif_torch/detection/pipeline.py``
(``DetectionPipeline.sample``) against ``iif_tpu.detection.pipeline.
DetectionPipeline(emit_uint8=True, pack_masks=True, canvas_buckets=True)``
(numpy and cv2, no JAX compile) on the same ``RandomState`` seeds, with
the headline recipe's six scales and canvas scaled down by 4 (three
buckets: 160, 192 and 200 x 336), masks at stride 1 and 2.

Equal: the keys, ``gt_boxes``, ``gt_labels``, ``gt_valid``, ``img_shape``,
``scale_factor``, ``flip``, the canvas (the bucket), and the packed masks
of polygons, RLEs and boxes (the polygon fill is OpenCV's rule,
``tests/test_torch_mask_utils.py``). The image within 1 grey level, up-
and down-scaled (PyTorch's f32 bilinear against cv2's fixed-point
``INTER_LINEAR``)."""
import cv2
import numpy as np
import pytest
import torch

from iif_torch.detection.mask_utils import rle_encode
from iif_torch.detection.pipeline import (
    DetectionPipeline,
    resize_nearest,
)

torch.set_num_threads(1)

SCALES = [(333, 160), (333, 168), (333, 176), (333, 184), (333, 192),
          (333, 200)]
CANVAS = (200, 336)
MAX_GT = 5
# (H0, W0): up-scaled (120x160 goes to 200x267, as 480x640 goes to
# 800x1067 at full size), down-scaled, portrait
SIZES = [(120, 160), (480, 640), (96, 72), (300, 200)]


def _ann(rng, h, w, n):
    """``n`` instances: polygons of 1-3 parts (some past the image
    border), RLEs and missing segmentations (the box)."""
    x1 = rng.uniform(0, w - 6, n)
    y1 = rng.uniform(0, h - 6, n)
    bw = rng.uniform(3, w - x1)
    bh = rng.uniform(3, h - y1)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    segms = []
    for i in range(n):
        if i % 4 == 1:
            m = np.zeros((h, w), np.uint8)
            r0, r1 = int(y1[i]), int(y1[i] + bh[i])
            m[r0:r1, int(x1[i]):int(x1[i] + bw[i])] = 1
            m[r0:int(y1[i] + bh[i] / 2), int(x1[i])] = 0
            segms.append(rle_encode(m))
        elif i % 4 == 3:
            segms.append(None)
        else:
            parts = []
            for _ in range(rng.randint(1, 4)):
                k = rng.randint(3, 9)
                px = rng.uniform(x1[i] - 4, x1[i] + bw[i] + 4, k)
                py = rng.uniform(y1[i] - 4, y1[i] + bh[i] + 4, k)
                parts.append(np.round(np.stack([px, py], 1).ravel(),
                                      2).tolist())
            segms.append(parts)
    return {"boxes": boxes, "labels": rng.randint(0, 9, n).astype(np.int64),
            "segms": segms, "width": w, "height": h}


def _jax_pipeline(stride):
    from iif_tpu.detection.pipeline import DetectionPipeline as JaxPipeline

    return JaxPipeline(canvas=CANVAS, scales=SCALES, max_gt=MAX_GT,
                       mask_stride=stride, canvas_buckets=True,
                       emit_uint8=True, pack_masks=True)


def _check(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k == "image":
            diff = np.abs(got[k].astype(int) - v.astype(int))
            assert diff.max() <= 1
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("stride", [1, 2])
def test_train_sample_matches_jax(stride, seed):
    """Drawn scale and flip; up to 8 instances for 5 slots."""
    rng = np.random.RandomState(100 + seed)
    h, w = SIZES[seed % len(SIZES)]
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ann = _ann(rng, h, w, rng.randint(1, 9))
    want = _jax_pipeline(stride)(img, ann, np.random.RandomState(seed), True)
    got = DetectionPipeline(
        canvas=CANVAS, scales=SCALES, max_gt=MAX_GT, mask_stride=stride,
        canvas_buckets=True).sample(img, ann, np.random.RandomState(seed))
    _check(got, want)


def test_cases_cover_flips_buckets_and_overflow():
    """The seeds above give flipped and unflipped samples, more than one
    bucket and more instances than slots."""
    pipe = DetectionPipeline(canvas=CANVAS, scales=SCALES, max_gt=MAX_GT,
                             canvas_buckets=True, with_mask=False)
    flips, canvases, overflow = set(), set(), False
    for seed in range(8):
        rng = np.random.RandomState(100 + seed)
        h, w = SIZES[seed % len(SIZES)]
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ann = _ann(rng, h, w, rng.randint(1, 9))
        out = pipe.sample(img, ann, np.random.RandomState(seed))
        flips.add(bool(out["flip"]))
        canvases.add(out["image"].shape[:2])
        overflow |= len(ann["boxes"]) > MAX_GT
    assert flips == {False, True} and len(canvases) > 1 and overflow
    assert [c for c, _ in pipe.buckets] == [(160, 336), (192, 336),
                                            (200, 336)]


@pytest.mark.parametrize("scale_idx", range(6))
def test_loader_scale_ids_match_jax(scale_idx):
    """The loader's path: the scale handed in, masks at stride 2, the
    flip from the sample's seed."""
    rng = np.random.RandomState(scale_idx)
    h, w = SIZES[scale_idx % len(SIZES)]
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ann = _ann(rng, h, w, 4)
    want = _jax_pipeline(2)(
        img, ann, np.random.RandomState(7), True, scale_idx=scale_idx)
    got = DetectionPipeline(
        canvas=CANVAS, scales=SCALES, max_gt=MAX_GT, mask_stride=2,
        canvas_buckets=True).sample(img, ann, np.random.RandomState(7),
                                    scale_idx=scale_idx)
    _check(got, want)


@pytest.mark.parametrize("src,dst", [((37, 53), (80, 100)),
                                     ((120, 90), (41, 33)),
                                     ((200, 336), (100, 168)),
                                     ((7, 5), (7, 5)), ((16, 16), (3, 61))])
def test_resize_nearest_matches_cv2(src, dst):
    m = (np.random.RandomState(0).rand(*src) < 0.5).astype(np.uint8)
    want = cv2.resize(m, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(m, *dst), want)


@pytest.mark.parametrize("knob", [
    {"keep_ratio": False}, {"extra_transforms": [{"type": "CutOut"}]},
    {"with_seg": True}, {"max_proposals": 512}])
def test_unported_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="not ported"):
        DetectionPipeline(**knob)


def test_mix_fetch_raises():
    pipe = DetectionPipeline(canvas=CANVAS, scales=SCALES)
    img = np.zeros((40, 40, 3), np.uint8)
    ann = _ann(np.random.RandomState(0), 40, 40, 1)
    with pytest.raises(NotImplementedError, match="mix_fetch"):
        pipe.sample(img, ann, np.random.RandomState(0),
                    mix_fetch=lambda rng, n: [])
