"""``iif_torch/detection/evaluation.py`` and ``voc_eval.py`` against the
JAX package's on the same seeded inputs: every AP dict equal bit for bit
(NaN equal to NaN), in bbox and segm, under the COCO and the LVIS
protocol, with crowd gts, areas on the area ranges' edges, not-exhaustive
images, negative category ids, ``max_dets`` truncation, empty
categories, ``frequency`` against ``image_count`` buckets and
``mask_score``; the plain Python matcher and NumPy IoU (``native=
False``) equal to the C++ ones; ``error_analysis`` and
``detections_to_coco_results`` equal; VOC ``eval_map`` and
``eval_recalls`` equal."""
import copy
import math

import numpy as np
import pytest
import torch

from iif_torch.detection import evaluation, voc_eval
from iif_torch.detection.mask_utils import rle_encode
from iif_tpu.detection import evaluation as jax_evaluation
from iif_tpu.detection import voc_eval as jax_voc_eval

torch.set_num_threads(1)

H, W = 60, 80
CATS = [1, 2, 3, 4, 5, 6, 7]       # 6: dets only; 7: neither gts nor dets


def _box_mask(box):
    x, y, w, h = box
    m = np.zeros((H, W), np.uint8)
    m[int(y):int(math.ceil(y + h)), int(x):int(math.ceil(x + w))] = 1
    return m


def _data(seed):
    """Images, gt annotations and detections on a 60x80 frame."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for iid in range(6):
        images.append({"id": iid, "width": W, "height": H,
                       "neg_category_ids": [],
                       "not_exhaustive_category_ids": []})
        for cat in CATS[:5]:
            for _ in range(rng.randint(0, 4)):
                w, h = rng.uniform(4, 40), rng.uniform(4, 30)
                box = [rng.uniform(0, W - w), rng.uniform(0, H - h), w, h]
                a = {"id": len(anns) + 1, "image_id": iid,
                     "category_id": cat, "bbox": box,
                     "area": float(w * h),
                     "iscrowd": int(rng.rand() < 0.12)}
                if rng.rand() < 0.3:       # exactly on an area-range edge
                    a["area"] = rng.choice([32.0 ** 2, 96.0 ** 2, 16.0])
                if rng.rand() < 0.5:
                    a["segmentation"] = rle_encode(_box_mask(box))
                else:
                    x, y = box[0], box[1]
                    a["segmentation"] = [[x, y, x + w, y, x + w, y + h,
                                          x + w / 2, y + h * 0.8]]
                anns.append(a)
    for a in anns:
        for _ in range(rng.randint(0, 3)):     # jittered hits
            x, y, w, h = (np.asarray(a["bbox"])
                          + rng.normal(0, 2.0, 4) * [1, 1, 0.5, 0.5])
            w, h = max(w, 1.0), max(h, 1.0)
            dets.append({"image_id": a["image_id"],
                         "category_id": a["category_id"],
                         "bbox": [float(x), float(y), float(w), float(h)]})
    for _ in range(60):                        # background
        w, h = rng.uniform(2, 50), rng.uniform(2, 40)
        dets.append({"image_id": int(rng.randint(6)),
                     "category_id": int(rng.choice(CATS[:6])),
                     "bbox": [float(rng.uniform(0, W - w)),
                              float(rng.uniform(0, H - h)), float(w),
                              float(h)]})
    dets.append({"image_id": 0, "category_id": 1,      # 32 x 32: edge
                 "bbox": [3.0, 3.0, 32.0, 32.0]})
    for d in dets:
        d["score"] = float(np.round(rng.rand(), 2))    # ties
        d["mask_score"] = float(rng.rand())
        m = _box_mask(d["bbox"])
        d["segmentation"] = rle_encode(m)
        d["area"] = int(m.sum())
    # LVIS per-image ids: a negative category (absent there) and a
    # not-exhaustive one (present)
    for im in images:
        own = sorted({a["category_id"] for a in anns
                      if a["image_id"] == im["id"]})
        im["neg_category_ids"] = [c for c in CATS[:6] if c not in own][:2]
        im["not_exhaustive_category_ids"] = own[:1]
    return images, anns, dets


CASES = {
    "coco": dict(lvis=False),
    "lvis_counts": dict(lvis=True, cat_image_counts={
        1: 3, 2: 10, 3: 11, 4: 100, 5: 101, 6: 5000, 7: 0}),
    "lvis_frequency": dict(lvis=True, cat_image_counts={
        1: 3, 2: 10, 3: 11, 4: 100, 5: 101, 6: 5000, 7: 0},
        cat_frequency={1: "f", 2: "c", 3: None, 4: "r", 5: None, 6: "c",
                       7: "r"}),
    "coco_max_dets": dict(lvis=False, max_dets=2),
    "lvis_max_dets": dict(lvis=True, max_dets=2),
}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] == b[k]) or (math.isnan(a[k]) and math.isnan(b[k])), \
            (k, a[k], b[k])


@pytest.mark.parametrize("mask_score", [False, True])
@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_equals_jax(case, iou_type, mask_score):
    images, anns, dets = _data(3)
    if not mask_score:
        dets = [{k: v for k, v in d.items() if k != "mask_score"}
                for d in dets]
    kw = CASES[case]
    ours = evaluation.DetEvaluator(copy.deepcopy(images),
                                   copy.deepcopy(anns), CATS, **kw)
    plain = evaluation.DetEvaluator(copy.deepcopy(images),
                                    copy.deepcopy(anns), CATS, native=False,
                                    **kw)
    theirs = jax_evaluation.DetEvaluator(copy.deepcopy(images),
                                         copy.deepcopy(anns), CATS, **kw)
    got = ours.evaluate(copy.deepcopy(dets), iou_type)
    _same(got, theirs.evaluate(copy.deepcopy(dets), iou_type))
    _same(got, plain.evaluate(copy.deepcopy(dets), iou_type))
    assert 0.0 < got["AP"] < 1.0
    if kw["lvis"]:
        assert {"APr", "APc", "APf"} <= got.keys()


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("lvis", [False, True])
def test_error_analysis_equals_jax(lvis, iou_type):
    images, anns, dets = _data(4)
    ours = evaluation.DetEvaluator(copy.deepcopy(images),
                                   copy.deepcopy(anns), CATS, lvis=lvis)
    plain = evaluation.DetEvaluator(copy.deepcopy(images),
                                    copy.deepcopy(anns), CATS, lvis=lvis,
                                    native=False)
    theirs = jax_evaluation.DetEvaluator(copy.deepcopy(images),
                                         copy.deepcopy(anns), CATS,
                                         lvis=lvis)
    got = ours.error_analysis(copy.deepcopy(dets), iou_type)
    for other in (theirs.error_analysis(copy.deepcopy(dets), iou_type),
                  plain.error_analysis(copy.deepcopy(dets), iou_type)):
        _same(got["mean"], other["mean"])
        assert got["per_category"].keys() == other["per_category"].keys()
        for cat in got["per_category"]:
            _same(got["per_category"][cat], other["per_category"][cat])


def test_ground_truth_as_detections_scores_one():
    """Every non-crowd gt returned as a detection (score 1, its own
    mask): AP 1 in bbox and segm, COCO and LVIS."""
    images, anns, _ = _data(5)
    for lvis in (False, True):
        ev = evaluation.DetEvaluator(images, copy.deepcopy(anns), CATS,
                                     lvis=lvis)
        ev._gt_segms_to_rle()
        gts = [a for v in ev.gt_by_img_cat.values() for a in v]
        dets = [{"image_id": a["image_id"], "category_id": a["category_id"],
                 "bbox": a["bbox"], "score": 1.0,
                 "segmentation": a["segmentation"]}
                for a in gts if not a["iscrowd"]]
        for iou_type in ("bbox", "segm"):
            assert ev.evaluate(dets, iou_type)["AP"] == 1.0


@pytest.mark.parametrize("with_masks", [False, True])
def test_detections_to_coco_results_equals_jax(with_masks):
    rng = np.random.RandomState(6)
    b, k = 3, 7
    boxes = (rng.rand(b, k, 4) * 50).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    scores = rng.rand(b, k).astype(np.float32)
    labels = rng.randint(0, 3, (b, k))
    valid = rng.rand(b, k) < 0.6
    ids = np.array([4, -1, 9])
    masks = mask_scores = None
    if with_masks:
        masks = [[rle_encode((rng.rand(H, W) < 0.3).astype(np.uint8))
                  for _ in range(k)] for _ in range(b)]
        mask_scores = rng.rand(b, k).astype(np.float32)
    args = (ids, boxes, scores, labels, valid, [2, 5, 8])
    got = evaluation.detections_to_coco_results(
        *args, masks=masks, mask_scores=mask_scores)
    want = jax_evaluation.detections_to_coco_results(
        *args, masks=masks, mask_scores=mask_scores)
    assert got == want and len(got) == valid[[0, 2]].sum()


def _voc_inputs(seed):
    rng = np.random.RandomState(seed)
    dets, annots = [], []
    for _ in range(5):
        n = rng.randint(0, 6)
        gt = rng.rand(n, 4) * 40
        gt[:, 2:] += gt[:, :2] + 2
        ig = rng.rand(rng.randint(0, 3), 4) * 40
        ig[:, 2:] += ig[:, :2] + 2
        annots.append({"bboxes": gt.astype(np.float32),
                       "labels": rng.randint(0, 3, n),
                       "bboxes_ignore": ig.astype(np.float32),
                       "labels_ignore": rng.randint(0, 3, len(ig))})
        per_cls = []
        for c in range(3):
            d = np.concatenate([gt[annots[-1]["labels"] == c]
                                + rng.normal(0, 1, (1, 4)),
                                rng.rand(rng.randint(0, 4), 4) * 40])
            per_cls.append(np.concatenate(
                [d, rng.rand(len(d), 1)], 1).astype(np.float32))
        dets.append(per_cls)
    return dets, annots


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_eval_map_equals_jax(mode):
    dets, annots = _voc_inputs(8)
    m, per = voc_eval.eval_map(dets, annots, 0.5, mode)
    m2, per2 = jax_voc_eval.eval_map(dets, annots, 0.5, mode)
    assert m == m2 and 0.0 < m < 1.0
    assert len(per) == len(per2)
    for a, b in zip(per, per2):
        assert a.keys() == b.keys() and all(a[k] == b[k] for k in a)


def test_eval_recalls_equals_jax():
    dets, annots = _voc_inputs(9)
    gts = [a["bboxes"] for a in annots]
    props = [np.concatenate(d)[np.argsort(-np.concatenate(d)[:, 4])]
             for d in dets]
    thrs = np.arange(0.5, 0.96, 0.05)
    got = voc_eval.eval_recalls(gts, props, (1, 3, 100), thrs)
    assert np.array_equal(got, jax_voc_eval.eval_recalls(
        gts, props, (1, 3, 100), thrs))
    assert got.max() > 0
