"""``iif_torch/detection/datasets.py`` against ``iif_tpu.detection.
datasets`` (pure JSON and numpy) on a hand-written LVIS v1 / COCO file:
records, ``get_ann`` (crowd, zero-area, out-of-image and unknown-category
rules), ``flag``, ``image_path``, both count methods, ``repeat_factors``,
``expand_indices_by_repeat`` and ``group_epoch_order`` at two epochs,
equal."""
import json

import numpy as np
import pytest
import torch

from iif_torch.detection import datasets as td

torch.set_num_threads(1)


def _ann(i, img, cat, bbox, **kw):
    a = {"id": i, "image_id": img, "category_id": cat, "bbox": bbox,
         "area": bbox[2] * bbox[3], "iscrowd": 0,
         "segmentation": [[bbox[0], bbox[1], bbox[0] + bbox[2], bbox[1],
                           bbox[0] + bbox[2], bbox[1] + bbox[3]]]}
    a.update(kw)
    return a


def _write(tmp_path, lvis: bool):
    images = []
    for i, (h, w) in enumerate([(480, 640), (640, 480), (300, 300),
                                (20, 640), (427, 640), (500, 375),
                                (100, 200), (200, 100)], start=1):
        img = {"id": i, "width": w, "height": h}
        if lvis:
            img["coco_url"] = (f"http://images.cocodataset.org/train2017/"
                               f"{i:012d}.jpg")
            img["neg_category_ids"] = [3] if i % 2 else []
            img["not_exhaustive_category_ids"] = [1] if i == 2 else []
        else:
            img["file_name"] = f"{i:012d}.jpg"
        images.append(img)
    anns = [
        _ann(1, 1, 1, [10, 20, 100, 50]),
        _ann(2, 1, 2, [600, 400, 100, 200]),          # clipped to image
        _ann(3, 1, 3, [5, 5, 0, 10]),                 # zero width
        _ann(4, 1, 1, [50, 50, 30, 30], iscrowd=1),   # crowd
        _ann(5, 2, 2, [0, 0, 50, 60], segmentation=None),
        _ann(6, 2, 9, [1, 1, 10, 10]),                # unknown category
        _ann(7, 3, 3, [10, 10, 20, 20], iscrowd=1),   # crowd only: dropped
        _ann(8, 4, 1, [0, 0, 10, 10]),                # under min_size
        _ann(9, 5, 1, [-5, -5, 30, 30]),
        _ann(10, 5, 3, [700, 10, 10, 10]),            # out of the image
        _ann(11, 6, 2, [1, 2, 3, 4], area=0),         # zero area
        _ann(12, 6, 3, [30, 30, 40, 40]),
        _ann(13, 7, 1, [2, 2, 40, 40]),
        _ann(14, 8, 1, [2, 2, 40, 40]),
        _ann(15, 8, 2, [20, 20, 40, 40],
             segmentation={"size": [200, 100], "counts": "PPYo1"}),
    ]
    cats = [{"id": c, "name": n} for c, n in
            [(3, "zebra"), (1, "apple"), (2, "bee")]]
    if lvis:
        for c, n, f in zip(cats, (1, 5, 3), "rfc"):
            c["image_count"], c["frequency"] = n, f
    path = tmp_path / ("lvis.json" if lvis else "coco.json")
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    return str(path)


@pytest.fixture(params=[True, False], ids=["lvis", "coco"])
def pair(request, tmp_path):
    from iif_tpu.detection import datasets as jd

    path = _write(tmp_path, request.param)
    kind = "LVISV1Dataset" if request.param else "CocoDataset"
    cfg = {"type": kind, "ann_file": path, "img_prefix": "data/x/"}
    return td.build_dataset(cfg), jd.DATASETS.build(dict(cfg))


def test_records_and_get_ann_match_jax(pair):
    got, want = pair
    assert got.lvis_style == want.lvis_style
    assert got.CLASSES == want.CLASSES and got.cat_ids == want.cat_ids
    assert got.cat2label == want.cat2label
    assert got.cat_image_counts == want.cat_image_counts
    assert got.cat_frequency == want.cat_frequency
    assert got.num_images_total == want.num_images_total == 8
    assert got.img_infos == want.img_infos and len(got) == len(want) == 6
    np.testing.assert_array_equal(got.flag, want.flag)
    for i in range(len(got)):
        assert got.image_path(i) == want.image_path(i)
        a, b = got.get_ann(i), want.get_ann(i)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def test_counts_match_jax(pair):
    got, want = pair
    np.testing.assert_array_equal(got.class_image_counts(),
                                  want.class_image_counts())
    np.testing.assert_array_equal(got.class_instance_counts(),
                                  want.class_instance_counts())


@pytest.mark.parametrize("thr", [0.0, 0.3, 0.6, 1.0])
def test_repeat_factors_match_jax(pair, thr):
    from iif_tpu.detection import datasets as jd

    got, want = pair
    f = td.repeat_factors(got, thr)
    np.testing.assert_array_equal(f, jd.repeat_factors(want, thr))
    np.testing.assert_array_equal(td.expand_indices_by_repeat(f),
                                  jd.expand_indices_by_repeat(f))


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("epoch", [0, 1])
def test_group_epoch_order_matches_jax(pair, epoch, batch):
    from iif_tpu.detection import datasets as jd

    got, _ = pair
    idx = td.expand_indices_by_repeat(td.repeat_factors(got, 0.6))
    flags = got.flag[idx]
    np.testing.assert_array_equal(
        td.group_epoch_order(flags, np.arange(len(idx)), epoch, batch, 3),
        jd.group_epoch_order(flags, np.arange(len(idx)), epoch, batch, 3))


@pytest.mark.parametrize("kind", ["VOCDataset", "WIDERFaceDataset",
                                  "CityscapesDataset", "DeepFashionDataset",
                                  "ConcatDataset", "RepeatDataset"])
def test_unported_datasets_raise(kind):
    with pytest.raises(NotImplementedError, match=kind):
        td.build_dataset({"type": kind, "ann_file": "x"})


def test_proposal_file_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="proposal_file"):
        td.CocoStyleDataset(_write(tmp_path, False), proposal_file="p.pkl")
