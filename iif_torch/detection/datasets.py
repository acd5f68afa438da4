"""COCO / LVIS detection datasets: port of ``iif_tpu/detection/
datasets.py`` (``CocoStyleDataset``, ``LVISV1Dataset``, ``repeat_factors``,
``expand_indices_by_repeat``, ``group_epoch_order``), pure JSON.

Records follow ``mmdet/datasets/coco.py`` and ``lvis.py``: the file name
from ``file_name`` or LVIS v1's ``coco_url``, the per-image
``neg_category_ids`` / ``not_exhaustive_category_ids``, per-category
``image_count`` and ``frequency``, images without a non-crowd
annotation or under ``min_size`` dropped, and the aspect ``flag`` the
group sampler reads. ``repeat_factors`` is ``ClassBalancedDataset``'s
(``dataset_wrappers.py:230-276``) and ``group_epoch_order`` the
``GroupSampler`` as a deterministic epoch order.

Precomputed proposals (``proposal_file``) are not ported, nor the VOC,
WIDER-Face, Cityscapes and DeepFashion datasets or the Concat / Repeat
wrappers: ``build_dataset`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import json
import math
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


class CocoStyleDataset:
    """Annotation container for COCO-format JSON (LVIS included): one
    record ``{id, file_name, width, height, neg_category_ids,
    not_exhaustive_category_ids, anns}`` an image."""

    def __init__(self, ann_file: str, img_prefix: str = "",
                 filter_empty_gt: bool = True, min_size: int = 32,
                 lvis_style: bool = False,
                 proposal_file: Optional[str] = None):
        if proposal_file is not None:
            raise NotImplementedError("proposal_file is not ported")
        self.img_prefix = img_prefix
        self.lvis_style = lvis_style
        with open(ann_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]
        self.CLASSES = [c["name"] for c in cats]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        # per-category image counts (IIF weights, repeat factors) and
        # LVIS v1's 'r' / 'c' / 'f' frequency
        self.cat_image_counts = {c["id"]: c.get("image_count", 0)
                                 for c in cats}
        self.cat_frequency = {c["id"]: c.get("frequency") for c in cats}
        anns_by_img = defaultdict(list)
        for a in data.get("annotations", []):
            anns_by_img[a["image_id"]].append(a)
        # image-corpus size before empty-gt filtering: the N of the
        # detection IIF weights (N=100170 for LVIS v1 train)
        self.num_images_total = len(data["images"])
        self.img_infos: List[dict] = []
        for img in data["images"]:
            file_name = img.get("file_name")
            if file_name is None and "coco_url" in img:       # LVIS v1
                file_name = img["coco_url"].replace(
                    "http://images.cocodataset.org/", "")
            self.img_infos.append({
                "id": img["id"],
                "file_name": file_name,
                "width": img["width"],
                "height": img["height"],
                "neg_category_ids": img.get("neg_category_ids", []),
                "not_exhaustive_category_ids":
                    img.get("not_exhaustive_category_ids", []),
                "anns": anns_by_img.get(img["id"], []),
            })
        if filter_empty_gt:
            self.img_infos = [
                r for r in self.img_infos
                if any(not a.get("iscrowd", 0) for a in r["anns"])
                and min(r["width"], r["height"]) >= min_size]
        self.flag = np.array(
            [1 if r["width"] / r["height"] > 1 else 0
             for r in self.img_infos], np.uint8)

    def __len__(self) -> int:
        return len(self.img_infos)

    def get_ann(self, idx: int) -> Dict[str, Any]:
        """Parsed annotations (``coco.py:38-96`` ``_parse_ann_info``):
        boxes xyxy clipped to the image, contiguous labels, the
        segmentations; crowd boxes apart; zero-area, empty and unknown-
        category annotations dropped."""
        rec = self.img_infos[idx]
        w, h = rec["width"], rec["height"]
        boxes, labels, segms = [], [], []
        crowd_boxes, crowd_labels = [], []
        for a in rec["anns"]:
            x, y, bw, bh = a["bbox"]
            x1, y1 = max(x, 0), max(y, 0)
            x2, y2 = min(x + bw, w), min(y + bh, h)
            if a.get("area", bw * bh) <= 0 or x2 <= x1 or y2 <= y1:
                continue
            if a.get("category_id") not in self.cat2label:
                continue
            if a.get("iscrowd", 0):
                crowd_boxes.append([x1, y1, x2, y2])
                crowd_labels.append(self.cat2label[a["category_id"]])
                continue
            boxes.append([x1, y1, x2, y2])
            labels.append(self.cat2label[a["category_id"]])
            segms.append(a.get("segmentation"))
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "segms": segms,
            "crowd_boxes": np.asarray(crowd_boxes, np.float32).reshape(-1, 4),
            "crowd_labels": np.asarray(crowd_labels, np.int64),
            "width": w,
            "height": h,
        }

    def image_path(self, idx: int) -> str:
        return os.path.join(self.img_prefix, self.img_infos[idx]["file_name"])

    def class_image_counts(self) -> np.ndarray:
        """Per-class image counts: from LVIS ``image_count`` metadata when
        present, else counted from annotations."""
        meta = [self.cat_image_counts.get(cid, 0) for cid in self.cat_ids]
        if any(meta):
            return np.asarray(meta, np.int64)
        counts = np.zeros(len(self.CLASSES), np.int64)
        for rec in self.img_infos:
            seen = {self.cat2label[a["category_id"]] for a in rec["anns"]
                    if a.get("category_id") in self.cat2label}
            for lab in seen:
                counts[lab] += 1
        return counts

    def class_instance_counts(self) -> np.ndarray:
        """Per-class instance counts (the ``*_obj`` IIF variants)."""
        counts = np.zeros(len(self.CLASSES), np.int64)
        for rec in self.img_infos:
            for a in rec["anns"]:
                cid = a.get("category_id")
                if cid in self.cat2label and not a.get("iscrowd", 0):
                    counts[self.cat2label[cid]] += 1
        return counts


class LVISV1Dataset(CocoStyleDataset):
    def __init__(self, ann_file: str, img_prefix: str = "", **kw):
        super().__init__(ann_file, img_prefix, lvis_style=True, **kw)


DATASETS = {"CocoDataset": CocoStyleDataset,
            "LVISV1Dataset": LVISV1Dataset}


def build_dataset(cfg: Dict[str, Any]) -> CocoStyleDataset:
    kw = dict(cfg)
    kind = kw.pop("type")
    if kind not in DATASETS:
        raise NotImplementedError(f"dataset type {kind!r} is not ported")
    return DATASETS[kind](**kw)


def repeat_factors(dataset: CocoStyleDataset, oversample_thr: float
                   ) -> np.ndarray:
    """LVIS repeat-factor sampling: category factor ``r(c) = max(1,
    sqrt(t / f(c)))`` with f(c) the fraction of images containing c; image
    factor ``r(I) = max_{c in I} r(c)``."""
    n = len(dataset)
    cat_freq: Dict[int, float] = defaultdict(float)
    img_cats: List[set] = []
    for rec in dataset.img_infos:
        cats = {a["category_id"] for a in rec["anns"]
                if a.get("category_id") in dataset.cat2label}
        img_cats.append(cats)
        for c in cats:
            cat_freq[c] += 1
    for c in cat_freq:
        cat_freq[c] /= n
    cat_repeat = {c: max(1.0, math.sqrt(oversample_thr / f))
                  for c, f in cat_freq.items()}
    out = np.ones(n)
    for i, cats in enumerate(img_cats):
        if cats:
            out[i] = max(cat_repeat[c] for c in cats)
    return out


def expand_indices_by_repeat(factors: np.ndarray) -> np.ndarray:
    """mmdet's deterministic expansion: each index ceil(factor) times."""
    out = []
    for i, f in enumerate(factors):
        out.extend([i] * int(math.ceil(f)))
    return np.asarray(out, np.int64)


def group_epoch_order(flags: np.ndarray, indices: np.ndarray, epoch: int,
                      samples_per_gpu: int, seed: int = 0) -> np.ndarray:
    """Aspect-homogeneous batch order (``GroupSampler``): shuffle within
    each aspect group, pad the group to whole batches by wrapping around,
    chunk into batches, shuffle the chunks; seeded by ``seed + epoch``."""
    rng = np.random.RandomState(seed + epoch)
    chunks = []
    for g in np.unique(flags[indices]):
        members = indices[flags[indices] == g]
        rng.shuffle(members)
        pad = (-len(members)) % samples_per_gpu
        if pad:
            members = np.concatenate([members, np.resize(members, pad)])
        chunks.extend(members.reshape(-1, samples_per_gpu))
    order = np.arange(len(chunks))
    rng.shuffle(order)
    return np.concatenate([chunks[i] for i in order]) if chunks else indices
