"""COCO / LVIS annotation reader for what serving needs: the class names
and the per-class counts that drive the IIF weights. The port's copy of
the counting part of ``iif_tpu/detection/datasets.py::CocoStyleDataset``
(same filtering, same ``image_count`` metadata rule, same pre-filter
``num_images_total``)."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict

import numpy as np


class CocoStyleDataset:
    def __init__(self, ann_file: str, img_prefix: str = "",
                 filter_empty_gt: bool = True, min_size: int = 32):
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]
        self.CLASSES = [c["name"] for c in cats]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.cat_image_counts = {c["id"]: c.get("image_count", 0)
                                 for c in cats}
        anns_by_img = defaultdict(list)
        for a in data.get("annotations", []):
            anns_by_img[a["image_id"]].append(a)
        # image-corpus size before empty-gt filtering: the N of the
        # detection IIF weights (N=100170 for LVIS v1 train)
        self.num_images_total = len(data["images"])
        self.img_infos = [{"width": img["width"], "height": img["height"],
                           "anns": anns_by_img.get(img["id"], [])}
                          for img in data["images"]]
        if filter_empty_gt:
            self.img_infos = [
                r for r in self.img_infos
                if any(not a.get("iscrowd", 0) for a in r["anns"])
                and min(r["width"], r["height"]) >= min_size]

    def __len__(self) -> int:
        return len(self.img_infos)

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


DATASETS = {"CocoDataset": CocoStyleDataset,
            "LVISV1Dataset": CocoStyleDataset}


def build_dataset(cfg: Dict[str, Any]) -> CocoStyleDataset:
    kw = dict(cfg)
    kind = kw.pop("type")
    if kind not in DATASETS:
        raise NotImplementedError(f"dataset type {kind!r} is not ported")
    return DATASETS[kind](**kw)
