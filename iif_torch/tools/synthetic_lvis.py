"""A seeded synthetic LVIS v1-style training set on disk, for the smoke run
and the tests: PNG images under ``<root>/train2017/`` named through LVIS
v1's ``coco_url``, and ``<root>/annotations.json`` with

- categories ``class_0`` .. named and ordered as the smoke run's serving
  annotations name them (ids from 1), each with the ``image_count`` and
  ``frequency`` ('r' up to 10 images, 'c' up to 100, else 'f') of this
  set's own annotations;
- ``instances`` instances an image, boxes of 8% to 60% of the image a
  side, labels drawn log-uniformly over the classes (long-tailed);
- segmentations: most as polygons of 1-3 parts inside their box, every
  5th annotation a compressed RLE of its box, every 17th a crowd RLE;
- with ``neg_ids``, each image's ``neg_category_ids`` (3 categories of
  the set absent from it) and ``not_exhaustive_category_ids`` (one of
  its own), drawn after everything else from a generator of their own,
  so the images and annotations are those of the set without them.

``write_synthetic_squares`` writes the overfit set: bright squares on
dark noise, one an image, two categories (``scripts/overfit_cascade.py::
make_dataset``'s draws and annotations, as PNG).

    python -m iif_torch.tools.synthetic_lvis ROOT
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, Sequence, Tuple

import numpy as np

from iif_torch.detection.image_io import write_png
from iif_torch.detection.mask_utils import rle_encode

# (H, W): COCO-like landscape and portrait sizes
COCO_SIZES = ((480, 640), (427, 640), (375, 500),
              (640, 480), (640, 427), (500, 375))


def _polygon(rng: np.random.RandomState, box: np.ndarray) -> list:
    """A star-shaped polygon of 5-12 vertices inside ``box``."""
    x1, y1, x2, y2 = box
    n = rng.randint(5, 13)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.4, 1.0, n)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    xs = cx + (x2 - x1) / 2 * rad * np.cos(ang)
    ys = cy + (y2 - y1) / 2 * rad * np.sin(ang)
    return np.round(np.stack([xs, ys], 1).ravel(), 2).tolist()


def write_synthetic_lvis(root: str, sizes: Sequence[Tuple[int, int]],
                         num_classes: int, seed: int = 0,
                         instances: Tuple[int, int] = (5, 40),
                         neg_ids: bool = False) -> Dict[str, str]:
    """Writes the set (one image a size in ``sizes``) and returns
    ``{"ann_file", "img_prefix"}`` for ``data.train`` (or ``data.test``).
    ``neg_ids`` adds the LVIS per-image negative and not-exhaustive
    category ids."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "train2017"), exist_ok=True)
    images, anns = [], []
    for img_id, (h, w) in enumerate(sizes, start=1):
        name = f"train2017/{img_id:012d}.png"
        coarse = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255)
        write_png(os.path.join(root, name), img.astype(np.uint8))
        images.append({"id": img_id, "width": w, "height": h,
                       "coco_url": "http://images.cocodataset.org/" + name,
                       "neg_category_ids": [],
                       "not_exhaustive_category_ids": []})
        for _ in range(rng.randint(instances[0], instances[1] + 1)):
            bw = rng.uniform(0.08, 0.6) * w
            bh = rng.uniform(0.08, 0.6) * h
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            box = np.array([x1, y1, x1 + bw, y1 + bh])
            label = min(int(np.exp(rng.uniform(0, np.log(num_classes)))),
                        num_classes) - 1
            ann = {"id": len(anns) + 1, "image_id": img_id,
                   "category_id": label + 1, "iscrowd": 0,
                   "bbox": [round(float(v), 2) for v in
                            (x1, y1, bw, bh)],
                   "area": round(float(bw * bh), 2)}
            k = len(anns) + 1
            if k % 17 == 0 or k % 5 == 0:
                m = np.zeros((h, w), np.uint8)
                m[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = 1
                ann["segmentation"] = rle_encode(m)
                ann["iscrowd"] = int(k % 17 == 0)
            else:
                ann["segmentation"] = [_polygon(rng, box)
                                       for _ in range(rng.randint(1, 4))]
            anns.append(ann)
    seen = [set() for _ in range(num_classes)]
    for a in anns:
        seen[a["category_id"] - 1].add(a["image_id"])
    if neg_ids:
        ids_rng = np.random.RandomState(seed + 1)
        present = [i + 1 for i, imgs in enumerate(seen) if imgs]
        for im in images:
            own = sorted({a["category_id"] for a in anns
                          if a["image_id"] == im["id"]})
            absent = [c for c in present if c not in own]
            im["neg_category_ids"] = sorted(int(c) for c in ids_rng.choice(
                absent, min(3, len(absent)), replace=False))
            im["not_exhaustive_category_ids"] = [int(ids_rng.choice(own))]
    cats = []
    for i, imgs in enumerate(seen):
        n = len(imgs)
        cats.append({"id": i + 1, "name": f"class_{i}", "image_count": n,
                     "frequency": "r" if n <= 10 else
                     "c" if n <= 100 else "f"})
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return {"ann_file": ann_file, "img_prefix": root}


def write_synthetic_squares(root: str, n_imgs: int = 8,
                            size: Tuple[int, int] = (96, 128),
                            n_cats: int = 2,
                            obj_range: Tuple[int, int] = (20, 32),
                            seed: int = 0) -> Dict[str, str]:
    """``n_imgs`` PNGs under ``<root>/images/`` of dark noise with one
    bright square each, category ``1 + i % n_cats``, and a COCO-style
    ``<root>/ann.json``; the draws of ``scripts/overfit_cascade.py::
    make_dataset`` (from ``RandomState(seed)``). Returns ``{"ann_file",
    "img_prefix"}``."""
    h, w = size
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.RandomState(seed)
    images, anns = [], []
    lo, hi = obj_range
    for i in range(n_imgs):
        img = rng.randint(0, 100, (h, w, 3), np.uint8)
        x1 = rng.randint(5, max(w - hi - 8, 6))
        y1 = rng.randint(5, max(h - hi - 8, 6))
        bw, bh = rng.randint(lo, hi), rng.randint(lo, hi)
        img[y1:y1 + bh, x1:x1 + bw] = 230
        write_png(os.path.join(root, "images", f"{i}.png"), img)
        images.append({"id": i, "file_name": f"images/{i}.png",
                       "width": w, "height": h})
        anns.append({"id": i + 1, "image_id": i,
                     "category_id": 1 + i % n_cats,
                     "bbox": [int(x1), int(y1), int(bw), int(bh)],
                     "area": int(bw * bh), "iscrowd": 0,
                     "segmentation": [[int(v) for v in (
                         x1, y1, x1 + bw, y1, x1 + bw, y1 + bh, x1,
                         y1 + bh)]]})
    cats = [{"id": c + 1, "name": f"square{c}",
             "image_count": max(1, n_imgs // n_cats)} for c in range(n_cats)]
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        json.dump({"categories": cats, "images": images,
                   "annotations": anns}, f)
    return {"ann_file": ann_file, "img_prefix": root}


if __name__ == "__main__":
    write_synthetic_lvis(sys.argv[1], COCO_SIZES * 4, num_classes=1203)
