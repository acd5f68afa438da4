"""Long-tailed txt-list datasets (ImageNet-LT, Places-LT, iNat18): port of
``iif_tpu/data/lt_dataset.py``. ``<path> <label>`` lines; the train split
re-maps class ids by descending frequency (ties by ascending id), the
eval split reuses the train map.

Images are read with the port's PNG decoder
(``iif_torch/detection/image_io.py``); any other format (JPEG) raises
``NotImplementedError``: the card's machine has neither cv2 nor PIL.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from iif_torch.detection.image_io import PNG_SIGNATURE, decode_png

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INAT18_MEAN = (0.466, 0.471, 0.380)
INAT18_STD = (0.195, 0.194, 0.192)


def _parse_txt(root: str, txt: str):
    img_path, targets = [], []
    with open(txt) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            img_path.append(os.path.join(root, parts[0]))
            targets.append(int(parts[1]))
    return img_path, targets


def _class_counts(targets: Sequence[int], num_classes: int) -> np.ndarray:
    """Images a class id in [0, num_classes), int64."""
    t = np.asarray(targets, dtype=np.int64)
    t = t[(t >= 0) & (t < num_classes)]
    return np.bincount(t, minlength=num_classes).astype(np.int64)


def frequency_class_map(targets: Sequence[int],
                        num_classes: int) -> List[int]:
    """old id -> new id, new ids by descending train frequency
    (``np.argsort(-counts)`` on the same int64 counts as the JAX
    package)."""
    sorted_classes = np.argsort(-_class_counts(targets, num_classes))
    class_map = [0] * num_classes
    for i in range(num_classes):
        class_map[sorted_classes[i]] = i
    return class_map


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise NotImplementedError(
            f"{path}: only PNG is decoded (JPEG would need cv2 or PIL)")
    return decode_png(data, path)


class LTDataset:
    """Train split: builds the frequency-sorted class map."""

    def __init__(self, root: str, txt: str, num_classes: int):
        self.num_classes = num_classes
        self.img_path, targets = _parse_txt(root, txt)
        self.class_map = frequency_class_map(targets, num_classes)
        self.targets = np.array(self.class_map)[targets].tolist()
        self.cls_num_list = _class_counts(self.targets,
                                          num_classes).tolist()

    def __len__(self) -> int:
        return len(self.targets)

    def get_cls_num_list(self) -> List[int]:
        return self.cls_num_list

    def load_image(self, index: int) -> np.ndarray:
        return load_image(self.img_path[index])


class LTDatasetEval:
    """Eval split: the train split's class map."""

    def __init__(self, root: str, txt: str, class_map: Sequence[int],
                 num_classes: int):
        self.num_classes = num_classes
        self.class_map = list(class_map)
        self.img_path, targets = _parse_txt(root, txt)
        self.targets = np.array(self.class_map)[targets].tolist()

    def __len__(self) -> int:
        return len(self.targets)

    def load_image(self, index: int) -> np.ndarray:
        return load_image(self.img_path[index])
