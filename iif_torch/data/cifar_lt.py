"""Long-tailed CIFAR: port of ``iif_tpu/data/cifar_lt.py``
(``img_num_per_cls``, ``ImbalancedArrays`` with the legacy ``RandomState``
selection, ``load_cifar`` from the python-pickle files,
``make_synthetic_cifar``); every output equals the JAX package's array
for array. Data are HWC uint8 NumPy arrays; the augmentations run on the
device (``iif_torch/data/augment.py``)."""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


def img_num_per_cls(n_total: int, cls_num: int, imb_type: str,
                    imb_factor: float) -> List[int]:
    """Per-class retained counts: ``exp`` n_max * f^(c / (C - 1)),
    ``step`` half n_max and half n_max * f, else balanced."""
    img_max = n_total / cls_num
    out: List[int] = []
    if imb_type == "exp":
        for c in range(cls_num):
            out.append(int(img_max * (imb_factor ** (c / (cls_num - 1.0)))))
    elif imb_type == "step":
        for _ in range(cls_num // 2):
            out.append(int(img_max))
        for _ in range(cls_num // 2):
            out.append(int(img_max * imb_factor))
    else:
        out.extend([int(img_max)] * cls_num)
    return out


class ImbalancedArrays:
    """A balanced (data, targets) pair subsampled to the profile, each
    class's indices shuffled by one ``RandomState(rand_number)`` in class
    order."""

    def __init__(self, data: np.ndarray, targets: Sequence[int],
                 cls_num: int, imb_type: str = "exp",
                 imb_factor: float = 0.01, rand_number: int = 0):
        self.cls_num = cls_num
        rng = np.random.RandomState(rand_number)
        counts = img_num_per_cls(len(data), cls_num, imb_type, imb_factor)
        targets_np = np.array(targets, dtype=np.int64)
        classes = np.unique(targets_np)
        self.num_per_cls_dict: Dict[int, int] = {}
        new_data, new_targets = [], []
        for the_class, n_keep in zip(classes, counts):
            self.num_per_cls_dict[int(the_class)] = n_keep
            idx = np.where(targets_np == the_class)[0]
            rng.shuffle(idx)
            sel = idx[:n_keep]
            new_data.append(data[sel, ...])
            new_targets.extend([int(the_class)] * n_keep)
        self.data = np.vstack(new_data)
        self.targets = new_targets

    def __len__(self) -> int:
        return len(self.targets)

    def get_cls_num_list(self) -> List[int]:
        return [self.num_per_cls_dict[i] for i in range(self.cls_num)]


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar(root: str, name: str = "cifar100", train: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(data (N, 32, 32, 3) uint8, targets (N,) int64) from
    ``cifar-10-batches-py/`` or ``cifar-100-python/`` under ``root``."""
    if name == "cifar100":
        d = _load_pickle(os.path.join(root, "cifar-100-python",
                                      "train" if train else "test"))
        data, targets = d["data"], d["fine_labels"]
    elif name == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        if train:
            parts = [_load_pickle(os.path.join(base, f"data_batch_{i}"))
                     for i in range(1, 6)]
            data = np.concatenate([p["data"] for p in parts])
            targets = sum((p["labels"] for p in parts), [])
        else:
            d = _load_pickle(os.path.join(base, "test_batch"))
            data, targets = d["data"], d["labels"]
    else:
        raise ValueError(name)
    data = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(data), np.asarray(targets, dtype=np.int64)


def make_synthetic_cifar(n_per_class: int, cls_num: int, seed: int = 0,
                         size: int = 32, class_seed: int = 1234
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """A class-separable stand-in for CIFAR: each class a mean colour
    (from ``class_seed``) plus N(0, 25) noise, shuffled."""
    rng = np.random.RandomState(seed)
    n = n_per_class * cls_num
    targets = np.repeat(np.arange(cls_num), n_per_class)
    base = np.random.RandomState(class_seed).uniform(40, 215,
                                                     size=(cls_num, 3))
    data = (base[targets][:, None, None, :]
            + rng.normal(0, 25, size=(n, size, size, 3)))
    order = rng.permutation(n)
    return (np.clip(data, 0, 255).astype(np.uint8)[order],
            targets[order].astype(np.int64))
