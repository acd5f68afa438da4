"""Host batcher: port of ``iif_tpu/data/loader.py`` for one process
(``Loader``: a deterministic order an epoch, raw uint8 batches, a prefetch
thread; ``eval_batches``: sequential batches, the last padded and
masked). Augmentation runs on the device."""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from iif_torch.data.samplers import balanced_epoch_order, random_epoch_order
from iif_torch.utils.prefetch import prefetch


def _gather(data, idx: np.ndarray) -> np.ndarray:
    if hasattr(data, "load_image"):
        return np.stack([data.load_image(int(i)) for i in idx])
    return data[idx]


class Loader:
    """Batches of ``batch_size`` over ``data`` (an (N, ...) array or an
    object with ``load_image(i)``) in the order of ``sampler``
    (``random``, ``upsampling`` or ``downsampling``) for ``set_epoch``'s
    epoch; ``drop_last=False`` pads the last batch and masks it
    (``valid``); ``prefetch`` > 0 builds batches that far ahead in a
    thread, whose error is raised here."""

    def __init__(self, data, targets: Sequence[int], batch_size: int,
                 sampler: str = "random", seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2):
        self.data = data
        self.targets = np.asarray(targets, dtype=np.int64)
        self.batch_size = batch_size
        self.sampler = sampler
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        if self.sampler == "random":
            return random_epoch_order(len(self.targets), self.epoch,
                                      self.seed)
        return balanced_epoch_order(self.targets, self.epoch,
                                    mode=self.sampler, seed=self.seed)

    def __len__(self) -> int:
        n = len(self._epoch_order())
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            valid = np.ones(len(sel), dtype=bool)
            if len(sel) < self.batch_size:
                pad = self.batch_size - len(sel)
                sel = np.concatenate(
                    [sel, np.full(pad, sel[-1] if len(sel) else 0)])
                valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
            yield {"image": _gather(self.data, sel),
                   "label": self.targets[sel], "valid": valid}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return prefetch(self._batches, self.prefetch)


def eval_batches(data, targets: Sequence[int], batch_size: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential batches; the last padded with its last index and masked
    by ``valid``, so accuracy counts each image once."""
    targets = np.asarray(targets, dtype=np.int64)
    n = len(targets)
    for b0 in range(0, n, batch_size):
        sel = np.arange(b0, min(b0 + batch_size, n))
        valid = np.ones(len(sel), dtype=bool)
        if len(sel) < batch_size:
            pad = batch_size - len(sel)
            sel = np.concatenate([sel, np.full(pad, sel[-1])])
            valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
        yield {"image": _gather(data, sel), "label": targets[sel],
               "valid": valid}
