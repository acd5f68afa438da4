"""Training meters: port of ``iif_tpu/utils/metrics.py`` (``SmoothedValue``
and ``MetricLogger`` with ``log_every`` and its ``sink``), the reference's
``classification/utils.py:13-162``, for one process on one card (no
cross-process reduction)."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch


class SmoothedValue:
    """Windowed meter with a global average."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class MetricLogger:
    """Iteration logger with ETA."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                v = float(v)
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: Optional[str] = None, total: Optional[int] = None,
                  sink=None):
        """Yields from ``iterable``; at every print point prints a line
        and hands ``sink`` (when given) a dict of {iter, time, data_time,
        <meter medians>}, the ``.log.json`` writer's record."""
        header = header or ""
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = 0
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % print_freq == 0 or i == total - 1):
                eta = datetime.timedelta(
                    seconds=int(iter_time.global_avg * max(total - i, 0)))
                self.print(self.delimiter.join([
                    header, f"[{i}/{total}]", f"eta: {eta}", str(self),
                    f"time: {iter_time}", f"data: {data_time}"]))
                if sink is not None:
                    sink({"iter": i, "time": iter_time.avg,
                          "data_time": data_time.avg,
                          **{k: m.median for k, m in self.meters.items()}})
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print(f"{header} Total time: "
                   f"{datetime.timedelta(seconds=int(elapsed))}")
