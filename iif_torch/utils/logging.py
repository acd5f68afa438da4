"""Structured training logs: port of ``iif_tpu/utils/logging.py::
TrainLogWriter``, the reference's mmcv ``TextLoggerHook`` /
``TensorboardLoggerHook`` pair: one ``<timestamp>.log.json`` line a log
interval (mode / epoch / iter / lr / losses / time / data_time), headed by
the environment block, flushed a line at a time so that a crashed run
leaves a readable log; TensorBoard only where ``torch.utils.tensorboard``
imports, else the ``.log.json`` is the record."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class TrainLogWriter:
    def __init__(self, work_dir: str, tensorboard: bool = False):
        os.makedirs(work_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(work_dir, f"{stamp}.log.json")
        self._f = open(self.path, "a")
        self.tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(work_dir, "tf_logs"))
            except ImportError:
                self.tb = None

    def write_env_header(self, exp_name: str, seed: Optional[int] = None
                         ) -> None:
        """The first line: the environment block, the experiment name and
        the seed (no ``mode``: readers of the per-iteration lines skip
        it)."""
        from iif_torch.utils.env import env_info_str

        rec = {"env_info": env_info_str(), "exp_name": exp_name}
        if seed is not None:
            rec["seed"] = int(seed)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def write(self, record: Dict, step: Optional[int] = None) -> None:
        """One log interval as a JSON line; numeric fields mirrored to
        TensorBoard under ``<mode>/<key>``."""
        rec = {}
        for k, v in record.items():
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            rec[k] = round(v, 5) if isinstance(v, float) else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None and step is not None:
            mode = rec.get("mode", "train")
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k not in (
                        "epoch", "iter", "step"):
                    self.tb.add_scalar(f"{mode}/{k}", v, step)

    def close(self) -> None:
        self._f.close()
        if self.tb is not None:
            self.tb.close()
