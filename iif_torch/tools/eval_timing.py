"""Times ``iif_torch.cli.test_det.run_inference`` on the card, each batch
split by part, for this checkout or another one::

    python3 -m iif_torch.tools.eval_timing
    PYTHONPATH=OTHER_CHECKOUT python3 iif_torch/tools/eval_timing.py

The headline config as it stands (1203 classes, bf16 trunk,
``score_thr=1e-4``, 300 detections, masks, b4) with seeded random
weights, over a seeded LVIS v1-style val set of ``IMAGES`` PNGs
(``synthetic_lvis``, with negative and not-exhaustive ids), ``RUNS``
times; one JSON line with the card's name and power limit and, a run,
s/image (median and spread after the first batch, the first apart) and
each batch's host seconds split into the loader (decode, canvas on the
card), the device forward (drained), the masks' paste and read-back, the
RLE encode, the results conversion and the rest. ``batch_split`` is the
split ``chip_smoke.py``'s evaluation phase logs. It is the A/B tool of
the evaluation path: run it on two trees in turns in one call.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Dict, Iterator, List, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PARTS = ("paste_readback", "encode", "convert")
IMAGES = 32
RUNS = 2


@contextlib.contextmanager
def batch_split() -> Iterator[Tuple[List[Dict[str, float]], List[float]]]:
    """Within the block, ``test_det``'s batches on the card are timed by
    the host clock: yields (one dict of seconds by part a batch, the times
    at which the loop asked for each batch and for the end). The forward
    is drained (``torch.cuda.synchronize``)."""
    from iif_torch.cli import test_det
    from iif_torch.detection import simple_test

    split: List[Dict[str, float]] = []
    marks: List[float] = []

    def timed(key, fn, drain=False):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if drain:
                torch.cuda.synchronize()
            split[-1][key] = split[-1].get(key, 0.0) + (
                time.perf_counter() - t0)
            return out
        return call

    make, loader_iter = (simple_test.make_simple_test,
                         test_det._EvalLoader.__iter__)

    def make_timed(*args):
        return timed("forward", make(*args), drain=True)

    def timed_iter(self):
        batches = loader_iter(self)
        while True:
            marks.append(time.perf_counter())
            batch = next(batches, None)
            if batch is None:
                return
            split.append({"load": time.perf_counter() - marks[-1]})
            yield batch

    changes = [(simple_test, "make_simple_test", make_timed),
               (test_det._EvalLoader, "__iter__", timed_iter),
               (test_det, "_pasted_masks",
                timed("paste_readback", test_det._pasted_masks)),
               (test_det, "encode_masks",
                timed("encode", test_det.encode_masks)),
               (test_det, "detections_to_coco_results",
                timed("convert", test_det.detections_to_coco_results))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in changes]
    for obj, name, value in changes:
        setattr(obj, name, value)
    try:
        yield split, marks
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def summarize(split: List[Dict[str, float]], marks: List[float],
              batch_size: int) -> Dict:
    """s/image after the first batch (median and spread), the first
    batch's, and the split: the median over the batches after the first,
    and the first's, each with ``rest`` (the batch less its parts)."""
    per_batch = [b - a for a, b in zip(marks, marks[1:])]
    rows = [dict(row, rest=total - sum(row.values()))
            for row, total in zip(split, per_batch)]
    later = sorted(t / batch_size for t in per_batch[1:])
    keys = ("load", "forward") + PARTS + ("rest",)
    return {"batches": len(rows),
            "s_per_image_first_batch": per_batch[0] / batch_size,
            "s_per_image_after_first": {
                "median": statistics.median(later), "min": later[0],
                "max": later[-1]} if later else None,
            "batch_split_s_median_after_first": {
                k: statistics.median(r.get(k, 0.0) for r in rows[1:])
                for k in keys} if len(rows) > 1 else None,
            "batch_split_s_first": {k: rows[0].get(k, 0.0) for k in keys}}


def main() -> Dict:
    from iif_torch.cli import test_det
    from iif_torch.config import Config
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.inference import init_detector
    from iif_torch.tools.synthetic_lvis import (
        COCO_SIZES,
        write_synthetic_lvis,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = Config.fromfile(os.path.join(REPO, "configs/iif/iif_r50_1x.py"))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_synthetic_lvis(
            tmp, [COCO_SIZES[i % len(COCO_SIZES)]
                  for i in range(IMAGES)],
            cfg.model["num_classes"], seed=1, neg_ids=True)
        cfg.data["test"].update(data)
        ds = build_dataset(dict(cfg.data["test"]))
        det = init_detector(cfg, device="cuda", dataset=ds)
        batch = cfg.data["samples_per_gpu"]
        runs = []
        for _ in range(RUNS):
            with batch_split() as (split, marks):
                results = test_det.run_inference(
                    det, test_det._EvalLoader(ds, det, batch), ds.cat_ids,
                    True)
            runs.append(dict(summarize(split, marks, batch),
                             detections_per_image=len(results) / len(ds)))
    out = {"card": card, "package": os.path.dirname(os.path.dirname(
        test_det.__file__)), "images": IMAGES, "runs": runs}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
