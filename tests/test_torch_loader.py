"""``iif_torch/detection/pipeline.py::DetectionLoader`` against
``iif_tpu.detection.pipeline.DetectionLoader`` (numpy and cv2, no JAX
compile) on 10 PNGs written to disk (``iif_torch/tools/synthetic_lvis.
py``): repeat factors (``oversample_thr`` 0.6), aspect groups, batch 2, 2
workers, prefetch on and off, epochs 0 and 1, the recipe's six scales and
canvas scaled down by 4 (three buckets). Equal: the batch order,
``image_ids``, the canvas of each batch and every key, the image within 1
grey level (the resize, ``tests/test_torch_pipeline_train.py``); once more
with cv2 blocked on the port's side. An early stop leaves no live
thread; a worker's error reaches the consumer."""
import sys
import threading

import numpy as np
import pytest
import torch

from iif_torch.detection.datasets import build_dataset
from iif_torch.detection.pipeline import DetectionLoader, DetectionPipeline
from iif_torch.tools.synthetic_lvis import write_synthetic_lvis

torch.set_num_threads(1)

SCALES = [(333, 160), (333, 168), (333, 176), (333, 184), (333, 192),
          (333, 200)]
CANVAS = (200, 336)
SIZES = [(48, 64), (64, 48), (40, 60), (60, 40), (36, 50), (50, 36),
         (48, 64), (64, 48), (40, 72), (72, 40)]
PIPE = dict(canvas=CANVAS, scales=SCALES, max_gt=6, mask_stride=2,
            canvas_buckets=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("lvis")
    paths = write_synthetic_lvis(str(root), SIZES, num_classes=7, seed=4,
                                 instances=(2, 8))
    return {"type": "LVISV1Dataset", **paths}


def _jax_batches(cfg, epoch, prefetch):
    from iif_tpu.detection.datasets import DATASETS
    from iif_tpu.detection.pipeline import (
        DetectionLoader as JaxLoader,
        DetectionPipeline as JaxPipeline,
    )

    loader = JaxLoader(DATASETS.build(dict(cfg)),
                       JaxPipeline(emit_uint8=True, pack_masks=True, **PIPE),
                       batch_size=2, oversample_thr=0.6, seed=3,
                       num_workers=2, prefetch=prefetch)
    loader.set_epoch(epoch)
    return len(loader), list(loader)


def _port_loader(cfg, prefetch):
    return DetectionLoader(build_dataset(dict(cfg)), DetectionPipeline(**PIPE),
                           batch_size=2, oversample_thr=0.6, seed=3,
                           num_workers=2, prefetch=prefetch)


def _check(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
            if k == "image":
                assert np.abs(g[k].astype(int) - v.astype(int)).max() <= 1
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_matches_jax(data, epoch, prefetch, monkeypatch):
    n, want = _jax_batches(data, epoch, prefetch)
    monkeypatch.setitem(sys.modules, "cv2", None)       # the card has none
    loader = _port_loader(data, prefetch)
    loader.set_epoch(epoch)
    assert len(loader) == n
    got = list(loader)
    _check(got, want)
    assert len({b["image"].shape for b in got}) > 1    # buckets per batch


def test_loader_stops_early_without_live_threads(data):
    before = set(threading.enumerate())
    for prefetch in (0, 2):
        loader = _port_loader(data, prefetch)
        batches = iter(loader)
        next(batches)
        batches.close()
        for b in loader:
            break
        del b
    assert set(threading.enumerate()) <= before


def test_loader_reraises_worker_errors(data, tmp_path):
    ds = build_dataset(dict(data))
    ds.img_prefix = str(tmp_path)                        # no images there
    loader = DetectionLoader(ds, DetectionPipeline(**PIPE), batch_size=2,
                             num_workers=2, prefetch=2)
    before = set(threading.enumerate())
    with pytest.raises(FileNotFoundError):
        list(loader)
    assert set(threading.enumerate()) <= before
