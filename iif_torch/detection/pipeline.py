"""Detection data pipeline and loader: port of ``iif_tpu/detection/
pipeline.py`` (``DetectionPipeline`` and ``DetectionLoader``), without
cv2.

The pipeline's two branches:

- eval (``__call__``): keep-ratio resize to the test scale (never past
  the static canvas), then the uint8 canvas padded with the rounded mean
  pixel, so that the device-side normalisation
  (``detector.normalize_if_uint8``) maps the pad to ~0; on the target
  device. ``eval_view`` is the same at a given scale with an optional
  flip, one view of test-time augmentation.
- train (``sample``, the JAX ``__call__(..., train=True)``): on the host,
  in numpy, with the JAX draw order from the sample's ``RandomState``:
  the scale index (or ``scale_idx``), its canvas bucket, the keep-ratio
  resize capped by that canvas, the flip draw (``rng.rand() <
  flip_prob``), the box flip, ``max_gt`` padding, the uint8 canvas, and
  masks at ``mask_stride``: polygons filled straight at stride
  resolution from scaled and flipped coordinates (``mask_utils.
  fill_poly``, OpenCV's rule), RLE decoded and nearest-resized twice
  (``resize_nearest``, OpenCV's ``INTER_NEAREST`` rule), a missing
  segmentation as its box; bit-packed big-endian on the last axis
  (``detector.unpack_mask_bits`` mirrors it), the JAX CLI's default.

The image resize is PyTorch's bilinear (``align_corners=False``, no
antialias; cv2's fixed-point ``INTER_LINEAR`` differs by at most one grey
level), skipped when the size is unchanged. The train branch emits the
uint8 canvas only; ``extra_transforms``, ``keep_ratio=False``,
``with_seg`` and ``max_proposals > 0`` raise ``NotImplementedError``.

``DetectionLoader`` batches a dataset through the train branch in the JAX
loader's order: repeat-factor expansion, ``group_epoch_order`` with
``seed + epoch``, and one ``RandomState(seed + epoch)`` drawing each
batch's sample seeds, then its canvas bucket, then its scale ids. It
yields numpy batches; the trainer copies them to the card.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iif_torch.detection.datasets import (
    CocoStyleDataset,
    expand_indices_by_repeat,
    group_epoch_order,
    repeat_factors,
)
from iif_torch.detection.image_io import read_image
from iif_torch.detection.mask_utils import fill_poly, segm_to_bitmap
from iif_torch.utils.prefetch import prefetch

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
DEFAULT_SCALE = (1333, 800)


def keep_ratio_scale(h: int, w: int, scale: Tuple[int, int]) -> float:
    """mmdet ``rescale_size``: factor = min(max_long/long, max_short/short)."""
    max_long, max_short = max(scale), min(scale)
    return min(max_long / max(h, w), max_short / min(h, w))


def resized_shape(h: int, w: int, scale: Tuple[int, int],
                  canvas: Tuple[int, int]) -> Tuple[float, int, int]:
    """(factor, new h, new w) of the keep-ratio resize to ``scale``, never
    past ``canvas``."""
    factor = keep_ratio_scale(h, w, scale)
    factor = min(factor, canvas[0] / h, canvas[1] / w)
    return factor, int(h * factor + 0.5), int(w * factor + 0.5)


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H0, W0, 3) uint8 -> (h, w, 3) uint8 by PyTorch's bilinear
    (``align_corners=False``, no antialias), rounded; the input itself
    when the size is unchanged."""
    if tuple(img.shape[:2]) == (h, w):
        return img
    x = img.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)
    return x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


def resize_nearest(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(m, (w, h), interpolation=INTER_NEAREST)``: source
    index ``min(floor(i * (1 / (dst / src))), src - 1)`` in doubles."""
    sh, sw = m.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
    return m[ys.astype(np.int64)[:, None], xs.astype(np.int64)[None, :]]


class DetectionPipeline:
    def __init__(self, canvas: Tuple[int, int] = (800, 1344),
                 scales: Sequence[Tuple[int, int]] = (DEFAULT_SCALE,),
                 flip_prob: float = 0.5, max_gt: int = 100,
                 with_mask: bool = True, mask_stride: int = 1,
                 canvas_buckets: bool = False, keep_ratio: bool = True,
                 extra_transforms: Optional[Sequence] = None,
                 with_seg: bool = False, max_proposals: int = 0):
        unported = {"keep_ratio=False": not keep_ratio,
                    "extra_transforms": bool(extra_transforms),
                    "with_seg": with_seg,
                    "max_proposals > 0": max_proposals > 0}
        for knob, bad in unported.items():
            if bad:
                raise NotImplementedError(f"pipeline {knob} is not ported")
        self.canvas = tuple(canvas)
        self.scales = [tuple(s) for s in scales]
        self.flip_prob = flip_prob
        self.max_gt = max_gt
        self.with_mask = with_mask
        self.mask_stride = mask_stride
        self._pad_pixel = np.round(IMAGENET_MEAN).astype(np.uint8)
        # canvas buckets: each train scale gets the smallest 32-divisible
        # canvas that holds it; the loader picks one bucket a batch
        self.canvas_of = [self.canvas] * len(self.scales)
        if canvas_buckets and len(self.scales) > 1:
            ch, cw = self.canvas
            self.canvas_of = [(min(ch, -(-min(s) // 32) * 32), cw)
                              for s in self.scales]
        # bucket id -> (canvas, [scale indices])
        self.buckets: List[Tuple[Tuple[int, int], List[int]]] = []
        for idx, cv in enumerate(self.canvas_of):
            for b in self.buckets:
                if b[0] == cv:
                    b[1].append(idx)
                    break
            else:
                self.buckets.append((cv, [idx]))

    def __call__(self, image: np.ndarray, device: torch.device
                 ) -> Dict[str, Any]:
        """Eval branch: (H0, W0, 3) uint8 RGB -> {image (H, W, 3) uint8
        canvas on ``device``, img_shape (2,), scale_factor (), flip ()}:
        ``eval_view`` at the first scale, unflipped."""
        return self.eval_view(image, self.scales[0], False, device)

    def eval_view(self, image: np.ndarray, scale: Tuple[int, int],
                  flip: bool, device: torch.device) -> Dict[str, Any]:
        """One test-time augmentation view (``MultiScaleFlipAug``,
        ``pipeline.py:596-``): the eval branch at ``scale`` (keep-ratio,
        never past the canvas), then, with ``flip``, the resized image
        mirrored before the padding. {image (H, W, 3) uint8 canvas on
        ``device``, img_shape (2,), scale_factor (), flip ()}."""
        h0, w0 = image.shape[:2]
        ch, cw = self.canvas
        factor, nh, nw = resized_shape(h0, w0, tuple(scale), self.canvas)
        img = resize_bilinear(torch.from_numpy(np.ascontiguousarray(image))
                              .to(device), nh, nw)
        if flip:
            img = img.flip(1)
        out = torch.empty((ch, cw, 3), dtype=torch.uint8, device=device)
        out[:] = torch.from_numpy(self._pad_pixel).to(device)
        out[:nh, :nw] = img
        return {"image": out,
                "img_shape": np.array([nh, nw], np.int32),
                "scale_factor": np.float32(factor), "flip": np.bool_(flip)}

    def sample(self, image: np.ndarray, ann: Dict[str, Any],
               rng: np.random.RandomState, mix_fetch=None,
               scale_idx: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One training sample on the host (JAX ``__call__(...,
        train=True)``): (H0, W0, 3) uint8 RGB and its ``get_ann`` record ->
        {image (H, W, 3) uint8 canvas, gt_boxes (G, 4), gt_labels (G,),
        gt_valid (G,), img_shape (2,), scale_factor (), flip (), and with
        masks ``gt_masks_packed`` (G, H/s, W/s/8)}."""
        if mix_fetch is not None:
            raise NotImplementedError("multi-image transforms (mix_fetch) "
                                      "are not ported")
        h0, w0 = image.shape[:2]
        s_i = rng.randint(len(self.scales)) if scale_idx is None \
            else int(scale_idx)
        ch, cw = self.canvas_of[s_i]
        factor, nh, nw = resized_shape(h0, w0, self.scales[s_i], (ch, cw))
        img = resize_bilinear(torch.from_numpy(np.ascontiguousarray(image)),
                              nh, nw).numpy()
        boxes = ann["boxes"] * factor
        flip = rng.rand() < self.flip_prob
        if flip:
            img = img[:, ::-1]
            flipped = boxes.copy()
            flipped[:, 0] = nw - boxes[:, 2]
            flipped[:, 2] = nw - boxes[:, 0]
            boxes = flipped
        out_img = np.empty((ch, cw, 3), np.uint8)
        out_img[:] = self._pad_pixel
        out_img[:nh, :nw] = img

        g = self.max_gt
        n = min(len(boxes), g)
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_labels = np.zeros(g, np.int64)
        gt_valid = np.zeros(g, bool)
        gt_boxes[:n] = boxes[:n]
        gt_labels[:n] = ann["labels"][:n]
        gt_valid[:n] = True
        out = {"image": out_img, "gt_boxes": gt_boxes,
               "gt_labels": gt_labels, "gt_valid": gt_valid,
               "img_shape": np.array([nh, nw], np.int32),
               "scale_factor": np.float32(factor), "flip": np.bool_(flip)}
        if self.with_mask:
            masks = self._masks(ann, boxes, n, factor, flip, nh, nw, ch, cw)
            packed = np.zeros((g,) + masks.shape[1:2]
                              + ((masks.shape[2] + 7) // 8,), np.uint8)
            if n:
                packed[:n] = np.packbits(masks, axis=-1)
            out["gt_masks_packed"] = packed
        return out

    def _masks(self, ann, boxes, n, factor, flip, nh, nw, ch, cw
               ) -> np.ndarray:
        """The first ``n`` instances' masks at stride ``mask_stride`` on
        the canvas."""
        s = self.mask_stride
        masks = np.zeros((n, ch // s, cw // s), np.uint8)
        for i in range(n):
            segm = ann["segms"][i]
            if segm is None:
                x1, y1, x2, y2 = boxes[i].astype(int)
                masks[i, y1 // s:y2 // s, x1 // s:x2 // s] = 1
            elif isinstance(segm, (list, tuple)):
                for p in segm:
                    q = np.asarray(p, np.float32).reshape(-1, 2) * factor
                    if flip:
                        q[:, 0] = nw - q[:, 0]
                    fill_poly(masks[i], [np.round(q / s).astype(np.int32)])
            else:
                m = segm_to_bitmap(segm, ann["height"], ann["width"])
                m = resize_nearest(m, nh, nw)
                if flip:
                    m = m[:, ::-1]
                if s > 1:
                    m = resize_nearest(m, nh // s, nw // s)
                masks[i, :m.shape[0], :m.shape[1]] = m
        return masks


def _one_intraop_thread() -> None:
    """A loader worker's initializer: one intra-op thread for the
    worker's resize, so that N workers use N cores. PyTorch's OpenMP pool
    keeps the count per thread: a thread that has run an intra-op op
    already (the trainer's) keeps its own, threads started later take
    1."""
    torch.set_num_threads(1)


class DetectionLoader:
    """Batches a dataset through the train branch with repeat-factor and
    aspect-group epoch ordering; yields host numpy batch dicts, canvas-
    homogeneous, each with its ``image_ids``. ``num_workers`` threads
    build a batch's samples; with ``prefetch`` > 0 a producer thread
    builds up to that many batches ahead and re-raises a worker's error in
    the consumer. Closing the iterator (a break, an error, a step cap)
    stops the producer and the pool before it returns."""

    def __init__(self, dataset: CocoStyleDataset, pipeline: DetectionPipeline,
                 batch_size: int, oversample_thr: float = 0.0,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 3):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = prefetch
        if oversample_thr > 0:
            self.base_indices = expand_indices_by_repeat(
                repeat_factors(dataset, oversample_thr))
        else:
            self.base_indices = np.arange(len(dataset))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.base_indices) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return prefetch(self._batches, self.prefetch)

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.base_indices[group_epoch_order(
            self.dataset.flag[self.base_indices],
            np.arange(len(self.base_indices)), self.epoch, self.batch_size,
            self.seed)]
        base_rng = np.random.RandomState(self.seed + self.epoch)
        buckets = self.pipeline.buckets
        weights = np.array([len(b[1]) for b in buckets], np.float64)

        def one(args):
            i, sample_seed, scale_idx = args
            return self.pipeline.sample(
                read_image(self.dataset.image_path(int(i))),
                self.dataset.get_ann(int(i)),
                np.random.RandomState(sample_seed), scale_idx=scale_idx)

        with ThreadPoolExecutor(max_workers=self.num_workers,
                                initializer=_one_intraop_thread) as pool:
            for b0 in range(0, len(order) - self.batch_size + 1,
                            self.batch_size):
                idxs = order[b0:b0 + self.batch_size]
                seeds = base_rng.randint(0, 2 ** 31, size=len(idxs))
                if len(buckets) > 1:
                    # bucket by its scale count, then scales within it
                    bidx = base_rng.choice(len(buckets),
                                           p=weights / weights.sum())
                    scale_ids = base_rng.choice(buckets[bidx][1],
                                                size=len(idxs))
                else:
                    scale_ids = [None] * len(idxs)
                samples = list(pool.map(one, zip(idxs, seeds, scale_ids)))
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                batch["image_ids"] = np.array(
                    [self.dataset.img_infos[int(i)]["id"] for i in idxs])
                yield batch
