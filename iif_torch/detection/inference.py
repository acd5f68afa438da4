"""Inference API: port of ``iif_tpu/detection/inference.py`` (``Detector``,
``init_detector``, ``inference_detector``, ``inference_detector_batch``,
``_postprocess``), the reference's ``mmdet/apis/inference.py``.

The model, the canvas and the mask paste-back all run on the detector's
device; results come back as numpy arrays in the original image frame.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from iif_torch.config import Config
from iif_torch.detection.datasets import build_dataset
from iif_torch.detection.detector import (
    DetTestCfg,
    build_detector,
    random_init_,
)
from iif_torch.detection.image_io import read_image
from iif_torch.detection.losses import (
    DetCrossEntropyLoss,
    DetIIFLoss,
    compute_det_iif_from_counts,
    load_iif_csv,
)
from iif_torch.detection.losses_extra import SEESAW_CUM_KEY, SeesawLoss
from iif_torch.detection.mask_head import paste_masks
from iif_torch.detection.pipeline import DetectionPipeline
from iif_torch.detection.simple_test import make_simple_test
from iif_torch.device import resolve_device


class Detector:
    """Bundles model + loss/test config + pipeline for repeated calls."""

    def __init__(self, model: torch.nn.Module, loss_cls,
                 test_cfg: DetTestCfg,
                 pipeline: DetectionPipeline, classes: List[str],
                 device: torch.device):
        self.model = model
        self.loss_cls = loss_cls
        self.test_cfg = test_cfg
        self.pipeline = pipeline
        self.CLASSES = classes
        self.device = device


def build_loss_cls(cfg_loss: Dict[str, Any], dataset, num_classes: int):
    """The classification loss as ``iif_tpu/cli/train_det.py:39-71``
    builds it (``DetIIFLoss``, ``SeesawLoss`` with its counts at 0, or
    the plain CE)."""
    kind = cfg_loss.get("type", "DetCrossEntropyLoss")
    if kind == "SeesawLoss":
        return SeesawLoss(torch.zeros(num_classes + 1),
                          p=cfg_loss.get("p", 0.8), q=cfg_loss.get("q", 2.0),
                          eps=cfg_loss.get("eps", 1e-2),
                          loss_weight=cfg_loss.get("loss_weight", 1.0))
    if kind == "DetIIFLoss":
        path = cfg_loss.get("path")
        variant = cfg_loss.get("variant", "raw")
        if path:
            w = load_iif_csv(path, variant)
        elif variant.endswith("_obj"):
            counts = dataset.class_instance_counts()
            w = compute_det_iif_from_counts(counts, int(counts.sum()),
                                            variant)
        else:
            # N = image corpus size (pre-filter), idf_1204.csv semantics
            counts = dataset.class_image_counts()
            total = getattr(dataset, "num_images_total", len(dataset))
            w = compute_det_iif_from_counts(counts, total, variant)
        if len(w) != num_classes + 1:
            raise ValueError(f"{len(w)} IIF weights for {num_classes} "
                             "classes + background")
        return DetIIFLoss(weights=w)
    if kind != "DetCrossEntropyLoss":
        raise NotImplementedError(f"loss {kind!r} is not ported")
    return DetCrossEntropyLoss(num_classes=num_classes,
                               use_sigmoid=cfg_loss.get("use_sigmoid", False))


def model_cfg_for_loss(model_cfg: Dict[str, Any], loss_cls
                        ) -> Dict[str, Any]:
    """``cfg.model`` as both JAX CLIs complete it from the loss
    (``cli/train_det.py:173-185``, ``cli/test_det.py:277-281``): Seesaw's
    classifier takes C+2 channels, ``cls_predictor="iif_normed"`` the
    loss's IIF weights. Seesaw with another family than MaskRCNN raises
    ``NotImplementedError`` (JAX threads its counts through
    ``maskrcnn_loss`` only)."""
    mcfg = dict(model_cfg)
    if isinstance(loss_cls, SeesawLoss):
        kind = mcfg.get("type", "MaskRCNN")
        if kind != "MaskRCNN":
            raise NotImplementedError(
                f"SeesawLoss with {kind} is not ported (JAX threads its "
                "counts through maskrcnn_loss only)")
        mcfg.setdefault("cls_channels", mcfg["num_classes"] + 2)
    if mcfg.get("cls_predictor") == "iif_normed":
        weights = getattr(loss_cls, "weights", None)
        if weights is None:
            raise ValueError("cls_predictor='iif_normed' needs the IIF "
                             "weights of a DetIIFLoss")
        mcfg["iif_weights"] = tuple(float(x) for x in
                                    np.asarray(weights.cpu()))
    return mcfg


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load an mmdet ``.pth`` (plain or runner checkpoint) by name;
    Seesaw's counts (``SEESAW_CUM_KEY``), which inference does not read,
    are left out."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    model.load_state_dict({k.replace("module.", ""): v
                           for k, v in ckpt.items()
                           if k != SEESAW_CUM_KEY})


def eval_pipeline(cfg: Config) -> DetectionPipeline:
    """The eval branch's pipeline of a config: its canvas, its first
    scale, keep-ratio."""
    pcfg = cfg.get("pipeline", {})
    return DetectionPipeline(
        canvas=tuple(pcfg.get("canvas", (800, 1344))),
        scales=[tuple(s) for s in pcfg.get("scales", [(1333, 800)])],
        keep_ratio=pcfg.get("keep_ratio", True))


def init_detector(config: Union[str, Config],
                  checkpoint: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  dataset=None) -> Detector:
    """Build a detector from a config path. Weights come from an mmdet
    ``.pth`` checkpoint, or are seeded random (seed 0) without one. The
    classes and the classification loss come from ``dataset``, else from
    the config's test set when its files exist (without them the plain
    CE, as in JAX, or ``SeesawLoss``, which needs no data). The model is
    completed from the loss as ``test_det`` completes it
    (``model_cfg_for_loss``): JAX's ``init_detector`` builds a Seesaw
    config's classifier with C+1 channels, which Seesaw's activation
    cannot split; the port follows ``test_det``'s C+2."""
    dev = resolve_device(device)
    cfg = config if not isinstance(config, str) else Config.fromfile(config)
    num_classes = cfg.model["num_classes"]

    ds_cfg = {k: v for k, v in cfg.data["test"].items()
              if k != "oversample_thr"}
    try:
        test_ds = dataset if dataset is not None else build_dataset(ds_cfg)
        classes = test_ds.CLASSES
        loss_cls = build_loss_cls(cfg.loss_cls, test_ds, num_classes)
    except FileNotFoundError:
        classes = [str(i) for i in range(num_classes)]
        loss_cls = (build_loss_cls(cfg.loss_cls, None, num_classes)
                    if cfg.loss_cls.get("type") == "SeesawLoss"
                    else DetCrossEntropyLoss(num_classes=num_classes))
    model = build_detector(model_cfg_for_loss(cfg.model, loss_cls))

    pipeline = eval_pipeline(cfg)
    if checkpoint:
        load_checkpoint(model, checkpoint)
    else:
        random_init_(model, torch.Generator().manual_seed(0))
    model.eval().to(dev)
    return Detector(model, loss_cls.to(dev),
                    DetTestCfg(**cfg.get("test_cfg", {})), pipeline,
                    classes, dev)


# ------------------------------------------------------------------ internals
def _preprocess(detector: Detector, image: Union[str, np.ndarray]
                ) -> Tuple[Dict[str, Any], Tuple[int, int]]:
    """Load one image and resize/pad it onto the static canvas."""
    if isinstance(image, str):
        image = read_image(image)
    h, w = image.shape[:2]
    return detector.pipeline(image, detector.device), (h, w)


def rescale_boxes(boxes: torch.Tensor, scale_factor) -> torch.Tensor:
    """Boxes on the canvas back to the original image frame: a true
    float32 division by the (float32) scale factor, as NumPy divides the
    JAX package's read-back boxes. The factor goes to the boxes' device as
    a tensor: PyTorch's CUDA division by a Python or CPU scalar multiplies
    by its reciprocal, an ulp off."""
    sf = torch.as_tensor(np.asarray(scale_factor, np.float32),
                         device=boxes.device)
    return boxes / sf


def _postprocess(detector: Detector, sample: Dict[str, Any],
                 out: Dict[str, torch.Tensor], hw: Tuple[int, int],
                 idx: int = 0, with_masks: bool = True
                 ) -> Dict[str, np.ndarray]:
    """Rescale to the original image frame and paste masks (on the
    device), then read back."""
    boxes = rescale_boxes(out["boxes"][idx], sample["scale_factor"])
    result = {
        "boxes": boxes.cpu().numpy(),
        "scores": out["scores"][idx].cpu().numpy(),
        "labels": out["labels"][idx].cpu().numpy(),
        "valid": out["valid"][idx].cpu().numpy(),
    }
    if "masks" in out and with_masks:
        result["masks"] = paste_masks(
            out["masks"][idx], boxes, hw,
            threshold=detector.test_cfg.mask_thr_binary).cpu().numpy()
    return result


def _run(detector: Detector, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    return make_simple_test(detector.model, detector.loss_cls,
                            detector.test_cfg)(images)


# ------------------------------------------------------------------- public
@torch.inference_mode()
def inference_detector(detector: Detector, image: Union[str, np.ndarray],
                       masks: bool = True) -> Dict[str, np.ndarray]:
    """Detect on one image (path or RGB array). Returns original-scale
    boxes/scores/labels/valid (+ full-size boolean masks unless
    ``masks=False``, which the serving path uses)."""
    sample, hw = _preprocess(detector, image)
    out = _run(detector, sample["image"][None])
    return _postprocess(detector, sample, out, hw, with_masks=masks)


@torch.inference_mode()
def inference_detector_batch(detector: Detector,
                             images: List[Union[str, np.ndarray]],
                             pad_to: Optional[int] = None,
                             masks: bool = True
                             ) -> List[Dict[str, np.ndarray]]:
    """Detect on several images in one batched pass. ``pad_to`` fixes the
    batch size by repeating the last canvas (results for the padding rows
    are dropped)."""
    if not images:
        return []
    pre = [_preprocess(detector, img) for img in images]
    n = len(pre)
    reps = [1] * n
    if pad_to is not None and pad_to > n:
        reps[-1] += pad_to - n
    batch = torch.cat([s["image"][None].expand(r, -1, -1, -1)
                       for (s, _), r in zip(pre, reps)], 0)
    out = _run(detector, batch)
    return [_postprocess(detector, s, out, hw, idx=i, with_masks=masks)
            for i, (s, hw) in enumerate(pre)]
