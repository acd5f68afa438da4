"""Detection eval CLI: port of ``iif_tpu/cli/test_det.py`` (the reference's
``instance_segmentation/tools/test.py``) for one process on one card::

    python -m iif_torch.cli.test_det configs/iif/iif_r50_1x.py \\
        WORK_DIR_OR_CKPT.pth [--eval bbox segm] [--out results.json] \\
        [--format-only] [--max-images N] [--tta] [--cfg-options k=v ...] \\
        [--device cuda]

It loads an mmdet ``.pth`` checkpoint (``iif_torch/utils/checkpoint.py``;
a work directory stands for its ``checkpoints/latest.pth``), runs the
detector over ``data.test`` in batches of ``data.samples_per_gpu`` (the
last padded by repeating its last image under id -1), pastes the masks
of the valid detections on the card and encodes them as compressed RLE
with the C++ codec, optionally dumps the COCO results json, and prints
each metric: bbox / segm AP under the COCO or LVIS protocol
(``detection/evaluation.py``), ``mAP`` (VOC) and ``proposal_fast``
(``detection/voc_eval.py``).

``--tta`` runs the aug-test (``detection/tta.py``) one image at a time
over the views ``cfg.tta.scales`` (else the config's last train scale),
each with and without a flip unless ``cfg.tta.flip`` is False
(``run_inference_tta``). With ``--exported`` or ``--eval PQ`` it exits as
JAX's does; HTC with masks and C4 raise ``NotImplementedError``, as JAX
fails on them.

Not ported, refused with ``NotImplementedError`` naming the flag:
``--exported``, ``--fuse-conv-bn``, ``--eval PQ`` and ``--show-dir``.
Evaluation runs in one process (no multi-host gather).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from iif_torch.config import Config, parse_cfg_options
from iif_torch.detection import simple_test
from iif_torch.detection.datasets import CocoStyleDataset, build_dataset
from iif_torch.detection.evaluation import (
    DetEvaluator,
    detections_to_coco_results,
)
from iif_torch.detection.image_io import read_image
from iif_torch.detection.inference import (
    Detector,
    _preprocess,
    init_detector,
    rescale_boxes,
)
from iif_torch.detection.mask_head import paste_masks
from iif_torch.detection.tta import aug_test, multi_scale_flip_views
from iif_torch.device import resolve_device
from iif_torch.native.rle_native import rle_encode_native


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="mmdet .pth checkpoint, or a work directory "
                        "(its checkpoints/latest.pth)")
    p.add_argument("--eval", nargs="+", default=["bbox"],
                   help="metrics: bbox segm proposal_fast mAP")
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--out", default=None, help="results json path")
    p.add_argument("--max-images", default=None, type=int)
    p.add_argument("--show-dir", default=None, help="not ported")
    p.add_argument("--show-score-thr", default=0.3, type=float)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--tta", action="store_true",
                   help="multi-scale + flip aug-test (merged proposals "
                        "re-scored on every view)")
    p.add_argument("--exported", default=None, help="not ported")
    p.add_argument("--fuse-conv-bn", action="store_true",
                   help="not ported")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """``SystemExit`` for ``--tta`` with ``--exported`` or ``--eval PQ``,
    with JAX's messages; ``NotImplementedError`` for the flags whose
    modules are not ported (``export.py``, ``models/fuse.py``,
    ``panoptic.py``, ``show_result``)."""
    if args.tta and args.exported:
        raise SystemExit("--tta and --exported are mutually exclusive "
                         "(the artifact is a fixed single-view program)")
    if args.tta and any(m.lower() == "pq" for m in args.eval):
        raise SystemExit("--eval PQ is not supported with --tta (the "
                         "panoptic fusion runs on the single-view path "
                         "only); drop --tta for PQ")
    unported = {"--exported": bool(args.exported),
                "--fuse-conv-bn": args.fuse_conv_bn,
                "--eval PQ": any(m.lower() == "pq" for m in args.eval),
                "--show-dir": bool(args.show_dir)}
    for flag, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{flag} is not ported")


def resolve_checkpoint(path: str) -> str:
    """A ``.pth`` file as it is; a work directory (or its ``checkpoints``)
    as the ``latest.pth`` inside."""
    if os.path.isfile(path):
        return path
    for cand in (os.path.join(path, "latest.pth"),
                 os.path.join(path, "checkpoints", "latest.pth")):
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"no checkpoint at {path}")


class _EvalLoader:
    """Sequential eval batches carrying image ids and original shapes:
    each image read (``read_image``: PNG without cv2) and put on the
    detector's canvas on its device (``inference._preprocess``); the last
    batch padded by repeating its last image under id -1."""

    def __init__(self, dataset: CocoStyleDataset, detector: Detector,
                 batch_size: int):
        self.dataset = dataset
        self.detector = detector
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        for b0 in range(0, n, self.batch_size):
            samples, ids, shapes = [], [], []
            for i in range(b0, min(b0 + self.batch_size, n)):
                sample, hw = _preprocess(
                    self.detector, read_image(self.dataset.image_path(i)))
                samples.append(sample)
                ids.append(self.dataset.img_infos[i]["id"])
                shapes.append(list(hw))
            while len(samples) < self.batch_size:   # pad the last batch
                samples.append(samples[-1])
                ids.append(-1)
                shapes.append(shapes[-1])
            yield {"image": torch.stack([s["image"] for s in samples]),
                   "img_shape": np.stack([s["img_shape"] for s in samples]),
                   "scale_factor": np.stack([s["scale_factor"]
                                             for s in samples]),
                   "image_ids": np.asarray(ids),
                   "orig_shape": np.asarray(shapes)}


def _pasted_masks(masks: torch.Tensor, boxes: torch.Tensor,
                  hw, threshold: float) -> np.ndarray:
    """Paste (R, S, S) mask probabilities into the (H, W) image frame on
    their device, and read the (R, H, W) bools back (into pinned memory
    from the card), each mask column-major (transposed on the device),
    the order RLE runs in."""
    pasted = paste_masks(masks, boxes, hw, threshold=threshold)
    pasted = pasted.transpose(1, 2)
    # a pinned buffer from the card: the copy skips the staging copy
    host = torch.empty(pasted.shape, dtype=torch.bool,
                       pin_memory=pasted.is_cuda)
    host.copy_(pasted)
    return host.numpy().transpose(0, 2, 1)


def encode_masks(masks: np.ndarray) -> List[Dict]:
    """(R, H, W) bools -> compressed RLE dicts (the C++ encoder; equal to
    ``mask_utils.rle_encode``)."""
    return [rle_encode_native(m) for m in masks]


@torch.inference_mode()
def run_inference(detector: Detector, loader, cat_ids, with_mask: bool,
                  max_images: Optional[int] = None) -> List[dict]:
    """COCO results records of ``detector`` over ``loader``'s batches.
    Boxes come back to the original frame by a true float32 division
    (``rescale_boxes``); masks are pasted and encoded for the valid
    detections of the real images only (the JAX package pastes every
    row and keeps the valid ones: the same records)."""
    run = simple_test.make_simple_test(detector.model, detector.loss_cls,
                                       detector.test_cfg)
    thr = detector.test_cfg.mask_thr_binary
    results: List[dict] = []
    n_done = 0
    for batch in loader:
        out = run(batch["image"])
        boxes_dev = rescale_boxes(out["boxes"],
                                  batch["scale_factor"][:, None, None])
        boxes = boxes_dev.cpu().numpy()
        valid = out["valid"].cpu().numpy()
        masks_rle = None
        if with_mask and "masks" in out:
            masks_rle = []
            for b, iid in enumerate(batch["image_ids"]):
                per_img: List[Optional[Dict]] = [None] * valid.shape[1]
                rows = np.flatnonzero(valid[b])
                if iid >= 0 and rows.size:
                    idx = torch.from_numpy(rows).to(boxes_dev.device)
                    h, w = (int(v) for v in batch["orig_shape"][b])
                    pasted = _pasted_masks(out["masks"][b][idx],
                                           boxes_dev[b][idx], (h, w), thr)
                    for r, rle in zip(rows, encode_masks(pasted)):
                        per_img[r] = rle
                masks_rle.append(per_img)
        results.extend(detections_to_coco_results(
            batch["image_ids"], boxes, out["scores"].cpu().numpy(),
            out["labels"].cpu().numpy(), valid, cat_ids, masks=masks_rle,
            mask_scores=(out["mask_scores"].cpu().numpy()
                         if "mask_scores" in out else None)))
        n_done += boxes.shape[0]
        if max_images and n_done >= max_images:
            break
    return results


def tta_views(cfg: Config) -> List[Dict[str, Any]]:
    """The aug-test's views (``cli/test_det.py:322-327``): each of
    ``cfg.tta.scales``, else the config's last train scale, with and
    without a flip (``cfg.tta.flip``, default True)."""
    tta_cfg = cfg.get("tta", {})
    scales = cfg.get("pipeline", {}).get("scales", [(1333, 800)])
    return multi_scale_flip_views(
        [tuple(s) for s in tta_cfg.get("scales", scales[-1:])],
        flip=tta_cfg.get("flip", True))


@torch.inference_mode()
def run_inference_tta(detector: Detector, dataset: CocoStyleDataset,
                      views: List[Dict[str, Any]], cat_ids, with_mask: bool,
                      max_images: Optional[int] = None) -> List[dict]:
    """COCO results records of the aug-test (``cli/test_det.py:177-230``),
    one image at a time: its ``views`` on one canvas as a batch
    (``DetectionPipeline.eval_view``), ``detection/tta.py::aug_test``,
    the detections already in the original frame; masks pasted and
    encoded for the valid detections."""
    dev = detector.device
    thr = detector.test_cfg.mask_thr_binary
    results: List[dict] = []
    for i in range(min(len(dataset), max_images or len(dataset))):
        img = read_image(dataset.image_path(i))
        samples = [detector.pipeline.eval_view(img, v["scale"], v["flip"],
                                               dev) for v in views]
        out = aug_test(
            detector.model, torch.stack([s["image"] for s in samples]),
            torch.tensor([s["scale_factor"] for s in samples],
                         dtype=torch.float32, device=dev),
            torch.tensor([bool(s["flip"]) for s in samples], device=dev),
            torch.tensor(np.stack([s["img_shape"] for s in samples]),
                         dtype=torch.float32, device=dev),
            detector.loss_cls, detector.test_cfg)
        valid = out["valid"].cpu().numpy()
        masks_rle = None
        if with_mask and "masks" in out:
            per_img: List[Optional[Dict]] = [None] * valid.shape[0]
            rows = np.flatnonzero(valid)
            if rows.size:
                idx = torch.from_numpy(rows).to(dev)
                pasted = _pasted_masks(out["masks"][idx], out["boxes"][idx],
                                       img.shape[:2], thr)
                for r, rle in zip(rows, encode_masks(pasted)):
                    per_img[r] = rle
            masks_rle = [per_img]
        results.extend(detections_to_coco_results(
            np.asarray([dataset.img_infos[i]["id"]]),
            out["boxes"].cpu().numpy()[None],
            out["scores"].cpu().numpy()[None],
            out["labels"].cpu().numpy()[None], valid[None], cat_ids,
            masks=masks_rle))
    return results


def build_evaluator(dataset: CocoStyleDataset, cfg: Config,
                    native: bool = True) -> DetEvaluator:
    """The COCO / LVIS evaluator of ``dataset`` at the config's
    ``test_cfg.max_per_img``."""
    gt_anns = [a for rec in dataset.img_infos for a in rec["anns"]]
    return DetEvaluator(
        dataset.img_infos, gt_anns, dataset.cat_ids,
        lvis=dataset.lvis_style, cat_image_counts=dataset.cat_image_counts,
        cat_frequency=dataset.cat_frequency,
        max_dets=cfg.get("test_cfg", {}).get("max_per_img", 100),
        native=native)


def _proposal_fast(test_ds: CocoStyleDataset, results: List[dict]
                   ) -> Dict[str, float]:
    """mmdet ``CocoDataset.evaluate('proposal_fast')``: class-agnostic
    AR@k of the results against the gt (``fast_eval_recall``)."""
    from iif_torch.detection.voc_eval import eval_recalls

    by_img: Dict[int, list] = {}
    for r in results:
        x, y, w, h = r["bbox"]
        by_img.setdefault(r["image_id"], []).append(
            [x, y, x + w, y + h, r["score"]])
    gts, props = [], []
    for rec in test_ds.img_infos:
        gts.append(np.asarray(
            [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
              a["bbox"][1] + a["bbox"][3]]
             for a in rec["anns"] if not a.get("iscrowd")],
            np.float32).reshape(-1, 4))
        p = np.asarray(by_img.get(rec["id"], []), np.float32).reshape(-1, 5)
        props.append(p[np.argsort(-p[:, 4])] if len(p) else p)
    nums = (100, 300, 1000)
    rec_mat = eval_recalls(gts, props, nums, np.arange(0.5, 0.96, 0.05))
    return {f"AR@{n}": float(a) for n, a in zip(nums, rec_mat.mean(axis=1))}


def _voc_map(test_ds: CocoStyleDataset, results: List[dict]
             ) -> Dict[str, Any]:
    """VOC protocol (reference ``VOCDataset.evaluate``): ``eval_map`` at
    IoU 0.5, '11points' for VOC2007, 'area' otherwise; crowd ('difficult')
    boxes as ignore regions."""
    from iif_torch.detection.voc_eval import eval_map

    num_classes = len(test_ds.CLASSES)
    id2idx = {rec["id"]: i for i, rec in enumerate(test_ds.img_infos)}
    det_results = [[np.zeros((0, 5), np.float32) for _ in range(num_classes)]
                   for _ in test_ds.img_infos]
    for r in results:
        i = id2idx.get(r["image_id"])
        if i is None:
            continue
        x, y, bw, bh = r["bbox"]
        c = test_ds.cat2label[r["category_id"]]
        det_results[i][c] = np.concatenate(
            [det_results[i][c],
             [[x, y, x + bw, y + bh, r["score"]]]]).astype(np.float32)
    annotations = []
    for idx in range(len(test_ds.img_infos)):
        ann = test_ds.get_ann(idx)
        annotations.append({"bboxes": ann["boxes"], "labels": ann["labels"],
                            "bboxes_ignore": ann["crowd_boxes"],
                            "labels_ignore": ann["crowd_labels"]})
    mode = "11points" if "VOC2007" in test_ds.img_prefix else "area"
    m, per_cls = eval_map(det_results, annotations, iou_thr=0.5, mode=mode)
    return {"mAP": m, "per_class": {test_ds.CLASSES[c]: r["ap"]
                                    for c, r in enumerate(per_cls)}}


def evaluate_metrics(dataset: CocoStyleDataset, cfg: Config,
                     results: List[dict], metrics: List[str],
                     prefix: Tuple[str, ...] = ()
                     ) -> Dict[str, Dict[str, Any]]:
    """Each of ``metrics`` over the COCO ``results`` against ``dataset``'s
    gt, printed after ``prefix`` as the JAX CLIs print it:
    ``proposal_fast`` (AR@k), ``mAP`` (VOC), and otherwise ``segm`` or
    ``bbox`` AP under the COCO or LVIS protocol; the results by metric."""
    ev = build_evaluator(dataset, cfg)
    out: Dict[str, Dict[str, Any]] = {}
    for metric in metrics:
        if metric == "proposal_fast":
            res = out[metric] = _proposal_fast(dataset, results)
            print(*prefix, metric, {k: round(v, 4) for k, v in res.items()})
        elif metric == "mAP":
            res = out[metric] = _voc_map(dataset, results)
            print(*prefix, metric, round(res["mAP"], 4),
                  {k: round(v, 4) for k, v in res["per_class"].items()})
        else:
            res = out[metric] = ev.evaluate(
                results, "segm" if metric == "segm" else "bbox")
            print(*prefix, metric, {k: round(v, 4) for k, v in res.items()})
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, Any]]:
    """Runs the evaluation; returns each metric's result by name."""
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(parse_cfg_options(args.cfg_options))

    test_ds = build_dataset({k: v for k, v in cfg.data["test"].items()
                             if k != "oversample_thr"})
    detector = init_detector(cfg, resolve_checkpoint(args.checkpoint),
                             device=device, dataset=test_ds)
    with_mask = cfg.model.get("with_mask", True)
    if args.tta:
        results = run_inference_tta(detector, test_ds, tta_views(cfg),
                                    test_ds.cat_ids, with_mask,
                                    max_images=args.max_images)
    else:
        loader = _EvalLoader(test_ds, detector,
                             cfg.data.get("samples_per_gpu", 4))
        results = run_inference(detector, loader, test_ds.cat_ids,
                                with_mask, max_images=args.max_images)
    if args.out or args.format_only:
        out = args.out or "results.json"
        with open(out, "w") as f:
            json.dump(results, f)
        print(f"wrote {len(results)} detections to {out}")
        if args.format_only:
            return {}

    return evaluate_metrics(test_ds, cfg, results, args.eval)

if __name__ == "__main__":
    main()
