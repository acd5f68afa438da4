"""Generic VOC-style mean AP + proposal recalls: port of
``iif_tpu/detection/voc_eval.py`` (NumPy, the same op order), for
``test_det --eval mAP`` and ``--eval proposal_fast``.

Rebuild of ``mmdet/core/evaluation/mean_ap.py:297`` (`eval_map`) and
``recall.py`` (`eval_recalls`) — the evaluation path of ``CustomDataset``
for non-COCO datasets, numpy throughout.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> float:
    """'area' = COCO-style envelope integration; '11points' = VOC07."""
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        prec = precisions[recalls >= t]
        ap += (prec.max() if prec.size else 0.0) / 11.0
    return float(ap)


def eval_map(
    det_results: List[List[np.ndarray]],   # [img][cls] -> (n, 5) box+score
    annotations: List[Dict[str, np.ndarray]],  # {bboxes, labels[,
    #  bboxes_ignore, labels_ignore]} — ignore = VOC 'difficult' regions
    iou_thr: float = 0.5,
    mode: str = "area",
) -> Tuple[float, List[Dict]]:
    """Per-class VOC mAP. Returns (mAP, per-class results).

    Ignore semantics follow ``mean_ap.py:62-168`` (`tpfp_default`): a
    detection whose best-IoU match is an ignore region counts as
    neither TP nor FP, and ignore regions don't count toward num_gts.
    """
    num_classes = len(det_results[0]) if det_results else 0
    eval_results = []
    for c in range(num_classes):
        scores_all, tp_all, fp_all, n_gt = [], [], [], 0
        for dets, ann in zip(det_results, annotations):
            gt = ann["bboxes"][ann["labels"] == c].reshape(-1, 4)
            ig = ann.get("bboxes_ignore",
                         np.empty((0, 4), np.float32)).reshape(-1, 4)
            ig_labels = ann.get("labels_ignore")
            if ig_labels is not None:
                ig = ig[np.asarray(ig_labels) == c].reshape(-1, 4)
            n_gt += len(gt)
            d = dets[c].reshape(-1, 5)
            order = np.argsort(-d[:, 4])
            d = d[order]
            all_gt = np.vstack([gt, ig])
            is_ignore = np.concatenate(
                [np.zeros(len(gt), bool), np.ones(len(ig), bool)])
            matched = np.zeros(len(all_gt), bool)
            tp = np.zeros(len(d))
            fp = np.zeros(len(d))
            if len(all_gt) and len(d):
                ious = _iou_xyxy(d[:, :4], all_gt)
                for i in range(len(d)):
                    j = ious[i].argmax()
                    if ious[i, j] >= iou_thr:
                        if is_ignore[j]:
                            pass        # matched a difficult region
                        elif not matched[j]:
                            matched[j] = True
                            tp[i] = 1
                        else:
                            fp[i] = 1   # duplicate on a covered gt
                    else:
                        fp[i] = 1
            else:
                fp[:] = 1
            scores_all.append(d[:, 4])
            tp_all.append(tp)
            fp_all.append(fp)
        scores = np.concatenate(scores_all) if scores_all else np.empty(0)
        tps = np.concatenate(tp_all) if tp_all else np.empty(0)
        fps = np.concatenate(fp_all) if fp_all else np.empty(0)
        order = np.argsort(-scores)
        tps = tps[order]
        fps = fps[order]
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(fps)
        recalls = tp_cum / max(n_gt, 1)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
        ap = average_precision(recalls, precisions, mode) if n_gt else 0.0
        eval_results.append({"num_gts": n_gt, "num_dets": len(scores),
                             "ap": ap,
                             "recall": recalls[-1] if len(recalls) else 0.0})
    valid = [r["ap"] for r in eval_results if r["num_gts"] > 0]
    return float(np.mean(valid)) if valid else 0.0, eval_results


def eval_recalls(
    gts: List[np.ndarray],                # per-image (g, 4)
    proposals: List[np.ndarray],          # per-image (p, 4) or (p, 5)
    proposal_nums: Sequence[int] = (100, 300, 1000),
    iou_thrs: Sequence[float] = (0.5,),
) -> np.ndarray:
    """Proposal recall matrix (len(nums), len(thrs)) — mmdet
    ``eval_recalls``."""
    out = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(len(g) for g in gts)
    for ni, n in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for gt, prop in zip(gts, proposals):
                if len(gt) == 0:
                    continue
                p = prop[:n, :4]
                if len(p) == 0:
                    continue
                ious = _iou_xyxy(gt, p)
                hit += int((ious.max(axis=1) >= thr).sum())
            out[ni, ti] = hit / max(total_gt, 1)
    return out
