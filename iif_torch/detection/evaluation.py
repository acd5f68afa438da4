"""COCO / LVIS detection & instance-segmentation evaluation: port of
``iif_tpu/detection/evaluation.py``, NumPy with the port's C++ matcher and
mask IoU (``iif_torch/native``), in the JAX module's op order (stable
sorts, float64), so its AP dicts equal the JAX package's bit for bit.

From-scratch replacement for pycocotools ``COCOeval`` and the lvis-api
``LVISEval`` the reference invokes (``mmdet/datasets/lvis.py:309-470``,
``coco.py:362``): greedy score-ordered matching per (category, image) at 10
IoU thresholds, 101-point interpolated AP, area-range breakdowns, and the
LVIS protocol extras — per-category evaluation restricted to images where
the category is positively or negatively annotated, AP_r/AP_c/AP_f buckets
by training image_count (rare <10, common 10-100, frequent >100), and
max_dets=300.

Detections arrive as a flat list of dicts:
``{image_id, category_id, bbox [x,y,w,h], score, segmentation?}`` —
exactly the COCO results-json schema the reference's ``results2json``
emits, so dumps are interchangeable.

``native=False`` (``DetEvaluator``) runs the plain versions instead: the
pure-Python greedy matcher ``_greedy_match_py`` and the NumPy mask IoU
``mask_utils.rle_iou``; both give the same bits. The C++ libraries build
at first use and raise when they cannot; nothing falls back.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from iif_torch.detection.mask_utils import (
    rle_encode,
    rle_iou,
    segm_to_bitmap,
)
from iif_torch.native.eval_native import (
    greedy_match_batch_native,
    greedy_match_native,
)
from iif_torch.native.rle_native import rle_area_native, rle_iou_native

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _box_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU for xywh boxes; crowd gt uses IoF (pycocotools)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None])
    iy1 = np.maximum(dy1[:, None], gy1[None])
    ix2 = np.minimum(dx2[:, None], gx2[None])
    iy2 = np.minimum(dy2[:, None], gy2[None])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = dt[:, 2] * dt[:, 3]
    g_area = gt[:, 2] * gt[:, 3]
    union = np.where(iscrowd[None, :], d_area[:, None],
                     d_area[:, None] + g_area[None] - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


class _ImgCatResult:
    __slots__ = ("dt_scores", "dt_matched", "dt_ignore", "n_gt")

    def __init__(self, dt_scores, dt_matched, dt_ignore, n_gt):
        self.dt_scores = dt_scores      # (D,)
        self.dt_matched = dt_matched    # (T, D) bool: matched a real gt
        self.dt_ignore = dt_ignore      # (T, D) bool
        self.n_gt = n_gt                # non-ignored gt count


def _greedy_match_py(ious: np.ndarray, g_ignore: np.ndarray,
                     iscrowd: np.ndarray,
                     iou_thrs: np.ndarray) -> np.ndarray:
    """Pure-Python greedy matcher: (T, D) matched-gt index, -1 = none.

    Gts must arrive sorted real-first (``g_ignore`` ascending). Rules
    (pycocotools/lvis-api semantics):
    - only CROWD gts may be matched by multiple detections;
    - once the current best is a real gt, ignored gts cannot displace
      it (the sort order makes a ``break`` correct);
    - strict improvement only — an equal IoU does not switch gts.
    """
    D, G = ious.shape
    T = len(iou_thrs)
    out = np.full((T, D), -1, np.int64)
    for t, thr in enumerate(iou_thrs):
        g_taken = np.zeros(G, bool)
        thr0 = min(float(thr), 1 - 1e-10)
        for d in range(D):
            best, best_g = thr0, -1
            row = ious[d]
            for g in range(G):
                if g_taken[g] and not iscrowd[g]:
                    continue
                if best_g > -1 and not g_ignore[best_g] and g_ignore[g]:
                    break
                if row[g] < best:
                    continue
                best = row[g]
                best_g = g
            out[t, d] = best_g
            if best_g >= 0:
                g_taken[best_g] = True
    return out


def _greedy_match(ious: np.ndarray, g_ignore: np.ndarray,
                  iscrowd: np.ndarray, iou_thrs: np.ndarray,
                  native: bool = True) -> np.ndarray:
    match = greedy_match_native if native else _greedy_match_py
    return match(ious, g_ignore, iscrowd, iou_thrs)


def _mask_iou(dts: List[dict], gts: List[dict], iscrowd: np.ndarray,
              native: bool = True) -> np.ndarray:
    iou = rle_iou_native if native else rle_iou
    return np.asarray(iou(
        [d["segmentation"] for d in dts],
        [g["segmentation"] for g in gts],
        [bool(c) for c in iscrowd])).reshape(len(dts), len(gts))


def _flags_from_match(best_g: np.ndarray, g_ignore: np.ndarray,
                      unmatched_ignore: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Derive (dt_matched, dt_ignore) (T, D) bools from matched indices."""
    matched = best_g >= 0
    if g_ignore.size:
        gi = g_ignore[np.clip(best_g, 0, None)] & matched
    else:
        gi = np.zeros_like(matched)
    dt_matched = matched & ~gi
    dt_ignore = np.where(matched, gi, unmatched_ignore[None, :])
    return dt_matched, dt_ignore


def _evaluate_img_cat(dts: List[dict], gts: List[dict], iou_type: str,
                      area_rng: Tuple[float, float], max_dets: int,
                      nel: bool = False,
                      iou_thrs: np.ndarray = IOU_THRS,
                      native: bool = True
                      ) -> Optional[_ImgCatResult]:
    """``nel``: category not exhaustively annotated in this image — the
    LVIS protocol then ignores UNMATCHED detections instead of counting
    them as FPs (lvis-api eval semantics). Area ranges are closed
    intervals, matching pycocotools' ``a < rng[0] or a > rng[1]``."""
    if not dts and not gts:
        return None
    # gt ignore flags: crowd or outside area range
    g_ignore = np.array([
        bool(g.get("iscrowd", 0)) or g.get("ignore", False)
        or not (area_rng[0] <= g.get("area", g["bbox"][2] * g["bbox"][3])
                <= area_rng[1])
        for g in gts], bool)
    order_g = np.argsort(g_ignore, kind="stable")  # real gts first
    gts = [gts[i] for i in order_g]
    g_ignore = g_ignore[order_g]

    dts = sorted(dts, key=lambda d: -d["score"])[:max_dets]
    dt_scores = np.array([d["score"] for d in dts])

    if iou_type == "segm":
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        ious = _mask_iou(dts, gts, iscrowd, native)
    else:
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        ious = _box_iou_xywh(
            np.array([d["bbox"] for d in dts]).reshape(-1, 4),
            np.array([g["bbox"] for g in gts]).reshape(-1, 4), iscrowd)

    # unmatched dt outside the area range (or on a not-exhaustively-
    # annotated image, LVIS) is ignored rather than counted as a FP
    dt_area = np.array([
        d["area"] if iou_type == "segm" and "area" in d
        else d["bbox"][2] * d["bbox"][3] for d in dts])
    unmatched_ignore = np.full(len(dts), bool(nel)) | (
        ~((area_rng[0] <= dt_area) & (dt_area <= area_rng[1]))
        if len(dts) else np.zeros(0, bool))

    best_g = _greedy_match(ious, g_ignore, iscrowd,
                           np.asarray(iou_thrs, np.float64), native)
    dt_matched, dt_ignore = _flags_from_match(best_g, g_ignore,
                                              unmatched_ignore)
    return _ImgCatResult(dt_scores, dt_matched, dt_ignore,
                         int((~g_ignore).sum()))


class _PairCache:
    """Area-range-independent per-(img, cat) state, computed once and
    reused by all four area-range matchings in ``DetEvaluator.evaluate``."""
    __slots__ = ("dt_scores", "dt_area", "ious", "g_base", "g_area",
                 "iscrowd", "nel")

    def __init__(self, dt_scores, dt_area, ious, g_base, g_area,
                 iscrowd, nel):
        self.dt_scores = dt_scores  # (D,) descending
        self.dt_area = dt_area      # (D,)
        self.ious = ious            # (D, G) in ORIGINAL gt order
        self.g_base = g_base        # (G,) crowd/explicit-ignore flags
        self.g_area = g_area        # (G,)
        self.iscrowd = iscrowd      # (G,)
        self.nel = nel              # bool


def _prep_pair(dts: List[dict], gts: List[dict], iou_type: str,
               max_dets: int, nel: bool, native: bool = True
               ) -> _PairCache:
    dts = sorted(dts, key=lambda d: -d["score"])[:max_dets]
    dt_scores = np.array([d["score"] for d in dts])
    dt_area = np.array([
        d["area"] if iou_type == "segm" and "area" in d
        else d["bbox"][2] * d["bbox"][3] for d in dts])
    g_base = np.array([
        bool(g.get("iscrowd", 0)) or g.get("ignore", False)
        for g in gts], bool)
    g_area = np.array([g.get("area", g["bbox"][2] * g["bbox"][3])
                       for g in gts])
    iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
    if iou_type == "segm":
        ious = _mask_iou(dts, gts, iscrowd, native)
    else:
        ious = _box_iou_xywh(
            np.array([d["bbox"] for d in dts]).reshape(-1, 4),
            np.array([g["bbox"] for g in gts]).reshape(-1, 4), iscrowd)
    return _PairCache(dt_scores, dt_area, ious, g_base, g_area,
                      iscrowd, bool(nel))


def _match_pair(p: _PairCache, area_rng: Tuple[float, float],
                iou_thrs: np.ndarray, native: bool = True
                ) -> _ImgCatResult:
    """Match one cached pair under one area range (closed interval,
    matching pycocotools' ``a < rng[0] or a > rng[1]`` ignore rule)."""
    g_ignore = p.g_base | ~((area_rng[0] <= p.g_area)
                            & (p.g_area <= area_rng[1]))
    order = np.argsort(g_ignore, kind="stable")  # real gts first
    g_ignore = g_ignore[order]
    ious = p.ious[:, order]
    iscrowd = p.iscrowd[order]
    unmatched_ignore = np.full(len(p.dt_scores), p.nel) | ~(
        (area_rng[0] <= p.dt_area) & (p.dt_area <= area_rng[1]))
    best_g = _greedy_match(ious, g_ignore, iscrowd,
                           np.asarray(iou_thrs, np.float64), native)
    dt_matched, dt_ignore = _flags_from_match(best_g, g_ignore,
                                              unmatched_ignore)
    return _ImgCatResult(p.dt_scores, dt_matched, dt_ignore,
                         int((~g_ignore).sum()))


def _eval_cat(pairs: List["_PairCache"], native: bool = True
              ) -> Dict[str, np.ndarray]:
    """Per-category precision arrays for every area range.

    Batches all of the category's (img, cat) pairs into one native
    matcher call per area range (per-pair Python dispatch costs more
    than the matching itself at COCO/LVIS scale); ``native=False`` takes
    the per-pair path of the plain Python matcher instead (the JAX
    package's path without a compiler), with the same bits.
    """
    T = len(IOU_THRS)
    if not pairs:
        empty = (-np.ones((T, len(REC_THRS))), -np.ones(T))
        return {a: empty[0] for a in AREA_RANGES}
    if not native:
        return {area_name: _accumulate([
            _match_pair(p, rng, IOU_THRS, native=False) for p in pairs])[0]
            for area_name, rng in AREA_RANGES.items()}

    d_cnt = np.array([len(p.dt_scores) for p in pairs], np.int64)
    g_cnt = np.array([p.g_base.size for p in pairs], np.int64)
    d_off = np.concatenate([[0], np.cumsum(d_cnt)[:-1]]).astype(np.int64)
    g_off = np.concatenate([[0], np.cumsum(g_cnt)[:-1]]).astype(np.int64)
    sizes = d_cnt * g_cnt
    iou_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    ious_flat = (np.concatenate([p.ious.ravel() for p in pairs])
                 if sizes.sum() else np.zeros(0))
    scores = (np.concatenate([p.dt_scores for p in pairs])
              if d_cnt.sum() else np.zeros(0))
    dt_area = (np.concatenate([p.dt_area for p in pairs])
               if d_cnt.sum() else np.zeros(0))
    nel_dt = (np.concatenate([np.full(len(p.dt_scores), p.nel)
                              for p in pairs])
              if d_cnt.sum() else np.zeros(0, bool))
    g_base = (np.concatenate([p.g_base for p in pairs])
              if g_cnt.sum() else np.zeros(0, bool))
    g_area = (np.concatenate([p.g_area for p in pairs])
              if g_cnt.sum() else np.zeros(0))
    iscrowd = (np.concatenate([p.iscrowd for p in pairs])
               if g_cnt.sum() else np.zeros(0, bool))

    out = {}
    for area_name, rng in AREA_RANGES.items():
        g_ignore = g_base | ~((rng[0] <= g_area) & (g_area <= rng[1]))
        uig = nel_dt | ~((rng[0] <= dt_area) & (dt_area <= rng[1]))
        matched, ignored = greedy_match_batch_native(
            ious_flat, iou_off, d_cnt, g_cnt, d_off, g_off,
            g_ignore, iscrowd, uig, IOU_THRS)
        prec, _ = _accumulate_flat(scores, matched, ignored,
                                   int((~g_ignore).sum()))
        out[area_name] = prec
    return out


def _accumulate(results: List[_ImgCatResult],
                n_thrs: int = len(IOU_THRS)
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-category precision (T, R) and recall (T,) arrays."""
    results = [r for r in results if r is not None]
    if not results:
        return -np.ones((n_thrs, len(REC_THRS))), -np.ones(n_thrs)
    return _accumulate_flat(
        np.concatenate([r.dt_scores for r in results]),
        np.concatenate([r.dt_matched for r in results], axis=1),
        np.concatenate([r.dt_ignore for r in results], axis=1),
        sum(r.n_gt for r in results), n_thrs)


def _accumulate_flat(scores: np.ndarray, matched: np.ndarray,
                     ignored: np.ndarray, n_gt: int,
                     n_thrs: int = len(IOU_THRS)
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``_accumulate`` on pre-concatenated (T, N) arrays."""
    T, R = n_thrs, len(REC_THRS)
    precision = -np.ones((T, R))
    recall = -np.ones(T)
    if n_gt == 0:
        return precision, recall
    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]

    for t in range(T):
        m = matched[t][~ignored[t]]
        tp = np.cumsum(m)
        fp = np.cumsum(~m)
        if len(tp) == 0:
            precision[t] = 0.0
            recall[t] = 0.0
            continue
        rc = tp / n_gt
        pr = tp / np.maximum(tp + fp, 1e-10)
        recall[t] = rc[-1]
        # monotone non-increasing envelope
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(R)
        valid = inds < len(pr)
        q[valid] = pr[inds[valid]]
        precision[t] = q
    return precision, recall


class DetEvaluator:
    """COCO/LVIS-style evaluator.

    Parameters
    ----------
    gt_images: list of dicts {id, width, height, neg_category_ids,
        not_exhaustive_category_ids}
    gt_anns: list of COCO-format annotation dicts (bbox xywh,
        category_id, iscrowd, area, segmentation for segm eval)
    cat_ids: evaluated category ids
    lvis: enable the LVIS protocol (per-category image restriction +
        rare/common/frequent buckets from ``cat_image_counts``)
    native: match with the C++ matcher and take mask IoU from the C++
        run intersection (``iif_torch/native``); False runs the plain
        Python matcher and the NumPy IoU, with the same results
    """

    def __init__(self, gt_images: List[dict], gt_anns: List[dict],
                 cat_ids: Sequence[int], lvis: bool = False,
                 cat_image_counts: Optional[Dict[int, int]] = None,
                 max_dets: int = 100,
                 cat_frequency: Optional[Dict[int, str]] = None,
                 native: bool = True):
        self.cat_ids = list(cat_ids)
        self.native = native
        self.lvis = lvis
        self.max_dets = max_dets
        self.cat_image_counts = cat_image_counts or {}
        # dataset-provided LVIS v1 'frequency' field ('r'/'c'/'f'),
        # preferred over recomputing buckets from image_count
        self.cat_frequency = cat_frequency or {}
        self.img_ids = [im["id"] for im in gt_images]
        self.imgs = {im["id"]: im for im in gt_images}
        self.gt_by_img_cat: Dict[Tuple, List[dict]] = defaultdict(list)
        for a in gt_anns:
            self.gt_by_img_cat[(a["image_id"], a["category_id"])].append(a)
        if lvis:
            # category c is evaluated on image I iff c is positively
            # annotated in I or listed in I's neg_category_ids
            self.pos_cats = defaultdict(set)
            for a in gt_anns:
                self.pos_cats[a["image_id"]].add(a["category_id"])

    def _gt_segms_to_rle(self) -> None:
        """Normalize gt segmentations (polygons / raw-counts RLE) to
        compressed RLE once, in place."""
        for anns in self.gt_by_img_cat.values():
            for a in anns:
                segm = a.get("segmentation")
                if segm is None or (isinstance(segm, dict)
                                    and "size" in segm):
                    continue
                im = self.imgs[a["image_id"]]
                a["segmentation"] = rle_encode(
                    segm_to_bitmap(segm, im["height"], im["width"]))

    def _img_list(self, cat_id: int) -> List[int]:
        if not self.lvis:
            return self.img_ids
        out = []
        for iid in self.img_ids:
            im = self.imgs[iid]
            if cat_id in self.pos_cats.get(iid, ()) or \
                    cat_id in im.get("neg_category_ids", ()):
                out.append(iid)
        return out

    def evaluate(self, detections: List[dict], iou_type: str = "bbox"
                 ) -> Dict[str, float]:
        if iou_type == "segm":
            self._gt_segms_to_rle()
            # Mask Scoring R-CNN: segm records carry a dedicated
            # 'mask_score' (det score x predicted mask IoU) — mmdet's
            # segm2json uses it as the segm score when present
            if any("mask_score" in d for d in detections):
                detections = [dict(d, score=d.get("mask_score", d["score"]))
                              for d in detections]
        dt_by_img_cat: Dict[Tuple, List[dict]] = defaultdict(list)
        for d in detections:
            dt_by_img_cat[(d["image_id"], d["category_id"])].append(d)

        per_cat_prec = {}   # cat -> (T, R) for area 'all'
        per_area_prec = {a: [] for a in AREA_RANGES}
        for cat in self.cat_ids:
            imgs = self._img_list(cat)
            # IoU matrices, score sort, and area vectors are shared by
            # all four area ranges — compute them once per (img, cat)
            # pair with any content (lvis-api computes per-pair ious
            # once, too; pairs with neither dts nor gts contribute
            # nothing to precision/recall and are skipped outright)
            pairs = []
            for iid in imgs:
                dts = dt_by_img_cat.get((iid, cat), [])
                gts = self.gt_by_img_cat.get((iid, cat), [])
                if not dts and not gts:
                    continue
                nel = self.lvis and cat in self.imgs[iid].get(
                    "not_exhaustive_category_ids", ())
                pairs.append(_prep_pair(dts, gts, iou_type,
                                        self.max_dets, nel, self.native))
            for area_name, prec in _eval_cat(pairs, self.native).items():
                if area_name == "all":
                    per_cat_prec[cat] = prec
                per_area_prec[area_name].append(prec)

        def _ap(precs: List[np.ndarray], t_slice=slice(None)) -> float:
            vals = []
            for p in precs:
                v = p[t_slice]
                v = v[v > -1]
                if v.size:
                    vals.append(v.mean())
            return float(np.mean(vals)) if vals else float("nan")

        out = {
            "AP": _ap(list(per_cat_prec.values())),
            "AP50": _ap(list(per_cat_prec.values()), slice(0, 1)),
            "AP75": _ap(list(per_cat_prec.values()), slice(5, 6)),
            "APs": _ap(per_area_prec["small"]),
            "APm": _ap(per_area_prec["medium"]),
            "APl": _ap(per_area_prec["large"]),
        }
        if self.lvis:
            buckets = {"r": [], "c": [], "f": []}
            for cat in self.cat_ids:
                b = self.cat_frequency.get(cat)
                if b not in ("r", "c", "f"):
                    n = self.cat_image_counts.get(cat, 0)
                    # LVIS: rare 1-10 images, common 11-100, frequent >100
                    b = "r" if n <= 10 else ("c" if n <= 100 else "f")
                buckets[b].append(per_cat_prec[cat])
            out["APr"] = _ap(buckets["r"])
            out["APc"] = _ap(buckets["c"])
            out["APf"] = _ap(buckets["f"])
        return out

    def error_analysis(self, detections: List[dict],
                       iou_type: str = "bbox") -> Dict[str, Dict[str, float]]:
        """COCO error analysis (``tools/analysis_tools/
        coco_error_analysis.py`` semantics, minus the supercategory
        Sim/Oth stages which need COCO supercats): per category the AP at
        progressively forgiving settings —

        - C75 / C50: AP at IoU 0.75 / 0.50
        - Loc:  AP at IoU 0.10 (localization errors forgiven)
        - BG:   Loc + unmatched detections ignored (background FPs
                forgiven; only missed GTs remain)
        - FN:   1.0 (all remaining error is false negatives)

        Returns {"per_category": {cat_id: {...}}, "mean": {...}};
        stacked-bar deltas between consecutive stages are each error
        mode's contribution.
        """
        if iou_type == "segm":
            self._gt_segms_to_rle()
        dt_by_img_cat: Dict[Tuple, List[dict]] = defaultdict(list)
        dt_by_img: Dict[int, List[dict]] = defaultdict(list)
        for d in detections:
            dt_by_img_cat[(d["image_id"], d["category_id"])].append(d)
            dt_by_img[d["image_id"]].append(d)

        thrs = np.array([0.75, 0.50, 0.10])
        rng = AREA_RANGES["all"]
        per_cat: Dict[int, Dict[str, float]] = {}

        def _ap1(precs: np.ndarray) -> float:
            v = precs[precs > -1]
            return float(v.mean()) if v.size else float("nan")

        for cat in self.cat_ids:
            imgs = self._img_list(cat)
            res = [_evaluate_img_cat(
                dt_by_img_cat.get((iid, cat), []),
                self.gt_by_img_cat.get((iid, cat), []),
                iou_type, rng, self.max_dets, iou_thrs=thrs,
                native=self.native)
                for iid in imgs]
            prec, _ = _accumulate(res, n_thrs=len(thrs))
            # BG: IoU 0.1 with every unmatched detection ignored (the
            # ``nel`` flag ignores unmatched dts — exactly the BG stage)
            res_bg = [_evaluate_img_cat(
                dt_by_img_cat.get((iid, cat), []),
                self.gt_by_img_cat.get((iid, cat), []),
                iou_type, rng, self.max_dets, nel=True,
                iou_thrs=thrs[2:], native=self.native)
                for iid in imgs]
            prec_bg, _ = _accumulate(res_bg, n_thrs=1)
            per_cat[cat] = {
                "C75": _ap1(prec[0]),
                "C50": _ap1(prec[1]),
                "Loc": _ap1(prec[2]),
                "BG": _ap1(prec_bg[0]),
                "FN": 1.0,
            }
        keys = ("C75", "C50", "Loc", "BG", "FN")
        mean = {k: float(np.nanmean([c[k] for c in per_cat.values()]))
                for k in keys}
        return {"per_category": per_cat, "mean": mean}


def detections_to_coco_results(
    image_ids: Sequence[int],
    boxes: np.ndarray,        # (B, K, 4) xyxy, input-image scale already undone
    scores: np.ndarray,       # (B, K)
    labels: np.ndarray,       # (B, K)
    valid: np.ndarray,        # (B, K)
    cat_ids: Sequence[int],
    masks: Optional[Sequence] = None,   # (B, K) of RLE dicts (optional)
    mask_scores: Optional[np.ndarray] = None,  # (B, K) MS-RCNN segm scores
) -> List[dict]:
    """Fixed-shape device outputs -> COCO results-json records
    (``results2json`` equivalent). A mask's area comes from the C++ codec
    (``rle_area_native``, equal to ``mask_area``; the Python decode of
    300 masks an image would cost more than the encode)."""
    out = []
    for b, iid in enumerate(image_ids):
        if iid < 0:  # padded eval-batch slot
            continue
        for k in range(boxes.shape[1]):
            if not valid[b, k]:
                continue
            x1, y1, x2, y2 = boxes[b, k].tolist()
            rec = {
                "image_id": int(iid),
                "category_id": int(cat_ids[int(labels[b, k])]),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": float(scores[b, k]),
            }
            if masks is not None:
                rec["segmentation"] = masks[b][k]
                # pycocotools computes dt area from the MASK for segm
                # eval's area-range ignore logic, not from the box
                rec["area"] = rle_area_native(masks[b][k])
                if mask_scores is not None:
                    rec["mask_score"] = float(mask_scores[b, k])
            out.append(rec)
    return out
