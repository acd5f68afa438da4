"""Fixed-size NMS: port of ``iif_tpu/ops/nms.py`` (``nms``,
``batched_nms``, ``multiclass_nms``) in plain PyTorch.

Same blocked greedy formulation as the JAX package: sort by score, then per
block of ``block`` boxes, suppression by kept boxes of earlier blocks is
one matrix op, and suppression inside the block is a fixpoint over the
strict lower-triangular IoU. Every function takes leading batch dimensions
(the JAX package ``vmap``s them), so one fixpoint loop serves a whole
batch.

Each fixpoint iteration asks the host whether anything changed: that is
one host sync, counted in ``nms.host_syncs``.

Ties: ``top_k`` and the sort are stable, so equal scores keep index order
as ``jax.lax.top_k`` and ``jnp.argsort`` do.
"""
from __future__ import annotations

from typing import Tuple

import torch

from iif_torch.ops.boxes import bbox_overlaps


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, equal values in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) indexed along axis 1 by idx (B, K)."""
    if x.dim() == idx.dim():
        return torch.gather(x, 1, idx)
    tail = x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return torch.gather(x, 1, full)


BLOCK = 128


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS with blocked suppression, ``BLOCK`` boxes a block.

    boxes (..., N, 4), scores (..., N); a score of -inf never survives.
    Returns (keep_mask, order): ``keep_mask[..., i]`` marks survivors of
    the score-sorted sweep, aligned with the sorted ``order``."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    bsz = scores.shape[0]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = _take(boxes, order)
    scores_s = _take(scores, order)
    b = min(BLOCK, n)
    n_blocks = -(-n // b)
    pad = n_blocks * b - n
    if pad:
        boxes_s = torch.cat(
            [boxes_s, boxes_s.new_zeros((bsz, pad, 4))], 1)
        scores_s = torch.cat(
            [scores_s, scores_s.new_full((bsz, pad), float("-inf"))], 1)
    keep = scores_s > float("-inf")
    valid0 = keep.clone()
    tri = torch.triu(torch.ones((b, b), dtype=torch.bool,
                                device=scores.device), diagonal=1)
    for bi in range(n_blocks):
        lo = bi * b
        hi = lo + b
        rows = bbox_overlaps(boxes_s[:, lo:hi], boxes_s[:, :hi])  # (B,b,hi)
        over = rows > iou_threshold
        # suppression by kept boxes in earlier blocks
        sup_prev = (over[:, :, :lo] & keep[:, None, :lo]).any(-1)
        active = valid0[:, lo:hi] & ~sup_prev
        # within-block fixpoint: [i, j] means i suppresses j
        sup_mat = over[:, :, lo:hi] & tri
        kept = active
        while True:
            new_kept = active & ~(sup_mat & kept[:, :, None]).any(1)
            nms.host_syncs += 1
            if torch.equal(new_kept, kept):
                break
            kept = new_kept
        keep[:, lo:hi] = kept
    return keep[:, :n].reshape(lead + (n,)), order.reshape(lead + (n,))


nms.host_syncs = 0


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                idxs: torch.Tensor, iou_threshold: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by the coordinate-offset trick: boxes of different
    ``idxs`` never overlap after offsetting by idx * (max_coord + 1). The
    max is taken per item of the leading batch dimensions."""
    max_coord = boxes.amax(dim=(-2, -1), keepdim=True) + 1.0
    offsets = idxs.to(boxes.dtype)[..., None] * max_coord
    return nms(boxes + offsets, scores, iou_threshold)


def multiclass_nms(
    multi_bboxes: torch.Tensor,   # (B, N, C*4) or (B, N, 4)
    multi_scores: torch.Tensor,   # (B, N, C+1), last column = background
    score_thr: float = 0.05,
    iou_threshold: float = 0.5,
    max_per_img: int = 100,
    nms_pre: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference ``bbox_nms.py:8-97`` as the JAX package fixes it: a static
    top-``nms_pre`` over the flattened N x C scores above ``score_thr``,
    class-offset NMS, top ``max_per_img``.

    Returns fixed-shape (dets (B,K,4), scores (B,K), labels (B,K),
    valid (B,K)), K = max_per_img; invalid slots have score 0, label -1."""
    bsz, n = multi_scores.shape[:2]
    num_classes = multi_scores.shape[-1] - 1
    dev = multi_scores.device
    if multi_bboxes.shape[-1] > 4:
        boxes = multi_bboxes.reshape(bsz, n, num_classes, 4)
    else:
        boxes = multi_bboxes[:, :, None, :].expand(bsz, n, num_classes, 4)
    boxes_flat = boxes.reshape(bsz, -1, 4)
    scores_flat = multi_scores[..., :num_classes].reshape(bsz, -1)
    labels_flat = torch.arange(num_classes, device=dev).repeat(n)

    valid = scores_flat > score_thr
    scores_masked = torch.where(valid, scores_flat,
                                torch.full_like(scores_flat, float("-inf")))

    k_pre = min(nms_pre, scores_flat.shape[1])
    pre_scores, pre_idx = top_k(scores_masked, k_pre)
    boxes_pre = _take(boxes_flat, pre_idx)
    labels_pre = labels_flat[pre_idx]
    scores_pre_raw = _take(scores_flat, pre_idx)

    keep, order = batched_nms(boxes_pre, pre_scores, labels_pre,
                              iou_threshold)
    kept_scores = torch.where(keep, _take(pre_scores, order),
                              torch.full_like(pre_scores, float("-inf")))
    k_out = min(max_per_img, k_pre)
    top_scores, top_idx = top_k(kept_scores, k_out)
    sel = _take(order, top_idx)
    out_valid = top_scores > score_thr
    dets = torch.where(out_valid[..., None], _take(boxes_pre, sel),
                       torch.zeros((), dtype=boxes_pre.dtype, device=dev))
    out_scores = torch.where(out_valid, _take(scores_pre_raw, sel),
                             torch.zeros((), dtype=scores_flat.dtype,
                                         device=dev))
    out_labels = torch.where(out_valid, _take(labels_pre, sel),
                             torch.full_like(sel, -1))
    if k_out < max_per_img:   # pad to the fixed slate
        pad = max_per_img - k_out
        dets = torch.cat([dets, dets.new_zeros((bsz, pad, 4))], 1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((bsz, pad))],
                               1)
        out_labels = torch.cat(
            [out_labels, out_labels.new_full((bsz, pad), -1)], 1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((bsz, pad))],
                              1)
    return dets, out_scores, out_labels, out_valid
