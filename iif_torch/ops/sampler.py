"""Fixed-size positive/negative sampling: port of ``iif_tpu/ops/sampler.py``
(``_masked_topk_choice``, ``random_sample_pos_neg``; mmdet
``random_sampler.py``), batched over images.

"Pick k elements of a masked set uniformly at random" is a top-k of
uniform noise over the set (a Gumbel-style top-k). The noise is an
argument: without it the sampler draws it from the caller's
``torch.Generator``. ``jax.random`` and ``torch.Generator`` cannot give the
same bits, so the parity tests rebuild the JAX package's draw from its own
key chain and pass it in here. The top-k is exact, with ties broken by
the lower index as ``jax.lax.top_k`` breaks them; the JAX package's
``approx_max_k`` above 8192 candidates is a TPU shortcut, exact on a CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from iif_torch.ops.nms import top_k


def _masked_topk_choice(mask: torch.Tensor, k: int, noise: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to k True positions of each row of ``mask`` (B, N), uniformly at
    random by the row's ``noise`` (B, N).

    Returns (indices (B, k), chosen_valid (B, k)): invalid slots point at
    the row's first True element (or 0)."""
    b, n = mask.shape
    scores = torch.where(mask, noise, torch.full_like(noise, -1.0))
    k_eff = min(k, n)
    top_scores, idx = top_k(scores, k_eff)
    if k_eff < k:      # candidate pool smaller than the request: pad
        top_scores = torch.cat(
            [top_scores, top_scores.new_full((b, k - k_eff), -1.0)], 1)
        idx = torch.cat([idx, idx.new_zeros((b, k - k_eff))], 1)
    valid = top_scores >= 0.0
    first = torch.argmax(mask.to(torch.int32), dim=1, keepdim=True)
    return torch.where(valid, idx, first), valid


def random_sample_pos_neg(
    assigned_gt_inds: torch.Tensor,      # (B, N) -1 ignore / 0 neg / i+1
    num: int = 512,
    pos_fraction: float = 0.25,
    pos_noise: Optional[torch.Tensor] = None,
    neg_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (inds (B, num), is_pos (B, num), valid (B, num)).

    Positives fill the first slots (up to ``num * pos_fraction``),
    negatives the rest, the reference's pos-then-neg order. Missing noise
    is drawn from ``generator``, positives' first."""
    dev = assigned_gt_inds.device
    shape = assigned_gt_inds.shape
    if pos_noise is None:
        pos_noise = torch.rand(shape, generator=generator, device=dev)
    if neg_noise is None:
        neg_noise = torch.rand(shape, generator=generator, device=dev)
    num_expected_pos = int(num * pos_fraction)
    pos_idx, pos_ok = _masked_topk_choice(assigned_gt_inds > 0,
                                          num_expected_pos, pos_noise)
    # negatives: fill every slot not taken by a real positive
    neg_idx, neg_ok = _masked_topk_choice(assigned_gt_inds == 0, num,
                                          neg_noise)
    n_pos = pos_ok.sum(1, keepdim=True)                      # (B, 1)
    slot = torch.arange(num, device=dev)[None, :]
    take_pos = slot < n_pos
    pos_pick = torch.clamp(slot, max=num_expected_pos - 1).expand_as(
        take_pos)
    neg_pick = torch.clamp(slot - n_pos, 0, num - 1)
    inds = torch.where(take_pos, torch.gather(pos_idx, 1, pos_pick),
                       torch.gather(neg_idx, 1, neg_pick))
    valid = take_pos | torch.gather(neg_ok, 1, neg_pick)
    return inds, take_pos, valid
