"""FASA (feature augmentation and sampling adaptation): port of
``iif_tpu/detection/fasa.py`` (``FasaState``, ``init_fasa_state``,
``fasa_update``, ``fasa_generate``, ``fasa_aug_loss``,
``fasa_accumulate_val``, ``fasa_reset_cums``, ``fasa_dynamic_sampling``),
the reference's ``fasa_bbox_head.py`` and the val-epoch counters of
``fasa_iif_loss.py``.

The state is a tuple of tensors on the model's device, updated without
gradients from each step's positive RoI embeddings. The virtual features
draw their uniform and normal noise from a ``torch.Generator``, or take
JAX's draws through ``noise`` (the parity tests).

``fasa_dynamic_sampling`` runs between epochs on the host, in float64
NumPy. Its clustering is ``affinity_propagation``, this module's own
transcription of scikit-learn's ``AffinityPropagation(random_state=1,
affinity="precomputed")`` as the JAX package calls it: the card's machine
has no scikit-learn.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch


class FasaState(NamedTuple):
    feature_mean: torch.Tensor   # (C, D)
    feature_var: torch.Tensor    # (C, D)
    feature_used: torch.Tensor   # (C,)
    prob_list: torch.Tensor      # (C,)
    cum_losses: torch.Tensor     # (C+1,) val-epoch accumulators
    cum_labels: torch.Tensor     # (C+1,)
    cum_loss_t0: torch.Tensor    # (C+1,) previous epoch's normalised losses


def init_fasa_state(instance_counts: np.ndarray, feat_dim: int = 1024,
                    instance_prob_power: float = 1.0,
                    instance_prob_scale: float = 1.0,
                    device: Optional[torch.device] = None) -> FasaState:
    """Sampling probabilities ``scale * ((1/n_c) / sum)^power`` clamped to
    [0, 1] (``fasa_bbox_head.py:51-61``), computed in float64 and stored
    in float32; every statistic and counter 0."""
    c = len(instance_counts)
    inv = 1.0 / np.maximum(np.asarray(instance_counts, np.float64), 1.0)
    prob = instance_prob_scale * (inv / inv.sum()) ** instance_prob_power
    prob = np.clip(prob, 0.0, 1.0)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return FasaState(
        feature_mean=zeros(c, feat_dim), feature_var=zeros(c, feat_dim),
        feature_used=zeros(c),
        prob_list=torch.as_tensor(prob.astype(np.float32), device=device),
        cum_losses=zeros(c + 1), cum_labels=zeros(c + 1),
        cum_loss_t0=zeros(c + 1))


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows; a label outside [0, n) gives a zero row (the
    background label, as ``jax.nn.one_hot`` treats it)."""
    return (labels[:, None] == torch.arange(n, device=labels.device)
            ).float()


@torch.no_grad()
def fasa_update(state: FasaState, embeddings: torch.Tensor,
                labels: torch.Tensor, pos_weight: torch.Tensor,
                decay_ratio: float = 0.1) -> FasaState:
    """EMA of the per-class feature mean and (unbiased) variance from this
    step's positive embeddings (R, D) (``fa_update``/``fa_update_push``):
    a class seen for the first time takes the step's statistics."""
    c = state.feature_mean.shape[0]
    emb = embeddings.detach().float()
    onehot = _one_hot(labels, c) * pos_weight.float()[:, None]
    counts = onehot.sum(0)
    safe = torch.clamp(counts, min=1.0)
    mean = (onehot.t() @ emb) / safe[:, None]
    sq = (onehot.t() @ (emb * emb)) / safe[:, None]
    var_biased = sq - mean * mean
    corr = torch.where(counts > 1,
                       counts / torch.clamp(counts - 1.0, min=1.0),
                       torch.ones_like(counts))
    var = torch.clamp(var_biased, min=0.0) * corr[:, None]

    seen = (counts > 0)[:, None]
    first = seen & (state.feature_used == 0)[:, None]
    ema_mean = decay_ratio * mean + (1 - decay_ratio) * state.feature_mean
    ema_var = decay_ratio * var + (1 - decay_ratio) * state.feature_var
    new_mean = torch.where(first, mean, torch.where(
        seen, ema_mean, state.feature_mean))
    new_var = torch.where(first, var, torch.where(
        seen, ema_var, state.feature_var))
    return state._replace(
        feature_mean=new_mean, feature_var=new_var,
        feature_used=state.feature_used + first[:, 0].float())


def fasa_generate(state: FasaState,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A virtual feature for every class and its selection weight: class
    c is selected iff U(0, 1) < ``prob_list[c]`` and its statistics exist
    (``fa_generate``). ``noise`` = (uniform (C,), normal (C, D)), else
    drawn from ``generator``, the uniform first. Returns (features (C, D),
    labels (C,), select (C,) in {0, 1})."""
    c, d = state.feature_mean.shape
    dev = state.feature_mean.device
    if noise is None:
        rand = torch.rand((c,), generator=generator, device=dev)
        normal = torch.randn((c, d), generator=generator, device=dev)
    else:
        rand, normal = (n.to(dev) for n in noise)
    select = ((rand < state.prob_list) & (state.feature_used > 0)).float()
    feats = state.feature_mean + torch.sqrt(
        torch.clamp(state.feature_var, min=0.0)) * normal
    return feats, torch.arange(c, device=dev), select


def fasa_aug_loss(state: FasaState,
                  fc_cls_apply: Callable[[torch.Tensor], torch.Tensor],
                  loss_cls, loss_aug_weight: float = 0.1,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """The virtual features' CE through the classifier alone
    (``fasa_bbox_head.py:283-299``), weighted ``loss_aug_weight``."""
    feats, labels, select = fasa_generate(state, generator, noise)
    return loss_cls(fc_cls_apply(feats), labels,
                    weight=select * loss_aug_weight,
                    avg_factor=torch.clamp(select.sum(), min=1.0))


@torch.no_grad()
def fasa_accumulate_val(state: FasaState, loss_cls,
                        cls_score: torch.Tensor, labels: torch.Tensor,
                        weight: Optional[torch.Tensor] = None) -> FasaState:
    """The val pass's per-class summed losses and label counts
    (``fasa_iif_loss.py:60-71, 154-161``)."""
    sums = loss_cls.per_class_sums(cls_score, labels, weight=weight)
    onehot = _one_hot(labels, state.cum_losses.shape[0])
    if weight is not None:
        onehot = onehot * weight.float()[:, None]
    return state._replace(cum_losses=state.cum_losses + sums,
                          cum_labels=state.cum_labels + onehot.sum(0))


def fasa_reset_cums(state: FasaState) -> FasaState:
    return state._replace(cum_losses=torch.zeros_like(state.cum_losses),
                          cum_labels=torch.zeros_like(state.cum_labels))


# scikit-learn's AffinityPropagation defaults, and the JAX package's seed
DAMPING = 0.5
CONVERGENCE_ITER = 15
AP_SEED = 1


def affinity_propagation(similarity: np.ndarray, max_iter: int = 200
                         ) -> np.ndarray:
    """Cluster labels of scikit-learn's ``AffinityPropagation(max_iter=
    max_iter, random_state=1, affinity="precomputed").fit(similarity).
    labels_``, transcribed branch by branch: the median preference placed
    on the diagonal, the degeneracy noise ``(eps * S + tiny * 100) *
    RandomState(1).standard_normal((n, n))`` added after it, damped (0.5)
    responsibility and availability updates, convergence when every
    exemplar flag has held for 15 iterations, the exemplars refined once;
    all labels 0 (or each its own) when the similarities are all equal,
    and -1 when no exemplar emerges."""
    damping, convergence_iter = DAMPING, CONVERGENCE_ITER
    s = np.array(similarity, dtype=np.float64)
    n = s.shape[0]
    preference = np.median(s)
    off = ~np.eye(n, dtype=bool)
    if n == 1 or np.all(s[off] == s[off].flat[0]):
        if preference > s.flat[n - 1]:
            return np.arange(n)
        return np.zeros(n, dtype=np.int64)

    s.flat[::n + 1] = preference
    a = np.zeros((n, n))
    r = np.zeros((n, n))
    tmp = np.zeros((n, n))
    s += (np.finfo(s.dtype).eps * s + np.finfo(s.dtype).tiny * 100) \
        * np.random.RandomState(AP_SEED).standard_normal(size=(n, n))
    e = np.zeros((n, convergence_iter))
    ind = np.arange(n)
    for it in range(max_iter):
        np.add(a, s, tmp)
        i_max = np.argmax(tmp, axis=1)
        y = tmp[ind, i_max]
        tmp[ind, i_max] = -np.inf
        y2 = np.max(tmp, axis=1)
        np.subtract(s, y[:, None], tmp)
        tmp[ind, i_max] = s[ind, i_max] - y2
        tmp *= 1 - damping
        r *= damping
        r += tmp
        np.maximum(r, 0, out=tmp)
        tmp.flat[::n + 1] = r.flat[::n + 1]
        tmp -= np.sum(tmp, axis=0)
        d_a = np.diag(tmp).copy()
        tmp.clip(0, np.inf, tmp)
        tmp.flat[::n + 1] = d_a
        tmp *= 1 - damping
        a *= damping
        a -= tmp
        flags = (np.diag(a) + np.diag(r)) > 0
        e[:, it % convergence_iter] = flags
        k = np.sum(flags, axis=0)
        if it >= convergence_iter:
            se = np.sum(e, axis=1)
            unconverged = np.sum((se == convergence_iter) + (se == 0)) != n
            if not unconverged and k > 0:
                break
    exemplars = np.flatnonzero(flags)
    k = exemplars.size
    if k == 0:
        return np.full(n, -1, dtype=np.int64)
    c = np.argmax(s[:, exemplars], axis=1)
    c[exemplars] = np.arange(k)
    for j in range(k):
        ii = np.asarray(c == j).nonzero()[0]
        exemplars[j] = ii[np.argmax(np.sum(s[ii[:, None], ii], axis=0))]
    c = np.argmax(s[:, exemplars], axis=1)
    c[exemplars] = np.arange(k)
    labels = exemplars[c]
    return np.searchsorted(np.unique(labels), labels)


def fasa_dynamic_sampling(state: FasaState, dynamic_up: float = 1.1,
                          dynamic_down: float = 0.9) -> FasaState:
    """Between epochs (``dynamic_sampling``, ``fasa_bbox_head.py:173-215``):
    cluster the class means by affinity propagation on their squared
    distances (passed as the similarity, as the JAX package passes them);
    a cluster whose normalised val loss rose since the last epoch gets
    its probabilities times ``dynamic_down``, one whose loss fell times
    ``dynamic_up``, clamped to [0, 1]. Resets the counters and keeps this
    epoch's losses as ``cum_loss_t0``. On the host, in float64."""
    dev = state.prob_list.device
    mean = state.feature_mean.double().cpu().numpy()
    cum_losses = state.cum_losses.double().cpu().numpy()
    cum_labels = state.cum_labels.double().cpu().numpy()
    t1 = cum_losses / max(cum_labels.sum(), 1.0)
    t0 = state.cum_loss_t0.double().cpu().numpy()
    if t0.sum() == 0:
        t0 = t1.copy()

    xy = mean @ mean.T
    sq = (mean * mean).sum(1)
    labels = affinity_propagation(sq[:, None] - 2 * xy + sq[None, :])

    prob = state.prob_list.double().cpu().numpy().copy()
    for g in range(labels.max() + 1):
        sel = np.flatnonzero(labels == g)
        delta = t1[sel].sum() - t0[sel].sum()
        if delta > 0:
            prob[sel] = np.clip(prob[sel] * dynamic_down, 0.0, 1.0)
        elif delta < 0:
            prob[sel] = np.clip(prob[sel] * dynamic_up, 0.0, 1.0)
    return fasa_reset_cums(state)._replace(
        prob_list=torch.as_tensor(prob.astype(np.float32), device=dev),
        cum_loss_t0=torch.as_tensor(t1.astype(np.float32), device=dev))


def fasa_state_dict(states) -> list:
    """One stage's or a cascade's states -> a list of ``{field: tensor}``
    on the CPU, for a checkpoint."""
    states = states if isinstance(states, tuple) and not isinstance(
        states, FasaState) else (states,)
    return [{k: v.detach().cpu() for k, v in s._asdict().items()}
            for s in states]


def fasa_from_state_dict(entries: list, device=None):
    """Inverse of ``fasa_state_dict``: a ``FasaState``, or a tuple of
    them for more than one stage."""
    states = tuple(FasaState(**{k: v.to(device) for k, v in e.items()})
                   for e in entries)
    return states[0] if len(states) == 1 else states
