"""FASA and the clipped optimizer against the JAX package, on the CPU.

- Every function of ``iif_torch/detection/fasa.py`` against
  ``iif_tpu/detection/fasa.py`` on the same seeded states and inputs, the
  virtual features on JAX's own draws (``noise``): the initial state
  equal, the EMA statistics, the virtual features, the aug loss and the
  val counters within 1e-6 of each tensor's largest magnitude (f32 sums
  in another order; measured at most 1.2e-7).
- ``affinity_propagation``, the port's NumPy transcription of
  scikit-learn's, gives labels equal to ``sklearn.cluster.
  AffinityPropagation(random_state=1, affinity="precomputed")`` on
  squared-distance matrices as FASA builds them (up to 1203 classes), on
  random similarities, on an all-equal matrix and on runs cut before
  they converge (max_iter 1-3).
- ``fasa_dynamic_sampling``'s ``prob_list`` and ``cum_loss_t0`` equal
  JAX's (which calls scikit-learn) to 1 f32 ulp.
- Three SGD steps of ``build_optimizer(grad_clip=35)``, two with the
  gradient's global norm above 35 and one below, against JAX's optax
  chain (``clip_by_global_norm`` before the coupled decay and the
  momentum) to 1e-6 relative; a frozen tensor stays put.
- A checkpoint carries every FASA field of every stage bit for bit.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection import fasa as tf
from iif_torch.detection.losses import DetCrossEntropyLoss, DetIIFLoss
from iif_torch.engine.schedules import build_lr_schedule, build_optimizer

torch.set_num_threads(1)

C, D = 12, 16          # classes and embedding width of the small cases
TOL = 1e-6             # of each tensor's largest magnitude


def _jax_state(state):
    from iif_tpu.detection.fasa import FasaState

    return FasaState(*(jnp.asarray(t.numpy()) for t in state))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _same_state(got, want, tol=TOL):
    for name, a, b in zip(tf.FasaState._fields, got, want):
        _close(a.numpy(), np.asarray(b), tol) if tol else \
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def _trained_state(rng):
    """A state after some steps: half the classes seen, random
    statistics, probabilities and counters."""
    used = (rng.rand(C) < 0.5).astype(np.float32)
    return tf.FasaState(*(torch.from_numpy(x.astype(np.float32)) for x in (
        rng.randn(C, D) * used[:, None], rng.rand(C, D) * used[:, None],
        used, rng.rand(C), rng.rand(C + 1) * 5,
        rng.randint(0, 6, C + 1), rng.rand(C + 1))))


def test_init_fasa_state_matches_jax():
    from iif_tpu.detection.fasa import init_fasa_state

    counts = np.array([0, 1, 3, 10, 250, 7, 7, 2, 90, 1, 4, 1000])
    for power, scale in ((1.0, 1.0), (0.5, 3.0)):
        got = tf.init_fasa_state(counts, D, power, scale)
        _same_state(got, init_fasa_state(counts, D, power, scale), tol=0)


def test_fasa_update_matches_jax():
    """First sighting, EMA, unseen classes, background and padded rows,
    one and several positives a class."""
    from iif_tpu.detection.fasa import fasa_update

    rng = np.random.RandomState(0)
    state = _trained_state(rng)
    emb = rng.randn(40, D).astype(np.float32) * 3
    labels = rng.randint(0, C + 1, 40)
    labels[:3] = 5                      # several positives of one class
    pos_w = ((labels < C) & (rng.rand(40) < 0.8)).astype(np.float32)
    got = tf.fasa_update(state, torch.from_numpy(emb),
                         torch.from_numpy(labels), torch.from_numpy(pos_w),
                         decay_ratio=0.3)
    want = fasa_update(_jax_state(state), jnp.asarray(emb),
                       jnp.asarray(labels), jnp.asarray(pos_w),
                       decay_ratio=0.3)
    _same_state(got, want)
    assert (got.feature_used > state.feature_used).any()


def jax_fasa_noise(key, c, d):
    """``fasa_generate``'s draws under ``key`` (``fasa.py:113-117``)."""
    k_sel, k_noise = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.uniform(k_sel, (c,)))),
            torch.from_numpy(np.asarray(jax.random.normal(k_noise, (c, d)))))


@pytest.mark.parametrize("loss_kind", ["iif", "ce"])
def test_fasa_generate_and_aug_loss_match_jax(loss_kind):
    """The virtual features, their selection and the aug CE through a
    normed classifier (temperature 8) on JAX's draws."""
    from iif_tpu.detection.fasa import fasa_aug_loss, fasa_generate
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF
    from iif_tpu.models.layers import NormedLinear as JaxNormed

    from iif_torch.models.layers import NormedLinear

    rng = np.random.RandomState(1)
    state = _trained_state(rng)
    key = jax.random.PRNGKey(7)
    noise = jax_fasa_noise(key, C, D)
    kernel = rng.uniform(0, 2, (D, C + 1)).astype(np.float32)
    weights = np.linspace(0.5, 2.0, C + 1).astype(np.float32)
    jloss, tloss = ((JaxIIF(jnp.asarray(weights)), DetIIFLoss(weights))
                    if loss_kind == "iif" else (JaxCE(C), DetCrossEntropyLoss(C)))
    head = NormedLinear(D, C + 1, temperature=8.0)
    head.weight.data = torch.from_numpy(kernel - np.float32(1.0))
    jhead = JaxNormed(C + 1, temperature=8.0)

    feats, labels, select = tf.fasa_generate(state, noise=noise)
    jfeats, jlabels, jselect = fasa_generate(_jax_state(state), key)
    _close(feats.numpy(), jfeats)
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    np.testing.assert_array_equal(select.numpy(), jselect)
    assert 0 < select.sum() < C

    got = tf.fasa_aug_loss(state, head, tloss, 0.1, noise=noise)
    want = fasa_aug_loss(
        _jax_state(state), key,
        lambda e: jhead.apply({"params": {"kernel": kernel}}, e), jloss, 0.1)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("loss_kind", ["iif", "ce"])
def test_fasa_accumulate_val_and_reset_match_jax(loss_kind):
    from iif_tpu.detection.fasa import fasa_accumulate_val, fasa_reset_cums
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    rng = np.random.RandomState(2)
    state = _trained_state(rng)
    scores = (rng.randn(50, C + 1) * 4).astype(np.float32)
    labels = rng.randint(0, C + 1, 50)
    weight = (rng.rand(50) < 0.9).astype(np.float32)
    weights = np.linspace(0.5, 2.0, C + 1).astype(np.float32)
    jloss, tloss = ((JaxIIF(jnp.asarray(weights)), DetIIFLoss(weights))
                    if loss_kind == "iif" else (JaxCE(C), DetCrossEntropyLoss(C)))
    _close(tloss.per_class_sums(torch.from_numpy(scores),
                                torch.from_numpy(labels),
                                torch.from_numpy(weight)).numpy(),
           jloss.per_class_sums(jnp.asarray(scores), jnp.asarray(labels),
                                jnp.asarray(weight)))
    got = tf.fasa_accumulate_val(state, tloss, torch.from_numpy(scores),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(weight))
    want = fasa_accumulate_val(_jax_state(state), jloss, jnp.asarray(scores),
                               jnp.asarray(labels), jnp.asarray(weight))
    _same_state(got, want)
    _same_state(tf.fasa_reset_cums(got), fasa_reset_cums(want), tol=0)


def _sklearn_labels(s, **kw):
    from sklearn.cluster import AffinityPropagation

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return AffinityPropagation(random_state=1, affinity="precomputed",
                                   **kw).fit(s).labels_


def _fasa_distances(rng, n, d=64, groups=8):
    """FASA's similarity: squared distances between class means (0 rows
    for unseen classes, clustered seen ones), as the JAX package passes
    them."""
    centres = rng.randn(groups, d) * 3
    mean = centres[rng.randint(0, groups, n)] + rng.randn(n, d) * 0.5
    mean[rng.rand(n) < 0.3] = 0.0
    mean = mean.astype(np.float32).astype(np.float64)
    xy = mean @ mean.T
    sq = (mean * mean).sum(1)
    return sq[:, None] - 2 * xy + sq[None, :]


@pytest.mark.parametrize("n", [2, 9, 60, 1203])
def test_affinity_propagation_equals_sklearn_on_fasa_distances(n):
    s = _fasa_distances(np.random.RandomState(n), n)
    got = tf.affinity_propagation(s)
    np.testing.assert_array_equal(got, _sklearn_labels(s))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affinity_propagation_equals_sklearn_on_random_similarities(seed):
    s = _neg_sq_distances(seed, 150)
    np.testing.assert_array_equal(tf.affinity_propagation(s),
                                  _sklearn_labels(s))


@pytest.mark.parametrize("value", [0.0, -3.5])
def test_affinity_propagation_all_equal_similarities(value):
    """The early return: every label 0 (the median preference equals
    the off-diagonal similarity); with a diagonal above it, each its own
    cluster, as scikit-learn."""
    s = np.full((7, 7), value)
    np.testing.assert_array_equal(tf.affinity_propagation(s),
                                  _sklearn_labels(s))
    np.fill_diagonal(s, value + 1.0)
    s2 = np.full((7, 7), value)
    np.testing.assert_array_equal(tf.affinity_propagation(s2),
                                  _sklearn_labels(s2))
    assert (tf.affinity_propagation(np.zeros((1, 1))) == 0).all()


def _neg_sq_distances(seed, n=30):
    x = np.random.RandomState(seed).randn(n, 3)
    return -((x[:, None] - x[None]) ** 2).sum(-1)


@pytest.mark.parametrize("max_iter", [1, 2, 3])
def test_affinity_propagation_cut_before_convergence(max_iter):
    """Runs stopped before convergence: labels -1 where no exemplar has
    emerged (FASA's loop over clusters then does nothing), else the
    degenerate clusters, as scikit-learn gives them."""
    cases = [_fasa_distances(np.random.RandomState(5), 80)] + [
        _neg_sq_distances(seed) for seed in range(4)]
    labels = []
    for s in cases:
        labels.append(tf.affinity_propagation(s, max_iter=max_iter))
        np.testing.assert_array_equal(labels[-1],
                                      _sklearn_labels(s, max_iter=max_iter))
    if max_iter == 1:
        assert any((got == -1).all() for got in labels)


@pytest.mark.parametrize("first_epoch", [True, False])
def test_fasa_dynamic_sampling_matches_jax(first_epoch):
    """``prob_list`` and ``cum_loss_t0`` to 1 f32 ulp, counters reset;
    ``first_epoch`` starts from ``cum_loss_t0`` 0 (t0 = t1, nothing
    moves)."""
    from iif_tpu.detection.fasa import fasa_dynamic_sampling

    rng = np.random.RandomState(4 + first_epoch)
    state = _trained_state(rng)
    centres = rng.randn(3, D) * 4
    means = (centres[rng.randint(0, 3, C)] + rng.randn(C, D) * 0.3)
    state = state._replace(feature_mean=torch.from_numpy(
        means.astype(np.float32)))
    if first_epoch:
        state = state._replace(cum_loss_t0=torch.zeros(C + 1))
    got = tf.fasa_dynamic_sampling(state, 1.1, 0.9)
    want = fasa_dynamic_sampling(_jax_state(state), 1.1, 0.9)
    for name in ("prob_list", "cum_loss_t0"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        ulp = np.spacing(np.abs(b).astype(np.float32))
        assert (np.abs(a - b) <= ulp).all(), name
    assert not got.cum_losses.any() and not got.cum_labels.any()
    moved = (got.prob_list != state.prob_list).any()
    assert bool(moved) != first_epoch


def test_sgd_with_grad_clip_matches_optax():
    """Steps 1 and 3 above the bound (norm 100 and 60), step 2 below
    (norm 10); SGD lr 0.02 with momentum 0.9 and coupled decay 1e-4; the
    second tensor frozen (no gradient, no decay)."""
    import optax

    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule
    from iif_tpu.engine.schedules import build_optimizer as jax_optimizer

    rng = np.random.RandomState(9)
    shapes = {"a": (5, 7), "frozen": (4,), "c": (33,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    tparams["frozen"].requires_grad_(False)
    sched = build_lr_schedule(0.02, 100, warmup_iters=0)
    opt, lr = build_optimizer("sgd", tparams.values(), sched, 0.9, 1e-4,
                              grad_clip=35.0)
    tx = jax_optimizer("sgd", jax_schedule(0.02, 100, 12, warmup_iters=0),
                       0.9, 1e-4, grad_clip=35.0, trainable_mask={
                           "a": True, "frozen": False, "c": True})
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    for norm in (100.0, 10.0, 60.0):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        live = np.sqrt(sum((g[k] ** 2).sum() for k in ("a", "c")))
        g = {k: v * np.float32(norm / live) for k, v in g.items()}
        for k in ("a", "c"):
            tparams[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
        lr.step()
        assert opt.grad_clip.last_norm.item() == pytest.approx(norm,
                                                                rel=1e-5)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                     g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tparams["frozen"].detach().numpy(),
                                  params["frozen"])


def test_checkpoint_carries_every_fasa_field(tmp_path):
    """``save_checkpoint`` then ``restore``: every field of each of three
    stages equal bit for bit; a state without FASA writes none."""
    from iif_torch.engine.detection import DetTrainState
    from iif_torch.utils.checkpoint import read_meta, restore, save_checkpoint

    rng = np.random.RandomState(3)
    model = torch.nn.Linear(2, 2)
    opt, sched = build_optimizer("sgd", model.parameters(), lambda s: 0.1)
    stages = tuple(_trained_state(rng) for _ in range(3))
    path = save_checkpoint(str(tmp_path), 1, model,
                           DetTrainState(5, opt, sched, stages))
    back = DetTrainState(0, opt, sched, None)
    assert restore(path, model, back) == 1 and back.step == 5
    assert len(back.fasa) == 3
    for got, want in zip(back.fasa, stages):
        _same_state(got, want, tol=0)
    plain = save_checkpoint(str(tmp_path / "plain"), 1, model,
                            DetTrainState(0, opt, sched))
    assert "fasa" not in torch.load(plain, weights_only=True)
    assert read_meta(path)["epoch"] == 1
