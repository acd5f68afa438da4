"""One whole ``ClassificationTrainer`` step, ``evaluate`` and ``shot_acc``
of the port against ``iif_tpu`` on the same weights, the same batch and
JAX's draws (crop, flip, mixup's lambda and permutation), on a small
``ResNetS((1, 1, 1))`` with 16x16 images: the loss, every gradient (from
the SGD update at lr 1 with no momentum and no decay), the SGD update with
momentum and decay, and the new BN statistics, in f32 and in bf16, plain
and with mixup and deferred IIF weights. The JAX package's own converter
(``convert_torch_resnet``) carries the port's fresh weights into JAX."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

C = 10
B = 8
SIZE = 16
MIXUP = 0.2


def _jax_trainer(single_mesh, criterion, dtype, mixup, lr, momentum, wd):
    from iif_tpu.data.augment import cifar_eval_transform, cifar_train_augment
    from iif_tpu.data.cifar_lt import CIFAR10_MEAN, CIFAR10_STD
    from iif_tpu.engine import ClassificationTrainer, build_optimizer
    from iif_tpu.models.resnet_cifar import ResNetS

    tx = build_optimizer("sgd", lambda s: lr, momentum=momentum,
                         weight_decay=wd)
    return ClassificationTrainer(
        model=ResNetS((1, 1, 1), C), criterion=criterion, tx=tx,
        mesh=single_mesh,
        train_augment=lambda k, x: cifar_train_augment(
            k, x, CIFAR10_MEAN, CIFAR10_STD),
        eval_transform=lambda x: cifar_eval_transform(
            x, CIFAR10_MEAN, CIFAR10_STD),
        num_classes=C, mixup_alpha=mixup, compute_dtype=dtype, seed=SEED)


SEED = 3


def _step_keys():
    """The JAX step 0's keys: its augmentation's and mixup's."""
    step_key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    return jax.random.split(step_key)


@jax.jit
def _jax_aug_draw():
    """The crop and the flip of the JAX step 0's augmentation."""
    k_aug, _ = _step_keys()
    k_crop, k_flip = jax.random.split(k_aug, 5)[:2]
    ky, kx = jax.random.split(k_crop)
    return {"oy": jax.random.randint(ky, (B,), 0, 9),
            "ox": jax.random.randint(kx, (B,), 0, 9),
            "flip": jax.random.bernoulli(k_flip, 0.5, (B,))}


def _mix_inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(B, 4, 4, 3).astype(np.float32),
            rng.randint(0, C, B).astype(np.int64))


@functools.lru_cache(maxsize=1)
def _jax_mix_draw():
    """Mixup's lambda and permutation of the JAX step 0, and JAX's
    ``mixup_batch`` on that key of an f32 and a bf16 batch, in one
    compile."""
    from iif_tpu.losses.mixup import mixup_batch as jax_mixup

    @jax.jit
    def run(x, y):
        _, k_mix = _step_keys()
        _, k_perm = jax.random.split(k_mix)
        f32 = jax_mixup(k_mix, x, y, MIXUP)
        return (f32[3], jax.random.permutation(k_perm, B), f32,
                jax_mixup(k_mix, x.astype(jnp.bfloat16), y, MIXUP))

    x, y = _mix_inputs()
    return run(jnp.asarray(x), jnp.asarray(y))


def _jax_draws(mixup):
    draw = {k: torch.from_numpy(np.array(v))
            for k, v in _jax_aug_draw().items()}
    if mixup is None:
        return draw, None
    lam, index = _jax_mix_draw()[:2]
    return draw, (float(lam), torch.from_numpy(np.array(index)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixup_on_jax_draw(dtype):
    """``mixup_batch`` with JAX's lambda and permutation: the mixed batch
    (f32 for a bf16 batch, as JAX promotes it; rtol 1e-6), the label
    pairs and the mixed criterion (rtol 1e-6)."""
    from iif_tpu.losses import get_criterion as jax_criterion
    from iif_tpu.losses.mixup import mixup_criterion as jax_mix_crit

    from iif_torch.losses import get_criterion
    from iif_torch.losses.mixup import mixup_batch, mixup_criterion

    x, y = _mix_inputs()
    lam, index, want32, want16 = _jax_mix_draw()
    want = want32 if dtype == "float32" else want16
    tx = torch.from_numpy(np.array(jnp.asarray(x).astype(dtype).astype(
        jnp.float32))).to(getattr(torch, dtype))
    got = mixup_batch(tx, torch.from_numpy(y), float(lam),
                      torch.from_numpy(np.array(index)))
    assert got[0].dtype == torch.float32 and want[0].dtype == jnp.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(got[3]) == float(want[3])
    logits = np.random.RandomState(2).randn(B, C).astype(np.float32)
    crit, jcrit = get_criterion("iif", _counts()), jax_criterion(
        "iif", _counts())
    np.testing.assert_allclose(
        float(mixup_criterion(crit, torch.from_numpy(logits), got[1], got[2],
                              got[3])),
        float(jax_mix_crit(jcrit, jnp.asarray(logits), want[1], want[2],
                           want[3])), rtol=1e-6)


def _port_model(dtype, seed=0):
    """A fresh ``ResNetS((1, 1, 1))`` with every BN parameter and
    statistic moved off its init."""
    from iif_torch.models.init import classifier_fresh_init_
    from iif_torch.models.resnet_cifar import ResNetS

    model = ResNetS((1, 1, 1), C, compute_dtype=dtype)
    classifier_fresh_init_(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.add_(0.2 * torch.randn(n, generator=g))
                m.bias.add_(0.2 * torch.randn(n, generator=g))
                m.running_mean.add_(0.2 * torch.randn(n, generator=g))
                m.running_var.add_(torch.rand(n, generator=g))
    return model


def _jax_state(jtrainer, model):
    """The JAX trainer's state of the port's weights, carried over by the
    JAX package's own converter."""
    from iif_tpu.engine.classification import TrainState
    from iif_tpu.models.pretrained import convert_torch_resnet

    params, stats = convert_torch_resnet(model.state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, params)
    stats = jax.tree_util.tree_map(jnp.asarray, stats)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=jtrainer.tx.init(params))


def _batch(seed=0, n=B):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8),
            "label": rng.randint(0, C, n).astype(np.int64)}


def _counts():
    return [40, 25, 16, 10, 7, 5, 3, 2, 2, 1]


def _port(model, classif, dtype, mixup, lr, momentum, wd, draw):
    from iif_torch.data.augment import cifar_eval_transform, cifar_train_augment
    from iif_torch.data.cifar_lt import CIFAR10_MEAN, CIFAR10_STD
    from iif_torch.engine.classification import ClassificationTrainer
    from iif_torch.losses import get_criterion

    crit = get_criterion(classif[0], _counts(), deferred=classif[1])
    return ClassificationTrainer(
        model, crit, lambda s: lr,
        lambda g, x: cifar_train_augment(x, draw, CIFAR10_MEAN, CIFAR10_STD),
        lambda x: cifar_eval_transform(x, CIFAR10_MEAN, CIFAR10_STD), C,
        mixup_alpha=mixup, compute_dtype=dtype, seed=SEED,
        momentum=momentum, weight_decay=wd, device="cpu")


def _flat_jax(params, stats):
    """The JAX tree as the port's names."""
    from iif_torch.models.convert import classifier_state_from_jax

    return classifier_state_from_jax(jax.device_get(params),
                                     jax.device_get(stats))


# (compute dtype, criterion (classif, deferred), mixup alpha): f32 plain
# IIF, and bf16 with mixup (its f32 lambda promotes the bf16 batch, as in
# JAX) and deferred IIF weights
CASES = {
    "f32_iif": ("f32", ("iif", False), None),
    "bf16_mixup_deferred_iif": ("bf16", ("iif", True), MIXUP),
}
# f32, measured: loss 3.2e-7 relative, BN statistics 1.1e-6 of each
# tensor's largest, the update 4.1e-5 of each tensor's largest, the
# gradient 2.2e-5 in relative norm. bf16 rounds every conv and BN output,
# and BN's backward cancels: JAX's own bf16 gradients lie 0.4-23% (relative
# norm) from its f32 ones. So in bf16 the port's gradients are held to
# JAX's bf16 ones (measured up to 14.6% in relative norm) and, against the
# port's f32 step (JAX's f32 within 2.2e-5, above), to no more than twice
# JAX's own bf16 error (measured up to 1.30 times); loss 1.6e-3, BN
# statistics 4.1e-4.
TOL = {"f32": {"loss": 1e-5, "update": 1e-4, "grad": 1e-4, "stats": 1e-5},
       "bf16": {"loss": 5e-3, "grad": 0.25, "vs_f32": 2.0, "stats": 2e-3}}
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4


def _port_step(model, classif, dtype, mixup, draw, mix, batch):
    trainer = _port(model, classif, dtype, mixup, LR, MOMENTUM, WD, draw)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = trainer.train_step(trainer.init_state(), batch, mix=mix)
    assert state.step == 1
    return before, trainer.model.state_dict(), m


def _grad(p0, p1):
    """The first step's update is lr * (g + wd * p)."""
    return (p0 - p1) / LR - WD * p0


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(single_mesh, case):
    """One step: the loss, the metrics, the new BN statistics, the SGD
    update (momentum 0.9, coupled decay 1e-4) and the gradient it
    carries."""
    from iif_tpu.losses import get_criterion as jax_criterion

    dt_name, classif, mixup = CASES[case]
    bf16 = dt_name == "bf16"
    jtrainer = _jax_trainer(single_mesh, jax_criterion(
        classif[0], _counts(), deferred=classif[1]),
        jnp.bfloat16 if bf16 else jnp.float32, mixup, LR, MOMENTUM, WD)
    model = _port_model(torch.bfloat16 if bf16 else None)
    jstate = _jax_state(jtrainer, model)
    batch = _batch()
    draw, mix = _jax_draws(mixup)
    jnew, jm = jtrainer._train_step(jstate, {
        "image": jnp.asarray(batch["image"]),
        "label": jnp.asarray(batch["label"])})
    before, got, m = _port_step(
        model, classif, torch.bfloat16 if bf16 else torch.float32, mixup,
        draw, mix, batch)
    if bf16:
        _, got32, _ = _port_step(_port_model(None), classif, torch.float32,
                                 mixup, draw, mix, batch)
    tol = TOL[dt_name]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=tol["loss"])
    if not bf16:
        for key in ("acc1", "acc5"):
            assert float(m[key]) == float(jm[key])
    want = _flat_jax(jnew.params, jnew.batch_stats)
    n_params = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        p0 = before[k]
        if "running" in k:
            err = float((got[k] - w).abs().max()) / float(w.abs().max())
            assert err <= tol["stats"], (k, err)
            continue
        n_params += 1
        g_want, g_got = _grad(p0, w), _grad(p0, got[k])
        err = float((g_got - g_want).norm() / g_want.norm())
        assert err <= tol["grad"], ("grad", k, err)
        if bf16:
            g32 = _grad(p0, got32[k])
            assert (g_got - g32).norm() <= tol["vs_f32"] * (
                g_want - g32).norm(), ("bf16 error", k)
        else:
            upd = p0 - w
            err = float(((p0 - got[k]) - upd).abs().max() / upd.abs().max())
            assert err <= tol["update"], ("update", k, err)
    assert n_params == len(list(model.parameters()))


def test_evaluate_and_shot_acc_match_jax(single_mesh):
    """``evaluate`` with the inference-time IIF on the same weights: the
    counts, per-class counts, predictions and Many / Median / Low equal
    JAX's; the padded last batch counts once."""
    from iif_tpu.data import eval_batches as jax_eval_batches
    from iif_tpu.engine.per_shot import shot_acc as jax_shot_acc
    from iif_tpu.losses import get_criterion as jax_criterion

    from iif_torch.data.loader import eval_batches
    from iif_torch.engine.per_shot import shot_acc

    jtrainer = _jax_trainer(single_mesh, jax_criterion("iif", _counts()),
                            jnp.float32, None, LR, MOMENTUM, WD)
    model = _port_model(None, seed=2)
    jstate = _jax_state(jtrainer, model)
    trainer = _port(model, ("iif", False), torch.float32, None, LR,
                    MOMENTUM, WD, None)
    data = _batch(5, 27)
    want = jtrainer.evaluate(jstate, jax_eval_batches(
        data["image"], data["label"], B), print_fn=lambda *a: None)
    got = trainer.evaluate(eval_batches(data["image"], data["label"], B),
                           print_fn=lambda *a: None)
    for k in ("acc1", "acc5", "count"):
        assert got[k] == want[k], k
    for k in ("percls_correct", "percls_total", "preds", "labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["count"] == 27
    train_targets = np.repeat(np.arange(C), [150, 120, 90, 60, 40, 25, 19,
                                             12, 5, 1])
    assert shot_acc(got["preds"], got["labels"], train_targets) == \
        jax_shot_acc(want["preds"], want["labels"], train_targets)
