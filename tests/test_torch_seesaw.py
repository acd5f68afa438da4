"""The LVIS baselines' training pieces against the JAX package, on the CPU:
Seesaw (``iif_torch/detection/losses_extra.py``), the C+2 and IIF-normed
classifiers, gradient accumulation and the RSB recipe's AdamW with the
norm decay mask.

- ``seesaw_ce_loss`` and ``SeesawLoss`` (value with and without weights
  and ``avg_factor``, ``reduction="none"``, the gradient of the logits,
  ``get_activation``, ``get_accuracy``, ``update_cum``) at
  ``cum_samples`` of zeros and of skewed counts, 12 classes: within 1e-5
  of each tensor's largest magnitude (measured at most 4.8e-7);
  ``update_cum`` and ``get_accuracy`` equal.
- ``IIFNormedLinear`` against JAX's within 1e-5 (measured 1.2e-7), equal
  to ``NormedLinear`` on the same kernel to rounding where the IIF is
  positive, a zero entry's column 0 (``ROADMAP.md`` Queue 3); the bbox
  head with the normed C+2 classifier (the Seesaw config's) and with the
  IIF-normed one against JAX's ``Shared2FCBBoxHead``, through the
  converter.
- One ``grad_accum=2`` step of the Seesaw config's MaskRCNN (normed C+2
  classifier at temperature 20; its box half, the mask branch left out)
  with FASA at epoch 1, depth 14 ((1, 1, 1, 1) bottlenecks), 8 classes,
  64x96, B=2, against JAX's trainer step
  (``DetectionTrainer._train_step_impl``, its ``lax.scan`` over the
  micro-batches, each on its key ``step * 2 + i``, rebuilt for the port
  as ``noise``): the mean losses within 1e-5 relative, the accumulated
  gradient within 5e-3 of each tensor's largest JAX magnitude with the
  median within 2e-4 (the MaskRCNN step's standard), the new
  ``seesaw_cum`` equal (the two micro-batches' valid labels counted, in
  order) and the new FASA state within 1e-5 of each field's largest
  magnitude. JAX's optimizer there is a transformation that keeps the
  gradient as its state, so the step exposes it.
- Two AdamW steps of the RSB recipe (lr 2e-4, weight decay 0.05,
  ``norm_decay_mult=0``, frozen stage 1) on that gradient against optax's
  chain from the JAX package's ``build_optimizer`` with
  ``norm_decay_mask`` and ``frozen_backbone_mask``: every parameter to
  1e-6 relative; the norm layers' parameters took no decay.
- The checkpoint carries ``seesaw_cum`` under mmdet's buffer name and
  ``restore`` puts it back; serving drops it.

JAX's step compiles at XLA's backend optimisation level 1 (at level 0
it runs 20 times slower), the small programs at level 0."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iif_torch.detection import detector as td
from iif_torch.detection.bbox_head import Shared2FCBBoxHead
from iif_torch.detection.convert import _bbox_head, maskrcnn_state_from_jax
from iif_torch.detection.losses_extra import (
    SEESAW_CUM_KEY,
    SeesawLoss,
    seesaw_ce_loss,
)
from iif_torch.engine.detection import DetectionTrainer, frozen_param
from iif_torch.engine.schedules import build_lr_schedule, norm_decay_mask
from iif_torch.models.layers import IIFNormedLinear, NormedLinear
from tests.test_torch_c4 import _randomise
from tests.test_torch_cascade import (  # noqa: F401  (fixture)
    CANVAS,
    DEPTH,
    FAST,
    NUM_CLASSES,
    shallow,
)
from tests.test_torch_cascade_train import (
    B,
    CFG,
    GRAD_MEDIAN_REL,
    GRAD_REL,
    LOSS_REL,
    OPT,
    STATE_REL,
    _batch,
    _jax_states,
    _n_anchors,
    _trained_states,
)
from tests.test_torch_fasa import jax_fasa_noise
from tests.test_torch_train_targets import jax_loss_noise

torch.set_num_threads(1)

C = 12                       # classes of the loss cases
TOL = 1e-5                   # of each tensor's largest magnitude
CUMS = {"zeros": np.zeros(C + 1, np.float32),
        "skewed": np.array([0, 1, 3, 10, 250, 7, 7, 2, 90, 1, 4, 1000, 600],
                           np.float32)}
# the Seesaw config's box half; the mask branch, which neither Seesaw nor
# the accumulation touches, is left out: XLA's CPU backward of its
# transposed convolutions would add 4-5 s to JAX's run
SEESAW_MODEL = dict(num_classes=NUM_CLASSES, depth=DEPTH,
                    cls_predictor="normed", cls_temperature=20.0,
                    cls_channels=NUM_CLASSES + 2, with_mask=False)
CUM0 = np.array([5, 0, 40, 2, 9, 0, 130, 1, 700], np.float32)
FASA_CFG = {"decay_ratio": 0.1, "loss_aug_weight": 0.1}
SEED, STEP, ACCUM = 5, 3, 2
G = 6                        # gt slots an image of ``_batch``
RSB = dict(lr=2e-4, weight_decay=0.05)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jit(fn, *args):
    """``fn`` on ``args`` as one JAX program at XLA's level 0; numpy out."""
    args = [jnp.asarray(a) for a in args]
    out = jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def _loss_inputs(seed=0, n=48):
    rng = np.random.RandomState(seed)
    score = (rng.randn(n, C + 2) * 3).astype(np.float32)
    labels = rng.randint(0, C + 1, n)
    labels[:5] = C                            # background
    labels[5:9] = 4                           # a class several times
    weight = (rng.rand(n) < 0.8).astype(np.float32)
    return score, labels, weight


@pytest.mark.parametrize("cum", sorted(CUMS))
def test_seesaw_ce_loss_matches_jax(cum):
    from iif_tpu.detection.losses_extra import seesaw_ce_loss as jax_ce

    score, labels, _ = _loss_inputs()
    cls, lab = score[:, :C], np.clip(labels, 0, C - 1)
    pqs = ((0.8, 2.0), (0.0, 2.0), (0.8, 0.0))
    wants = _jit(lambda s, l, c: [jax_ce(s, l, c, p, q, 1e-2)
                                  for p, q in pqs],
                 cls, lab, CUMS[cum][:C])
    for (p, q), want in zip(pqs, wants):
        got = seesaw_ce_loss(_t(cls), _t(lab), _t(CUMS[cum][:C]), p, q, 1e-2)
        _close(got.numpy(), want)


@pytest.mark.parametrize("cum", sorted(CUMS))
def test_seesaw_loss_matches_jax(cum):
    """Value (weighted with the label weights' sum as ``avg_factor``, as
    the bbox head calls it, and unweighted), ``reduction="none"``, the
    logits' gradient, the activation, the accuracy and the counts."""
    from iif_tpu.detection.losses_extra import SeesawLoss as JaxSeesaw

    score, labels, weight = _loss_inputs(1)
    tl = SeesawLoss(CUMS[cum])

    def jax_all(cum, s, lab, w):
        jl = JaxSeesaw(cum)
        value, grad = jax.value_and_grad(
            lambda x: jl(x, lab, weight=w, avg_factor=w.sum()))(s)
        return (value, grad, jl(s, lab), jl(s, lab, weight=w,
                                            reduction="none"),
                jl.get_activation(s), jl.get_accuracy(s, lab),
                jl.update_cum(lab, w))

    want = _jit(jax_all, CUMS[cum], score, labels, weight)
    ts = _t(score).requires_grad_(True)
    got = tl(ts, _t(labels), weight=_t(weight), avg_factor=_t(weight).sum())
    got.backward()
    _close(got.item(), want[0])
    _close(ts.grad.numpy(), want[1])
    assert float(want[0]) > 0 and np.abs(want[1]).max() > 0
    _close(tl(_t(score), _t(labels)).item(), want[2])
    _close(tl(_t(score), _t(labels), weight=_t(weight),
              reduction="none").numpy(), want[3])
    act = tl.get_activation(_t(score))
    assert act.shape == (score.shape[0], C + 1)
    _close(act.numpy(), want[4])
    np.testing.assert_allclose(act.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(tl.get_accuracy(_t(score), _t(labels)),
                                  np.float32(want[5]))
    np.testing.assert_array_equal(
        tl.update_cum(_t(labels), _t(weight)).numpy(), want[6])
    assert tl.get_cls_channels(C) == C + 2 and tl.num_classes == C


def test_iif_normed_linear_matches_jax():
    """JAX's layer to 1e-5 of scale; ``NormedLinear`` on the same kernel
    to rounding where the IIF is positive (the factor cancels), and a
    zero entry's column 0: the JAX-side observation of Queue 3."""
    from iif_tpu.models.layers import IIFNormedLinear as JaxIIFNormed

    rng = np.random.RandomState(2)
    x = rng.randn(10, 64).astype(np.float32)
    kernel = rng.uniform(0.0, 2.0, (64, C + 1)).astype(np.float32)
    iif = np.linspace(0.2, 4.0, C + 1).astype(np.float32)
    iif[3] = 0.0
    layer = IIFNormedLinear(64, C + 1, iif, temperature=8.0)
    layer.weight.data = _t(kernel - np.float32(1.0))
    plain = NormedLinear(64, C + 1, temperature=8.0)
    plain.weight.data = layer.weight.data.clone()
    with torch.no_grad():
        got, base = layer(_t(x)).numpy(), plain(_t(x)).numpy()
    want = JaxIIFNormed(C + 1, iif_weights=tuple(iif), temperature=8.0).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))
    _close(got, want)
    assert "iif" not in layer.state_dict() and "iif" in dict(
        layer.named_buffers())
    pos = iif > 0
    _close(got[:, pos], base[:, pos], 1e-6)
    assert not got[:, ~pos].any() and np.abs(base[:, ~pos]).max() > 0.1


@pytest.mark.parametrize("predictor", ["normed_c2", "iif_normed"])
def test_bbox_head_classifiers_match_jax(predictor):
    """The Seesaw config's normed head at C+2 channels, and the IIF-normed
    head (C+1 channels whatever ``cls_channels`` says), converted from
    JAX's variables: scores, deltas and embeddings within 1e-5 of
    scale."""
    from iif_tpu.detection.bbox_head import Shared2FCBBoxHead as JaxHead

    rng = np.random.RandomState(3)
    iif = np.linspace(0.5, 2.0, NUM_CLASSES + 1).astype(np.float32)
    kw = (dict(cls_predictor="normed", cls_temperature=20.0,
               cls_channels=NUM_CLASSES + 2) if predictor == "normed_c2"
          else dict(cls_predictor="iif_normed", cls_temperature=8.0,
                    cls_channels=NUM_CLASSES + 2,
                    iif_weights=tuple(float(v) for v in iif)))
    jhead = JaxHead(NUM_CLASSES, **kw)
    x = rng.randn(6, 7, 7, 256).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 7, 7, 256))))
    params = _randomise(shapes, rng)["params"]
    params["fc_cls"]["kernel"] = rng.uniform(
        0.0, 2.0, params["fc_cls"]["kernel"].shape).astype(np.float32)
    sd = {}
    _bbox_head(sd, "h", params, gradients=False)
    head = Shared2FCBBoxHead(NUM_CLASSES, **kw)
    head.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = head(_t(x))
    want = jhead.apply({"params": params}, jnp.asarray(x))
    width = NUM_CLASSES + (2 if predictor == "normed_c2" else 1)
    assert got[0].shape == (6, width)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.fixture(scope="module")
def accum_step(shallow, single_mesh):
    """JAX's grad_accum=2 trainer step (its gradient kept as the
    optimizer's state) and the port's, on the same weights, batch, FASA
    state, Seesaw counts and draws."""
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.losses_extra import SeesawLoss as JaxSeesaw
    from iif_tpu.engine.detection import DetectionTrainer as JaxTrainer
    from iif_tpu.engine.detection import DetTrainState as JaxState

    rng = np.random.RandomState(0)
    jmodel = jd.MaskRCNN(**SEESAW_MODEL)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, rng)
    fc = variables["params"]["bbox_head"]["fc_cls"]
    fc["kernel"] = rng.uniform(0.0, 2.0, fc["kernel"].shape).astype(
        np.float32)
    tmodel = td.MaskRCNN(**SEESAW_MODEL)
    tmodel.load_state_dict(maskrcnn_state_from_jax(variables["params"],
                                                   variables["batch_stats"]))
    batch = _batch(np.random.RandomState(1))
    del batch["gt_masks_packed"]
    fasa = _trained_states(np.random.RandomState(2), 1)[0]

    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    jtrainer = JaxTrainer(jmodel, JaxSeesaw(jnp.asarray(CUM0)), keep,
                          single_mesh, jd.DetTrainCfg(roi_ext="ml", **CFG),
                          fasa_cfg=FASA_CFG, seed=SEED, grad_accum=ACCUM)
    jstate = JaxState(step=jnp.asarray(STEP, jnp.int32),
                      params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=keep.init(variables["params"]),
                      fasa=_jax_states((fasa,))[0],
                      seesaw_cum=jnp.asarray(CUM0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(functools.partial(jtrainer._train_step_impl,
                                     fasa_aug_on=True))
    new, metrics = step.lower(jstate, jbatch).compile(
        compiler_options=OPT)(jstate, jbatch)
    zero_stats = jax.tree_util.tree_map(np.zeros_like,
                                        variables["batch_stats"])
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": maskrcnn_state_from_jax(new.opt_state, zero_stats,
                                             gradients=True),
            "jax_grads": jax.tree_util.tree_map(np.asarray, new.opt_state),
            "cum": np.asarray(new.seesaw_cum), "fasa": new.fasa,
            "variables": variables}

    noise = []
    for i in range(ACCUM):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), STEP * ACCUM + i)
        nz = jax_loss_noise(key, B // ACCUM, _n_anchors(),
                            G + CFG["rpn_max_per_img"])
        nz["fasa"] = jax_fasa_noise(jax.random.split(key, 3)[2],
                                    NUM_CLASSES, 1024)
        noise.append(nz)
    trainer = DetectionTrainer(
        tmodel, SeesawLoss(CUM0), lambda s: 0.0, td.DetTrainCfg(**CFG),
        {"type": "sgd", "momentum": 0.0, "weight_decay": 0.0}, seed=SEED,
        device="cpu", fasa_cfg=FASA_CFG, grad_accum=ACCUM)
    state = trainer.init_state(fasa)
    state.step = STEP
    state, got_metrics = trainer.train_step(state, batch, noise=noise,
                                            epoch=1)
    got = {"metrics": {k: v.item() for k, v in got_metrics.items()},
           "grads": {n: p.grad for n, p in tmodel.named_parameters()},
           "state": state, "trainer": trainer, "batch": batch}
    return got, want


def test_accumulated_step_losses_and_counts_match_jax(accum_step):
    """The micro-batches' mean losses (``acc``, the positives' accuracy,
    is the port's log only) and the counts after both micro-batches."""
    got, want = accum_step
    m, jm = got["metrics"], want["metrics"]
    assert set(m) == set(jm) | {"acc"}
    assert set(jm) == {"loss", "loss_cls", "loss_bbox", "loss_rpn_cls",
                       "loss_rpn_bbox"}
    for k, v in jm.items():
        assert np.isfinite(m[k]) and v > 0, k
        np.testing.assert_allclose(m[k], v, rtol=LOSS_REL, err_msg=k)
    assert 0.0 <= m["acc"] <= 100.0
    cum = got["state"].seesaw_cum.numpy()
    np.testing.assert_array_equal(cum, want["cum"])
    added = cum - CUM0
    assert 0 < added.sum() <= B * CFG["rcnn_num_samples"]
    assert added[-1] > 0 and added[:-1].sum() > 0
    assert got["state"].step == STEP + 1


def test_accumulated_gradients_match_jax(accum_step):
    """Each trainable parameter's gradient, the sum over the micro-batches
    divided by 2 (JAX computes the frozen ones too; the port gives them
    none)."""
    got, want = accum_step
    checked = 0
    for name, g in got["grads"].items():
        w = want["grads"][name].numpy()
        if g is None:
            assert frozen_param(name, 1), name
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        err = np.abs(g.numpy() - w)
        assert err.max() <= GRAD_REL * scale, (name, err.max(), scale)
        assert np.median(err) <= GRAD_MEDIAN_REL * scale, (name, scale)
        checked += 1
    assert checked > 40


def test_accumulated_fasa_state_matches_jax(accum_step):
    got, want = accum_step
    for name, a, b in zip(got["state"].fasa._fields, got["state"].fasa,
                          want["fasa"]):
        _close(a.numpy(), np.asarray(b), STATE_REL)


def test_rsb_adamw_with_norm_decay_mask_matches_optax(accum_step):
    """Two steps of the RSB optimizer (``adamw``, wd 0.05,
    ``norm_decay_mult=0``, stage 1 frozen) from the same weights on JAX's
    accumulated gradient: the port's ``AdamWOptax`` in two parameter
    groups against optax's chain with ``norm_decay_mask`` and
    ``frozen_backbone_mask``, every parameter to 1e-6 relative."""
    from iif_tpu.engine.detection import frozen_backbone_mask
    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule
    from iif_tpu.engine.schedules import build_optimizer as jax_optimizer
    from iif_tpu.engine.schedules import norm_decay_mask as jax_mask

    got, want = accum_step
    variables = want["variables"]
    params = variables["params"]
    model = td.MaskRCNN(**SEESAW_MODEL)
    model.load_state_dict(maskrcnn_state_from_jax(params,
                                                  variables["batch_stats"]))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = DetectionTrainer(
        model, SeesawLoss(CUM0), build_lr_schedule(RSB["lr"], 100,
                                                   warmup_iters=0),
        td.DetTrainCfg(**CFG), {"type": "adamw",
                                "weight_decay": RSB["weight_decay"]},
        device="cpu", norm_decay=False)
    state = trainer.init_state()
    decay = norm_decay_mask(model)
    norm_names = {n for n, d in decay.items() if not d}
    assert norm_names and all(".bn" in n or "downsample.1" in n
                              for n in norm_names)
    groups = state.optimizer.param_groups
    # the normed classifier's weight, JAX's kernel less 1, decays as p + 1
    assert [(g["weight_decay"], g["decay_offset"]) for g in groups] == [
        (RSB["weight_decay"], 0.0), (0.0, 0.0), (RSB["weight_decay"], 1.0)]
    assert groups[2]["params"] == [model.roi_head.bbox_head.fc_cls.weight]
    jmask = jax_mask(params)
    assert sum(not v for v in jax.tree_util.tree_leaves(jmask)) == len(
        norm_names)
    tx = jax_optimizer("adamw", jax_schedule(RSB["lr"], 100, 12,
                                             warmup_iters=0),
                       weight_decay=RSB["weight_decay"],
                       trainable_mask=frozen_backbone_mask(params, 1),
                       decay_mask=jax_mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ostate = tx.init(jp)
    def apply(g, o, p):
        upd, o = tx.update(g, o, p)
        return optax.apply_updates(p, upd), o

    update = jax.jit(apply).lower(
        want["jax_grads"], ostate, jp).compile(compiler_options=FAST)
    jgrads = want["grads"]
    for step in range(2):
        scale = np.float32(1.0 + step)     # a second, different gradient
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = jgrads[n] * scale
        state.optimizer.step()
        state.scheduler.step()
        g_tree = jax.tree_util.tree_map(lambda g: g * scale,
                                        want["jax_grads"])
        jp, ostate = update(g_tree, ostate, jp)
    jnew = maskrcnn_state_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   variables["batch_stats"])
    moved_norm = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jnew[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        if frozen_param(n, 1):
            assert torch.equal(p.detach(), before[n]), n
        elif n in norm_names:
            moved_norm += 1
    assert moved_norm > 0


def test_checkpoint_carries_seesaw_counts(accum_step, tmp_path):
    """``save_checkpoint`` writes ``seesaw_cum`` under mmdet's name;
    ``restore`` puts it back; ``load_checkpoint`` and ``load_weights``
    leave it out."""
    from iif_torch.detection.inference import load_checkpoint
    from iif_torch.utils.checkpoint import (
        load_weights,
        restore,
        save_checkpoint,
    )

    got, _ = accum_step
    trainer, state = got["trainer"], got["state"]
    path = save_checkpoint(str(tmp_path), 1, trainer.model, state)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert SEESAW_CUM_KEY == "roi_head.bbox_head.loss_cls.cum_samples"
    assert torch.equal(saved["state_dict"][SEESAW_CUM_KEY], state.seesaw_cum)
    fresh = trainer.init_state()
    assert torch.equal(fresh.seesaw_cum, torch.from_numpy(CUM0))
    restore(path, trainer.model, fresh)
    assert torch.equal(fresh.seesaw_cum, state.seesaw_cum)
    assert fresh.step == state.step
    load_checkpoint(trainer.model, path)
    load_weights(path, trainer.model)
