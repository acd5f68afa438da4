"""Training the FASA family against the JAX package, on the CPU, at depth
14 ((1, 1, 1, 1) bottlenecks), 8 classes, f32, a 64x96 canvas, B=2 with
masks at stride 2, every parameter randomised (``tests/
test_torch_cascade.py::random_cascade_variables``), on JAX's own draws
(rebuilt from its key chain and handed to the port as ``noise``):

- ``cascade_loss`` of the FASA cascade (normed heads, class-specific
  regressors, the 0.33 stage stds) with a ``FasaState`` a stage, at epoch
  0 (fresh states from instance counts) and at epoch 1 (states after some
  training, the virtual-feature CE on); JAX runs one compiled epoch-1
  program for both, its epoch-0 numbers from states whose ``prob_list``
  is 0, where every virtual feature is unselected and the aug loss and
  its gradient are exactly 0;
- ``maskrcnn_loss`` of the FASA MaskRCNN (normed heads) at epoch 1;
- one batch of the dynamic runner's val pass,
  ``DetectionTrainer._fasa_accumulate_batch``, of both.

Compared: every loss to 1e-5 relative, every gradient within 5e-3 of its
tensor's largest JAX magnitude with the median within 2e-4 (the MaskRCNN
step's standard, ``tests/test_torch_train_step.py``), the new FASA states
within 1e-5 of each field's largest magnitude. Measured, cascade (both
epochs): losses 2.8e-7, gradients 2.2e-3 at most (median 3.6e-5),
states 5.4e-6; MaskRCNN: 2.3e-7, 6.2e-6 (1.4e-7), 2.1e-6; the val
pass's counters 7.2e-8 (cascade) and 2.5e-8 (MaskRCNN). Then the port
alone: the trainer's FASA cascade step with gradient clipping, and
``fresh_init_`` over the cascade's and the normed layers' tensors. JAX's
training programs compile at XLA's backend optimisation level 1 (at
level 0 the CPU backward of the mask heads' transposed convolutions makes
a cascade run 7 times slower), the val passes at level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection import detector as td
from iif_torch.detection.cascade import cascade_loss
from iif_torch.detection.convert import (
    cascade_state_from_jax,
    maskrcnn_state_from_jax,
)
from iif_torch.detection.fasa import FasaState, init_fasa_state
from iif_torch.detection.losses import DetIIFLoss
from tests.test_torch_cascade import (  # noqa: F401  (fixtures)
    CANVAS,
    FAST,
    NUM_CLASSES,
    models,
    shallow,
)
from tests.test_torch_fasa import jax_fasa_noise
from tests.test_torch_train_targets import jax_sampler_noise, make_gt

torch.set_num_threads(1)

OPT = {"xla_backend_optimization_level": 1,
       "xla_llvm_disable_expensive_passes": True}
B, G, STRIDE = 2, 6, 2
# two mask RoIs an image: XLA's CPU backward of the mask heads' 2x2
# transposed convs is most of JAX's run time
CFG = dict(rpn_nms_pre=200, rpn_max_per_img=50, rcnn_num_samples=16,
           num_mask_rois=2, mask_gt_stride=STRIDE)
FASA_CFG = {"decay_ratio": 0.1, "loss_aug_weight": 0.1}
IIF = np.linspace(0.8, 1.2, NUM_CLASSES + 1).astype(np.float32)
COUNTS = np.array([3, 40, 1, 7, 120, 2, 9, 15])
LOSS_REL = 1e-5
GRAD_REL = 5e-3
GRAD_MEDIAN_REL = 2e-4
STATE_REL = 1e-5


def _batch(rng):
    gtb, gtl, gtv = make_gt(rng, B, G, NUM_CLASSES, CANVAS)
    h, w = CANVAS[0] // STRIDE, CANVAS[1] // STRIDE
    coarse = rng.rand(B, G, h // 4 + 1, w // 4 + 1)
    masks = (np.kron(coarse, np.ones((4, 4)))[:, :, :h, :w] > 0.5)
    return {"image": rng.randint(0, 256, (B,) + CANVAS + (3,)).astype(
                np.uint8),
            "gt_boxes": gtb, "gt_labels": gtl, "gt_valid": gtv,
            "gt_masks_packed": np.packbits(masks.astype(np.uint8), axis=-1)}


def _trained_states(rng, n):
    """``n`` states as after some training: most classes seen, random
    statistics, probabilities of 0.3-0.9."""
    out = []
    for _ in range(n):
        used = (rng.rand(NUM_CLASSES) < 0.8).astype(np.float32)
        out.append(FasaState(*(torch.from_numpy(x.astype(np.float32)) for x in (
            np.abs(rng.randn(NUM_CLASSES, 1024)) * used[:, None],
            rng.rand(NUM_CLASSES, 1024) * used[:, None], used,
            rng.uniform(0.3, 0.9, NUM_CLASSES), np.zeros(NUM_CLASSES + 1),
            np.zeros(NUM_CLASSES + 1), np.zeros(NUM_CLASSES + 1)))))
    return tuple(out)


def _jax_states(states):
    from iif_tpu.detection.fasa import FasaState as JaxState

    return tuple(JaxState(*(jnp.asarray(t.numpy()) for t in s))
                 for s in states)


def _n_anchors():
    return sum(h * w * 3 for h, w in td.fpn_shapes(CANVAS))


def _close_to_scale(got, want, name):
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want)
    assert err.max() <= GRAD_REL * scale, (name, err.max(), scale)
    assert np.median(err) <= GRAD_MEDIAN_REL * scale, (name, scale)


def _port_run(model, loss_fn, batch, noise, **kw):
    model.train()                       # norm_eval: BN keeps its statistics
    model.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, losses, aux = loss_fn(model, tb, DetIIFLoss(IIF),
                                 td.DetTrainCfg(**CFG), noise=noise,
                                 fasa_cfg=FASA_CFG, **kw)
    total.backward()
    return {"losses": {k: v.item() for k, v in losses.items()},
            "total": total.item(), "fasa": aux["fasa_state"],
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def _jax_result(out, to_torch, zero_stats):
    (total, (losses, fasa)), grads = out
    return {"losses": {k: float(v) for k, v in losses.items()},
            "total": float(total), "fasa": fasa,
            "grads": to_torch(grads, zero_stats, gradients=True)}


def _compare(got, want):
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        np.testing.assert_allclose(got["losses"][k], v, rtol=LOSS_REL,
                                   err_msg=k)
    np.testing.assert_allclose(got["total"], want["total"], rtol=LOSS_REL)
    checked = 0
    for name, g in got["grads"].items():
        if g is None:
            assert not np.any(want["grads"][name].numpy()), name
            continue
        _close_to_scale(g.numpy(), want["grads"][name].numpy(), name)
        checked += 1
    assert checked > 50
    gf, wf = got["fasa"], want["fasa"]
    if hasattr(gf, "_fields"):          # one state, not one a stage
        gf, wf = (gf,), (wf,)
    assert len(gf) == len(wf)
    for a, b in zip(gf, wf):
        for name, x, y in zip(FasaState._fields, a, b):
            if name == "prob_list":
                continue          # input unchanged; JAX's epoch 0 zeroes it
            y = np.asarray(y)
            scale = max(float(np.abs(y).max()), 1e-30)
            np.testing.assert_allclose(x.numpy(), y, atol=STATE_REL * scale,
                                       rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def cascade_runs(models):
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.cascade import cascade_loss as jax_cascade_loss
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    jmodel, variables, model = models
    batch = _batch(np.random.RandomState(1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = jd.DetTrainCfg(roi_ext="ml", **CFG)
    jloss = JaxIIF(jnp.asarray(IIF))
    key = jax.random.PRNGKey(5)
    fresh = tuple(init_fasa_state(COUNTS) for _ in range(3))
    trained = _trained_states(np.random.RandomState(2), 3)

    def run(params, states):
        def loss_fn(p):
            total, losses, aux = jax_cascade_loss(
                jmodel, {"params": p, "batch_stats": variables["batch_stats"]},
                jbatch, key, (jloss,) * 3, jcfg, fasa_states=states,
                fasa_cfg=FASA_CFG, epoch=1)
            return total, (losses, aux["fasa_state"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    compiled = jax.jit(run).lower(variables["params"], _jax_states(
        trained)).compile(compiler_options=OPT)
    zero_stats = jax.tree_util.tree_map(np.zeros_like,
                                        variables["batch_stats"])
    # JAX's epoch 0: every prob_list 0, so no virtual feature is selected
    unselected = tuple(s._replace(prob_list=jnp.zeros_like(s.prob_list))
                       for s in _jax_states(fresh))
    keys = jax.random.split(key, 7)
    noise = {"rpn": jax_sampler_noise(keys[0], B, _n_anchors()),
             "rcnn": [jax_sampler_noise(keys[1], B,
                                        G + CFG["rpn_max_per_img"])] + [
                 jax_sampler_noise(keys[s], B, CFG["rcnn_num_samples"])
                 for s in (2, 3)],
             "fasa": [jax_fasa_noise(keys[4 + s], NUM_CLASSES, 1024)
                      for s in range(3)]}
    out = {}
    for epoch, states, jstates in ((0, fresh, unselected),
                                   (1, trained, _jax_states(trained))):
        out[epoch] = (
            _port_run(model, cascade_loss, batch, noise,
                      fasa_state=states, epoch=epoch),
            _jax_result(compiled(variables["params"], jstates),
                        cascade_state_from_jax, zero_stats))
    return out


@pytest.mark.parametrize("epoch", [0, 1])
def test_cascade_loss_with_fasa_matches_jax(cascade_runs, epoch):
    got, want = cascade_runs[epoch]
    assert {f"s{s}.loss_{k}" for s in range(3)
            for k in ("cls", "bbox", "mask")} <= set(got["losses"])
    _compare(got, want)
    # the stage weights and the aug term show in the losses
    if epoch == 1:
        assert got["losses"]["s0.loss_cls"] != cascade_runs[0][0][
            "losses"]["s0.loss_cls"]
    assert all(s.feature_used.sum() > 0 for s in got["fasa"])


@pytest.fixture(scope="module")
def maskrcnn_models(shallow):
    """The FASA MaskRCNN (normed heads) at depth 14: JAX's model, its
    randomised variables (the normed classifier's kernel from U(0, 2)) and
    the port's model carried by ``maskrcnn_state_from_jax``."""
    from iif_tpu.detection import detector as jd
    from tests.test_torch_c4 import _randomise

    kw = dict(num_classes=NUM_CLASSES, depth=14, cls_predictor="normed",
              mask_predictor="normed")
    jmodel = jd.MaskRCNN(**kw)
    rng = np.random.RandomState(3)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, rng)
    variables["params"]["bbox_head"]["fc_cls"]["kernel"] = rng.uniform(
        0.0, 2.0, (1024, NUM_CLASSES + 1)).astype(np.float32)
    model = td.MaskRCNN(**kw)
    model.load_state_dict(maskrcnn_state_from_jax(variables["params"],
                                                  variables["batch_stats"]))
    return jmodel, variables, model


def test_maskrcnn_loss_with_fasa_epoch1_matches_jax(maskrcnn_models):
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    jmodel, variables, model = maskrcnn_models
    batch = _batch(np.random.RandomState(4))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = jd.DetTrainCfg(roi_ext="ml", **CFG)
    key = jax.random.PRNGKey(6)
    (state,) = _trained_states(np.random.RandomState(5), 1)

    def loss_fn(p, st):
        total, losses, aux = jd.maskrcnn_loss(
            jmodel, {"params": p, "batch_stats": variables["batch_stats"]},
            jbatch, key, JaxIIF(jnp.asarray(IIF)), jcfg, fasa_state=st,
            fasa_cfg=FASA_CFG, epoch=1)
        return total, (losses, aux["fasa_state"])

    compiled = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        variables["params"], _jax_states((state,))[0]).compile(
            compiler_options=OPT)
    want = _jax_result(compiled(variables["params"],
                                _jax_states((state,))[0]),
                       maskrcnn_state_from_jax,
                       jax.tree_util.tree_map(np.zeros_like,
                                              variables["batch_stats"]))
    k_rpn, k_rcnn, k_fasa = jax.random.split(key, 3)
    noise = {"rpn": jax_sampler_noise(k_rpn, B, _n_anchors()),
             "rcnn": jax_sampler_noise(k_rcnn, B,
                                       G + CFG["rpn_max_per_img"]),
             "fasa": jax_fasa_noise(k_fasa, NUM_CLASSES, 1024)}
    got = _port_run(model, td.maskrcnn_loss, batch, noise,
                    fasa_state=state, epoch=1)
    _compare(got, want)


def _val_states(rng, n):
    """``n`` states part-way through a val pass: ``_trained_states`` with
    counters already holding some losses and labels."""
    return tuple(s._replace(
        cum_losses=torch.from_numpy(rng.rand(NUM_CLASSES + 1).astype(
            np.float32) * 5),
        cum_labels=torch.from_numpy(rng.randint(
            0, 6, NUM_CLASSES + 1).astype(np.float32)))
        for s in _trained_states(rng, n))


@pytest.mark.parametrize("family", ["cascade", "maskrcnn"])
def test_fasa_val_batch_matches_jax(family, request, single_mesh):
    """One batch of the dynamic runner's val pass: JAX's
    ``DetectionTrainer._fasa_accumulate_batch`` (the eval-mode trunk, the
    proposals under ``train_cfg``, each stage's RoIs sampled at its IoU
    and refined by the target labels) against the port's on JAX's draws
    (``split(fold_in(PRNGKey(seed), step + 999_983), 3)`` a stage for the
    cascade, the key itself for MaskRCNN). Each stage's ``cum_losses`` and
    ``cum_labels`` within 1e-5 of their largest magnitude, every other
    field unchanged."""
    import optax

    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF
    from iif_tpu.engine.detection import DetectionTrainer as JaxTrainer
    from iif_tpu.engine.detection import DetTrainState as JaxState
    from iif_torch.engine.detection import (
        VAL_KEYS,
        VAL_STEP_OFFSET,
        DetectionTrainer,
        DetTrainState,
    )

    cascade = family == "cascade"
    jmodel, variables, model = request.getfixturevalue(
        "models" if cascade else "maskrcnn_models")
    seed, step = 5, 3
    states = _val_states(np.random.RandomState(8), 3 if cascade else 1)
    batch = _batch(np.random.RandomState(9))
    jtrainer = JaxTrainer(jmodel, JaxIIF(jnp.asarray(IIF)), optax.sgd(0.1),
                          single_mesh, jd.DetTrainCfg(**CFG),
                          fasa_cfg=FASA_CFG, seed=seed)
    jstates = _jax_states(states) if cascade else _jax_states(states)[0]
    jstate = JaxState(step=jnp.asarray(step), params=variables["params"],
                      batch_stats=variables["batch_stats"], opt_state=None,
                      fasa=jstates)
    feed = {k: jnp.asarray(batch[k]) for k in VAL_KEYS}
    want = JaxTrainer._fasa_accumulate_batch.lower(
        jtrainer, jstate, feed, jstates).compile(compiler_options=FAST)(
            jstate, feed, jstates)

    key = jax.random.fold_in(jax.random.PRNGKey(seed),
                             step + VAL_STEP_OFFSET)
    n_cand, r = G + CFG["rpn_max_per_img"], CFG["rcnn_num_samples"]
    if cascade:
        keys = jax.random.split(key, 3)
        noise = [jax_sampler_noise(keys[0], B, n_cand)] + [
            jax_sampler_noise(k, B, r) for k in keys[1:]]
    else:
        noise = [jax_sampler_noise(key, B, n_cand)]
    trainer = DetectionTrainer(model, DetIIFLoss(IIF), lambda s: 0.0,
                               td.DetTrainCfg(**CFG), seed=seed,
                               device="cpu", fasa_cfg=FASA_CFG)
    got = trainer._fasa_accumulate_batch(
        DetTrainState(step, None, None, states),
        {k: torch.from_numpy(np.asarray(batch[k])) for k in VAL_KEYS},
        states if cascade else states[0], noise=noise)
    assert model.training                 # the pass restores train mode
    if not cascade:
        got, want = (got,), (want,)
    assert len(got) == len(want) == len(states)
    for g, w, before in zip(got, want, states):
        for name, x, y, x0 in zip(FasaState._fields, g, w, before):
            y = np.asarray(y)
            if name in ("cum_losses", "cum_labels"):
                assert (x - x0).sum() > 0, name   # the batch added to it
                scale = float(np.abs(y).max())
                np.testing.assert_allclose(x.numpy(), y,
                                           atol=STATE_REL * scale, rtol=0,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(x.numpy(), x0.numpy(),
                                              err_msg=name)
                np.testing.assert_array_equal(y, x0.numpy(), err_msg=name)


def test_trainer_steps_the_fasa_cascade_with_clipping(shallow):
    """``trainer_from_config`` on the FASA cascade config (shrunk; every
    tensor from ``fresh_init_``): an epoch-1 step moves each stage's FASA
    state, with ``grad_clip`` 35 (the global norm a metric)."""
    from iif_torch.config import Config
    from iif_torch.engine.detection import (
        init_fasa_states,
        trainer_from_config,
    )

    cfg = Config.fromfile(
        "configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py")
    cfg.merge_from_options({
        "model.depth": 14, "model.num_classes": NUM_CLASSES,
        "model.compute_dtype": None,
        "optimizer_config": {"grad_clip": {"max_norm": 35}},
        **{f"train_cfg.{k}": v for k, v in CFG.items()}})
    trainer = trainer_from_config(cfg, DetIIFLoss(IIF), 10, device="cpu")
    assert trainer.grad_clip == 35 and trainer.fasa_cfg["dynamic_up"] == 1.1
    assert trainer.train_cfg.rpn_max_per_img == 50
    state = trainer.init_state(init_fasa_states(trainer.model, COUNTS,
                                                cfg.fasa_cfg))
    assert len(state.fasa) == 3 and state.fasa[0] is not state.fasa[1]
    state, m = trainer.train_step(state, _batch(np.random.RandomState(6)),
                                  epoch=1)
    assert all(s.feature_used.sum() > 0 for s in state.fasa)
    assert np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0
    assert state.step == 1


def test_fresh_init_of_the_normed_layers():
    """The normed classifier is U(-1, 1) (flax's U(0, 2) less 1), the
    normed mask predictor ``lecun_normal`` (std 1 / sqrt(256), truncated
    at 2 std); the trainer test above covers every tensor of the
    cascade."""
    from iif_torch.detection.bbox_head import Shared2FCBBoxHead
    from iif_torch.detection.init import fresh_init_
    from iif_torch.detection.mask_head import FCNMaskHead

    gen = torch.Generator().manual_seed(0)
    head = fresh_init_(Shared2FCBBoxHead(300, cls_predictor="normed",
                                         reg_class_agnostic=True), gen)
    w = head.fc_cls.weight.detach()
    assert w.shape == (1024, 301) and head.fc_reg.weight.shape == (4, 1024)
    assert -1.0 <= float(w.min()) < -0.99 and 0.99 < float(w.max()) < 1.0
    assert abs(float(w.mean())) < 0.01
    assert float(head.fc_reg.weight.std()) < 0.0011
    k = fresh_init_(FCNMaskHead(300, predictor="normed"),
                    gen).conv_logits.weight.detach()
    std = 1.0 / np.sqrt(256)
    assert abs(float(k.std()) - std) < 0.05 * std
    assert float(k.abs().max()) <= 2.0 * std / 0.8796256610342398 + 1e-6
