"""One whole Faster R-CNN R50-C4 training step of the port against the JAX
package: f32, depth 50, a 64x96 canvas, B=2, 3 classes, the small
``train_cfg`` of ``tests/test_c4.py`` (128 candidates, 64 proposals, 32
RoIs an image), the same weights (one randomised JAX variable tree, into
the port through ``c4_state_from_jax``) and the same sampling noise (JAX's
draw under the step's key, with ``c4_loss``'s two-way split).

JAX: ``jax.value_and_grad(c4_loss)`` under ``fold_in(PRNGKey(seed),
step)``, then ``build_optimizer`` with ``frozen_backbone_mask``. Port:
``DetectionTrainer.train_step``, which dispatches to ``c4_loss``.
Compared: the four losses, every parameter's gradient (JAX's mapped onto
torch names through ``c4_state_from_jax``, res5's ``shared_head`` among
them), the frozen parameters, the parameters after the SGD step. Then the
trainer that ``trainer_from_config`` builds for the C4 config, and
``DetCrossEntropyLoss`` against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection.c4 import C4FasterRCNN, c4_loss
from iif_torch.detection.convert import c4_state_from_jax
from iif_torch.detection.detector import DetTrainCfg, MaskRCNN
from iif_torch.detection.losses import DetCrossEntropyLoss
from iif_torch.engine.detection import (
    DetectionTrainer,
    frozen_param,
    trainer_from_config,
)
from iif_torch.engine.schedules import build_lr_schedule
from tests.test_torch_c4 import _randomise
from tests.test_torch_train_targets import jax_sampler_noise, make_gt

torch.set_num_threads(1)

NUM_CLASSES = 3
CANVAS = (64, 96)
B, G = 2, 6
SEED, STEP = 7, 0
LR = 0.02
CFG = dict(rpn_nms_pre=128, rpn_max_per_img=64, rcnn_num_samples=32)
LOSS_KEYS = {"loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox"}
C4_CONFIG = "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py"
# Gradients and updates, per tensor, against its largest JAX magnitude:
# the largest error within GRAD_REL, the median within GRAD_MEDIAN_REL,
# as in tests/test_torch_train_step.py, whose ReLU-kink finding applies:
# the two f32 trunks sum their convolutions in another order, and where
# that moves a pre-activation across 0 a ReLU passes its gradient on one
# side only. Measured here: gradients 2.3e-5 at most (a res5 BN bias), a
# tensor's median element 2.2e-7 at most; the updates, read as
# differences of f32 parameters, 3.0e-4 at most (the rounding of p + dp).
GRAD_REL = 5e-3
GRAD_MEDIAN_REL = 2e-4


def _close_to_scale(got, want, name):
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want)
    assert err.max() <= GRAD_REL * scale, (name, err.max(), scale)
    assert np.median(err) <= GRAD_MEDIAN_REL * scale, (name, scale)


def jax_c4_noise(key, b, n_anchors, n_cand):
    """All draws of ``iif_tpu``'s ``c4_loss`` under ``key``
    (``c4.py:133``: ``split(key)`` -> ``k_rpn, k_rcnn``)."""
    k_rpn, k_rcnn = jax.random.split(key)
    return {"rpn": jax_sampler_noise(k_rpn, b, n_anchors),
            "rcnn": jax_sampler_noise(k_rcnn, b, n_cand)}


@pytest.fixture(scope="module")
def step_run():
    from iif_tpu.detection import c4 as jc4
    from iif_tpu.detection.detector import DetTrainCfg as JaxTrainCfg
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE
    from iif_tpu.engine.detection import frozen_backbone_mask
    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule
    from iif_tpu.engine.schedules import build_optimizer as jax_optimizer

    rng = np.random.RandomState(0)
    jmodel = jc4.C4FasterRCNN(num_classes=NUM_CLASSES, depth=50)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, rng)
    model = C4FasterRCNN(num_classes=NUM_CLASSES, depth=50)
    model.load_state_dict(c4_state_from_jax(variables["params"],
                                            variables["batch_stats"]))
    gtb, gtl, gtv = make_gt(rng, B, G, NUM_CLASSES, CANVAS)
    batch = {"image": rng.randint(0, 256, (B,) + CANVAS + (3,)).astype(
                 np.uint8),
             "gt_boxes": gtb, "gt_labels": gtl, "gt_valid": gtv}

    # JAX: the grad_accum=1 branch of DetectionTrainer._train_step_impl
    jcfg = JaxTrainCfg(**CFG)
    jloss = JaxCE(NUM_CLASSES)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), STEP)

    def loss_fn(params):
        total, losses, _ = jc4.c4_loss(
            jmodel, {"params": params,
                     "batch_stats": variables["batch_stats"]},
            jbatch, key, jloss, jcfg)
        return total, losses

    tx = jax_optimizer("sgd", jax_schedule(LR, 100, 12, warmup_iters=0),
                       0.9, 1e-4, trainable_mask=frozen_backbone_mask(
                           variables["params"], 1))

    def step(params):
        (total, losses), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return total, losses, grads, optax.apply_updates(params, updates)

    jtotal, jlosses, jgrads, jnew = jax.jit(step)(variables["params"])
    zero_stats = jax.tree_util.tree_map(np.zeros_like,
                                        variables["batch_stats"])

    # port: one trainer step with JAX's noise
    fh, fw = -(-CANVAS[0] // 16), -(-CANVAS[1] // 16)
    noise = jax_c4_noise(key, B, fh * fw * 15, G + CFG["rpn_max_per_img"])
    trainer = DetectionTrainer(
        model, DetCrossEntropyLoss(NUM_CLASSES),
        build_lr_schedule(LR, 100, warmup_iters=0), DetTrainCfg(**CFG),
        {"type": "sgd", "momentum": 0.9, "weight_decay": 1e-4},
        seed=SEED, device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tstate = trainer.init_state()
    tstate, metrics = trainer.train_step(tstate, batch, noise=noise)
    return {
        "jax_losses": {k: float(v) for k, v in jlosses.items()},
        "jax_total": float(jtotal),
        "jax_grads": c4_state_from_jax(jgrads, zero_stats),
        "jax_new": c4_state_from_jax(jnew, variables["batch_stats"]),
        "metrics": {k: v.item() for k, v in metrics.items()},
        "grads": {n: p.grad for n, p in model.named_parameters()},
        "new": {k: v.detach() for k, v in model.state_dict().items()},
        "before": before, "state": tstate, "trainer": trainer,
    }


def test_step_losses_match_jax(step_run):
    """rtol 1e-4 (conv summation order)."""
    m, jl = step_run["metrics"], step_run["jax_losses"]
    assert step_run["trainer"].loss_fn is c4_loss
    assert set(jl) == LOSS_KEYS and set(m) == LOSS_KEYS | {"loss"}
    for k in LOSS_KEYS:
        assert np.isfinite(m[k]) and m[k] > 0, k
        np.testing.assert_allclose(m[k], jl[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(m["loss"], step_run["jax_total"], rtol=1e-4)


def test_step_gradients_match_jax(step_run):
    """Every trainable tensor: the trunk's stages 2-3, the RPN head, res5
    per RoI (``ResLayer``: its convs and the BN affine parameters, its BN
    on running statistics) and the bbox head."""
    grads, jgrads = step_run["grads"], step_run["jax_grads"]
    checked = {"backbone": 0, "rpn_head": 0, "roi_head.shared_head": 0,
               "roi_head.bbox_head": 0}
    for name, g in grads.items():
        if g is None:
            continue
        _close_to_scale(g.numpy(), jgrads[name].numpy(), name)
        checked[next(k for k in checked if name.startswith(k))] += 1
    assert all(checked.values()), checked
    assert checked["roi_head.shared_head"] == 3 * 9 + 3   # 3 blocks + proj


def test_frozen_parameters_get_no_gradient(step_run):
    """The stem and stage 1: no gradient in the port, where JAX's is 0."""
    grads, jgrads = step_run["grads"], step_run["jax_grads"]
    frozen = [n for n in grads if frozen_param(n, 1)]
    assert frozen and all(n.startswith(("backbone.conv1", "backbone.bn1",
                                        "backbone.layer1.")) for n in frozen)
    for name in frozen:
        assert grads[name] is None, name
        assert not np.any(jgrads[name].numpy()), name
    others = [n for n in grads if not frozen_param(n, 1)]
    assert all(grads[n] is not None for n in others)


def test_parameters_after_sgd_step_match_jax(step_run):
    """Each tensor's update (lr 0.02, no warm-up) as its gradient is held;
    frozen parameters unchanged; BN statistics unchanged (norm_eval)."""
    new, jnew, before = step_run["new"], step_run["jax_new"], \
        step_run["before"]
    for name, v in new.items():
        if name.endswith("num_batches_tracked"):
            continue
        upd = (v - before[name]).numpy()
        jupd = jnew[name].numpy() - before[name].numpy()
        if frozen_param(name, 1) or "running_" in name:
            assert not upd.any() and not jupd.any(), name
            continue
        _close_to_scale(upd, jupd, name)
    assert step_run["state"].step == 1


def test_trainer_from_c4_config_dispatches_to_c4_loss():
    """The C4 config as it stands: its model, the CE loss, ``train_cfg``
    with ``rpn_nms_pre=2000`` / ``rpn_max_per_img=2000`` and 512 RoIs,
    SGD lr 0.02 with 500 warm-up steps, stage 1 frozen; the step is
    ``c4_loss``. A model of no ported family raises."""
    cfg = Config.fromfile(C4_CONFIG)
    trainer = trainer_from_config(cfg, DetCrossEntropyLoss(80), 100,
                                  device="cpu")
    assert isinstance(trainer.model, C4FasterRCNN)
    assert trainer.loss_fn is c4_loss
    assert trainer.model.backbone.compute_dtype == torch.bfloat16
    tc = trainer.train_cfg
    assert (tc.rpn_nms_pre, tc.rpn_max_per_img, tc.rcnn_num_samples) == (
        2000, 2000, 512)
    state = trainer.init_state()
    group = state.optimizer.param_groups[0]
    assert group["momentum"] == 0.9 and group["weight_decay"] == 1e-4
    assert trainer.lr_schedule(500) == pytest.approx(0.02)
    assert trainer.lr_schedule(0) == pytest.approx(0.02 / 1000)
    names = {n for n, p in trainer.model.named_parameters()
             if p.requires_grad}
    assert "backbone.layer1.0.conv1.weight" not in names
    assert "backbone.layer2.0.conv1.weight" in names
    assert "roi_head.shared_head.layer4.0.conv1.weight" in names
    with pytest.raises(NotImplementedError):
        DetectionTrainer(torch.nn.Linear(2, 2), DetCrossEntropyLoss(),
                         lambda s: 0.0, device="cpu")
    assert DetectionTrainer(MaskRCNN(num_classes=3), DetCrossEntropyLoss(),
                            lambda s: 0.0, device="cpu").loss_fn \
        is not c4_loss


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("weighted", [True, False])
def test_det_cross_entropy_matches_jax(reduction, weighted):
    """``DetCrossEntropyLoss.__call__`` (softmax CE in f32 from bf16
    logits too, label weights, ``avg_factor``, ``loss_weight``) within
    rtol 1e-6 of JAX's (``use_sigmoid``: ``tests/test_torch_activations.
    py``)."""
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE

    rng = np.random.RandomState(3 + weighted)
    logits = (rng.randn(40, 81) * 3).astype(np.float32)
    labels = rng.randint(0, 81, 40)
    w = (rng.rand(40) < 0.8).astype(np.float32) if weighted else None
    kw = {} if w is None else {"avg_factor": float(w.sum()) + 3.0}
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = DetCrossEntropyLoss(80, loss_weight=0.5)(
            torch.from_numpy(logits).to(dt), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w),
            reduction=reduction, **kw)
        want = JaxCE(80, loss_weight=0.5)(
            jnp.asarray(logits).astype(jdt), jnp.asarray(labels),
            None if w is None else jnp.asarray(w), reduction=reduction,
            **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_res_layer_trains_only_with_norm_eval():
    """res5 per RoI in training: with ``norm_eval`` its BN statistics stay
    put while gradients reach the BN affine parameters; without it (BN
    batch statistics, not ported) it raises."""
    from iif_torch.models.resnet import ResLayer

    x = torch.randn(2, 1024, 14, 14, generator=torch.Generator()
                    .manual_seed(0))
    layer = ResLayer(1, norm_eval=True).train()
    mean = layer.layer4[0].bn1.running_mean.clone()
    layer(x).sum().backward()
    assert torch.equal(layer.layer4[0].bn1.running_mean, mean)
    assert layer.layer4[0].bn1.weight.grad is not None
    with pytest.raises(NotImplementedError):
        ResLayer(1, norm_eval=False).train()(x)
