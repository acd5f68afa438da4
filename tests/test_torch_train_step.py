"""One whole training step of the port against the JAX package: f32,
depth 50, a 64x96 canvas, B=2, 7 classes, masks at stride 2, the same
weights (one torch-named state_dict, into JAX through its converter) and
the same sampling noise (JAX's draw under the step's key, rebuilt by
``jax_loss_noise``).

JAX: ``jax.value_and_grad(maskrcnn_loss)`` under ``fold_in(PRNGKey(seed),
step)``, then ``build_optimizer`` with ``frozen_backbone_mask``. Port:
``DetectionTrainer.train_step``. Compared: the five losses, every
parameter's gradient (JAX's mapped onto torch names through
``maskrcnn_state_from_jax``), the frozen parameters, the parameters after
the SGD step, and the LR schedule."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iif_torch.detection import detector as td
from iif_torch.detection.convert import maskrcnn_state_from_jax
from iif_torch.detection.losses import DetIIFLoss
from iif_torch.engine.detection import DetectionTrainer, frozen_param
from iif_torch.engine.schedules import build_lr_schedule, build_optimizer
from tests.test_torch_convert import jax_variables, random_mmdet_state
from tests.test_torch_train_targets import jax_loss_noise, make_gt

torch.set_num_threads(1)

NUM_CLASSES = 7
CANVAS = (64, 96)
B, G, STRIDE = 2, 6, 2
SEED, STEP = 5, 0
LR = 0.02
# 32 RoIs an image, 8 of them for the mask head: its four 256-wide 3x3
# convs are most of the step's CPU time
CFG = dict(rpn_nms_pre=2000, rpn_max_per_img=100, rcnn_num_samples=32,
           num_mask_rois=8, mask_gt_stride=STRIDE)
LOSS_KEYS = {"loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox",
             "loss_mask"}
# Gradients and updates, per tensor, against its largest JAX magnitude:
# the largest error within GRAD_REL, the median within GRAD_MEDIAN_REL.
# The two f32 trunks sum their convolutions in another order (proposals
# drift by up to 1.7e-4 px over 50 layers, tests/test_torch_slice.py).
# Where that drift moves a pre-activation across 0, a ReLU lets its
# gradient through on one side only, which shifts one output channel's
# row of a conv's weight gradient: measured 1.25e-3 at most (the mask
# head's convs); a tensor's median element is off by 4.9e-5 at most (the
# mask head's 256 biases) and by 7e-8 in the median tensor.
GRAD_REL = 5e-3
GRAD_MEDIAN_REL = 2e-4


def _close_to_scale(got, want, name):
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want)
    assert err.max() <= GRAD_REL * scale, (name, err.max(), scale)
    assert np.median(err) <= GRAD_MEDIAN_REL * scale, (name, scale)


def _batch(rng):
    gtb, gtl, gtv = make_gt(rng, B, G, NUM_CLASSES, CANVAS)
    h, w = CANVAS[0] // STRIDE, CANVAS[1] // STRIDE
    coarse = rng.rand(B, G, h // 4 + 1, w // 4 + 1)
    masks = (np.kron(coarse, np.ones((4, 4)))[:, :, :h, :w] > 0.5)
    return {"image": rng.randint(0, 256, (B,) + CANVAS + (3,)).astype(
                np.uint8),
            "gt_boxes": gtb, "gt_labels": gtl, "gt_valid": gtv,
            "gt_masks_packed": np.packbits(masks.astype(np.uint8), axis=-1)}


@pytest.fixture(scope="module")
def step_run():
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF
    from iif_tpu.engine.detection import frozen_backbone_mask
    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule
    from iif_tpu.engine.schedules import build_optimizer as jax_optimizer

    rng = np.random.RandomState(0)
    model = td.MaskRCNN(num_classes=NUM_CLASSES, depth=50)
    state = random_mmdet_state(model, rng)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    variables = jax_variables(state)
    weights = np.linspace(0.5, 3.0, NUM_CLASSES + 1).astype(np.float32)
    batch = _batch(rng)

    # JAX: the grad_accum=1 branch of DetectionTrainer._train_step_impl
    jmodel = jd.MaskRCNN(num_classes=NUM_CLASSES, depth=50)
    jcfg = jd.DetTrainCfg(roi_ext="ml", **CFG)
    jloss = JaxIIF(weights=jnp.asarray(weights))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), STEP)

    def loss_fn(params):
        total, losses, _ = jd.maskrcnn_loss(
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
    shapes = td.fpn_shapes(CANVAS)
    n_anchors = sum(h * w * 3 for h, w in shapes)
    noise = jax_loss_noise(key, B, n_anchors, G + CFG["rpn_max_per_img"])
    trainer = DetectionTrainer(
        model, DetIIFLoss(weights),
        build_lr_schedule(LR, 100, warmup_iters=0),
        td.DetTrainCfg(**CFG), {"type": "sgd", "momentum": 0.9,
                                "weight_decay": 1e-4},
        seed=SEED, device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tstate = trainer.init_state()
    tstate, metrics = trainer.train_step(tstate, batch, noise=noise)
    return {
        "jax_losses": {k: float(v) for k, v in jlosses.items()},
        "jax_total": float(jtotal),
        "jax_grads": maskrcnn_state_from_jax(jgrads, zero_stats),
        "jax_new": maskrcnn_state_from_jax(jnew, variables["batch_stats"]),
        "metrics": {k: v.item() for k, v in metrics.items()},
        "grads": {n: p.grad for n, p in model.named_parameters()},
        "new": {k: v.detach() for k, v in model.state_dict().items()},
        "before": before, "state": tstate,
    }


def test_step_losses_match_jax(step_run):
    """rtol 1e-4 (conv summation order)."""
    m, jl = step_run["metrics"], step_run["jax_losses"]
    assert set(jl) == LOSS_KEYS and set(m) == LOSS_KEYS | {"loss"}
    for k in LOSS_KEYS:
        assert np.isfinite(m[k]) and m[k] > 0, k
        np.testing.assert_allclose(m[k], jl[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(m["loss"], step_run["jax_total"], rtol=1e-4)


def test_step_gradients_match_jax(step_run):
    grads, jgrads = step_run["grads"], step_run["jax_grads"]
    checked = 0
    for name, g in grads.items():
        if g is None:
            continue
        _close_to_scale(g.numpy(), jgrads[name].numpy(), name)
        checked += 1
    assert checked > 100


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


def test_optimizer_matches_optax_on_the_same_gradients():
    """Two SGD steps of ``build_optimizer`` and of the JAX package's
    chain on one set of gradients: momentum, coupled weight decay and the
    warm-up rate agree to f32 rounding; a frozen tensor stays put."""
    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule
    from iif_tpu.engine.schedules import build_optimizer as jax_optimizer

    rng = np.random.RandomState(9)
    names = ["backbone.layer1.0.conv1.weight", "neck.fpn_convs.0.conv.bias",
             "roi_head.bbox_head.fc_cls.weight"]
    vals = {n: rng.randn(5, 3).astype(np.float32) for n in names}
    grads = [{n: rng.randn(5, 3).astype(np.float32) for n in names}
             for _ in range(2)]
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()),
                                    requires_grad=not frozen_param(n, 1))
              for n, v in vals.items()}
    opt, sched = build_optimizer(
        "sgd", params.values(), build_lr_schedule(LR, 10, warmup_iters=4),
        0.9, 1e-4)
    tx = jax_optimizer("sgd", jax_schedule(LR, 10, 12, warmup_iters=4),
                       0.9, 1e-4, trainable_mask={
                           n: not frozen_param(n, 1) for n in names})
    jp = {n: jnp.asarray(v) for n, v in vals.items()}
    ostate = tx.init(jp)
    for g in grads:
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        sched.step()
        upd, ostate = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                ostate, jp)
        jp = optax.apply_updates(jp, upd)
    for n in names:
        np.testing.assert_allclose(params[n].detach().numpy(),
                                   np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(params[names[0]].detach().numpy(),
                                  vals[names[0]])


@pytest.mark.parametrize("steps_per_epoch", [100, 37])
def test_lr_schedule_matches_jax(steps_per_epoch):
    """Warm-up (500 iterations from 1/1000) and step decay at epochs 8
    and 11, rtol 1e-6."""
    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule

    kw = dict(milestones=[8, 11], lr_gamma=0.1, warmup_iters=500,
              warmup_factor=1.0 / 1000)
    got = build_lr_schedule(LR, steps_per_epoch, **kw)
    want = jax_schedule(LR, steps_per_epoch, 12, **kw)
    m1, m2 = 8 * steps_per_epoch, 11 * steps_per_epoch
    for step in (0, 1, 250, 499, 500, 501, m1 - 1, m1, m2 - 1, m2,
                 12 * steps_per_epoch):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))
    assert got(0) == pytest.approx(LR / 1000)
    assert got(max(m2, 500)) == pytest.approx(LR * 0.01)
