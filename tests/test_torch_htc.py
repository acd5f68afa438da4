"""HTC (``iif_torch/detection/htc.py``) against the JAX package, on the
CPU: one seeded ``iif_tpu`` ``HTC`` at depth 14 ((1, 1, 1, 1)
bottlenecks, through ``_DEPTH_LAYERS`` of both packages), 8 classes, f32,
every parameter and BN statistic randomised, carried into the port by
``htc_state_from_jax``. Held against JAX:

- ``HTCMaskHead``: each stage's trunk with and without the previous
  stage's trunk as ``res_feat``, and the class-selected logits on a trunk,
  within 1e-5 of the tensor's largest magnitude;
- the whole ``htc_simple_test`` on a 64x96 canvas, B=1 (the cascade's
  test holds the shared box half at B=2), with the IIF loss's
  activation: boxes, scores and masks within 1e-4 of their largest
  magnitude, labels and ``valid`` equal;
- ``htc_loss`` on JAX's draws (its key chain rebuilt and handed to the
  port as ``noise``: the RPN's, each stage's RCNN sampling, each stage's
  mask re-sampling), B=2 with masks at stride 2 and two mask RoIs an
  image: each loss within 1e-5 relative, every gradient within 5e-3 of
  its tensor's largest JAX magnitude with the median within 2e-4;
- stage 0's ``conv_res``: JAX creates one and never calls it (its
  gradient is 0); the port, as mmdet, builds none.

Then the port alone: the dispatch (``build_detector``, ``make_simple_
test``, the trainer's loss, the refusals), a trainer step of the headline
HTC config shrunk, with gradient clipping, from ``fresh_init_``, and
``init_detector`` serving it. JAX's loss program compiles at XLA's
backend optimisation level 1, its test program at level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection import detector as td
from iif_torch.detection.convert import htc_state_from_jax
from iif_torch.detection.htc import HTC, htc_loss, htc_simple_test
from iif_torch.detection.losses import DetIIFLoss
from iif_torch.detection.mask_head import HTCMaskHead
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
    IIF,
    LOSS_REL,
    OPT,
    _batch,
    _n_anchors,
)
from tests.test_torch_train_targets import jax_sampler_noise

torch.set_num_threads(1)

CONFIG = "configs/activations/iif/iif_htc_r101_4x4_1x.py"
MODEL = dict(num_classes=NUM_CLASSES, depth=DEPTH)
TEST_CFG = dict(rpn_nms_pre=128, rpn_max_per_img=48, score_thr=1e-4,
                nms_iou=0.5, max_per_img=40)
G = 6                        # gt slots an image of ``_batch``


def _close(got, want, rtol):
    """Within ``rtol`` of the largest magnitude."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale,
                               rtol=0)


@pytest.fixture(scope="module")
def models(shallow):
    from iif_tpu.detection.htc import HTC as JaxHTC

    jmodel = JaxHTC(**MODEL)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    # seed 4: under seed 0 one stage-1 RoI (a refined gt box, so under
    # every sampling key) had a shared-FC pre-activation of 9.2e-7, a
    # ReLU tie whose side f32 sum order picks: that unit's gradient moved
    # by 14%, the backbone's by 0.7% of scale through that RoI, all else
    # by 1e-8. Seed 4's smallest pre-activation is 1.9e-5.
    variables = _randomise(shapes, np.random.RandomState(4))
    with torch.device("meta"):              # no default init to overwrite
        tmodel = HTC(**MODEL)
    tmodel.load_state_dict(htc_state_from_jax(variables["params"],
                                              variables["batch_stats"]),
                           assign=True)
    return jmodel, variables, tmodel.eval()


def test_converter_names_every_port_tensor(models):
    """The strict ``load_state_dict`` above: mmdet's HTC names, a
    ``conv_res`` on stages 1 and 2 only."""
    _, variables, tmodel = models
    sd = htc_state_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(tmodel.state_dict())
    assert "conv_res" in variables["params"]["htc_mask_head_0"]
    assert tmodel.roi_head.mask_head[0].conv_res is None
    for i in (1, 2):
        assert sd[f"roi_head.mask_head.{i}.conv_res.conv.weight"].shape == (
            256, 256, 1, 1)
    assert not any(k.startswith("roi_head.mask_head.0.conv_res") for k in sd)


def test_htc_mask_head_matches_jax(models):
    """Each stage's trunk on seeded RoI features, without and (stages 1,
    2) with a previous trunk as ``res_feat``; the class-selected logits
    on the trunk."""
    from iif_tpu.detection.htc import HTC as JaxHTC

    jmodel, variables, tmodel = models
    rng = np.random.RandomState(2)
    x = rng.randn(4, 14, 14, 256).astype(np.float32)
    res = np.abs(rng.randn(4, 14, 14, 256)).astype(np.float32)
    labels = np.array([0, 7, 3, 3])
    for stage in range(3):
        head = tmodel.roi_head.mask_head[stage]
        assert isinstance(head, HTCMaskHead)
        for with_res in ((False, True) if stage else (False,)):
            r = jnp.asarray(res) if with_res else None
            with torch.no_grad():
                trunk = head.trunk(torch.from_numpy(x), torch.from_numpy(
                    res).permute(0, 3, 1, 2) if with_res else None)
                logits = head.logits_for_labels_from_trunk(
                    trunk, torch.from_numpy(labels))
            jtrunk = jmodel.apply(variables, jnp.asarray(x), stage, r,
                                  method=JaxHTC.forward_mask_trunk)
            jlogits = jmodel.apply(variables, jtrunk, jnp.asarray(labels),
                                   stage, method=JaxHTC.forward_mask_logits)
            assert logits.shape == (4, 28, 28)
            _close(trunk.permute(0, 2, 3, 1).numpy(), jtrunk, 1e-5)
            _close(logits.numpy(), jlogits, 1e-5)


def test_htc_simple_test_matches_jax(models):
    from iif_tpu.detection.detector import DetTestCfg as JaxTestCfg
    from iif_tpu.detection.htc import htc_simple_test as jax_test
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    jmodel, variables, tmodel = models
    images = np.random.RandomState(3).randint(
        0, 256, (1,) + CANVAS + (3,)).astype(np.uint8)
    jloss = JaxIIF(jnp.asarray(IIF))
    jcfg = JaxTestCfg(**TEST_CFG)
    fn = jax.jit(lambda v, im: jax_test(jmodel, v, im, [jloss] * 3, jcfg))
    want = fn.lower(variables, jnp.asarray(images)).compile(
        compiler_options=FAST)(variables, jnp.asarray(images))
    got = htc_simple_test(tmodel, torch.from_numpy(images), DetIIFLoss(IIF),
                          td.DetTestCfg(**TEST_CFG))
    valid = np.asarray(want["valid"])
    assert valid.sum() >= 16 and len(set(np.asarray(
        want["labels"])[valid].tolist())) >= 3
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    for key in ("boxes", "scores", "masks"):
        _close(got[key].numpy(), want[key], 1e-4)
    assert got["masks"].shape == (1, 40, 28, 28)


def jax_htc_noise(key, b, n_anchors, n_cand, r):
    """Every draw of ``iif_tpu``'s ``htc_loss`` under ``key``
    (``htc.py:182``: ``split(key, 7)``: the RPN's, each stage's RCNN
    sampling, each stage's mask re-sampling)."""
    keys = jax.random.split(key, 7)
    return {"rpn": jax_sampler_noise(keys[0], b, n_anchors),
            "rcnn": [jax_sampler_noise(keys[1], b, n_cand)] + [
                jax_sampler_noise(keys[s], b, r) for s in (2, 3)],
            "mask": [jax_sampler_noise(keys[4 + s], b, r)
                     for s in range(3)]}


@pytest.fixture(scope="module")
def loss_runs(models):
    """JAX's ``htc_loss`` value and gradient, and the port's on the same
    batch and draws."""
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.htc import htc_loss as jax_htc_loss
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    jmodel, variables, tmodel = models
    batch = _batch(np.random.RandomState(1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = jd.DetTrainCfg(roi_ext="ml", **CFG)
    jloss = JaxIIF(jnp.asarray(IIF))
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        total, losses, _ = jax_htc_loss(
            jmodel, {"params": p, "batch_stats": variables["batch_stats"]},
            jbatch, key, (jloss,) * 3, jcfg)
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True)).lower(variables["params"]).compile(
            compiler_options=OPT)(variables["params"])
    want = {"losses": {k: float(v) for k, v in losses.items()},
            "total": float(total), "jax_grads": grads,
            "grads": htc_state_from_jax(
                grads, jax.tree_util.tree_map(np.zeros_like,
                                              variables["batch_stats"]),
                gradients=True)}

    tmodel.train()                       # norm_eval: BN keeps its statistics
    tmodel.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    noise = jax_htc_noise(key, B, _n_anchors(), G + CFG["rpn_max_per_img"],
                          CFG["rcnn_num_samples"])
    total, losses, aux = htc_loss(tmodel, tb, DetIIFLoss(IIF),
                                  td.DetTrainCfg(**CFG), noise=noise)
    total.backward()
    got = {"losses": {k: v.item() for k, v in losses.items()},
           "total": total.item(), "aux": aux,
           "grads": {n: p.grad for n, p in tmodel.named_parameters()}}
    tmodel.eval()
    return got, want


def test_htc_loss_matches_jax(loss_runs):
    got, want = loss_runs
    assert set(got["losses"]) == set(want["losses"]) == {
        "loss_rpn_cls", "loss_rpn_bbox"} | {
        f"s{s}.loss_{k}" for s in range(3) for k in ("cls", "bbox", "mask")}
    assert got["aux"] == {}
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]) and v > 0, k
        np.testing.assert_allclose(got["losses"][k], v, rtol=LOSS_REL,
                                   err_msg=k)
    np.testing.assert_allclose(got["total"], want["total"], rtol=LOSS_REL)


def test_htc_gradients_match_jax(loss_runs):
    """Every gradient, the information flow's ``conv_res`` of stages 1
    and 2 among them; stage 0's JAX ``conv_res`` gets none."""
    got, want = loss_runs
    checked = 0
    for name, g in got["grads"].items():
        w = want["grads"][name].numpy()
        if g is None:
            assert not np.any(w), name
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        err = np.abs(g.numpy() - w)
        assert err.max() <= GRAD_REL * scale, (name, err.max(), scale)
        assert np.median(err) <= GRAD_MEDIAN_REL * scale, (name, scale)
        checked += 1
    assert checked > 50
    for i in (1, 2):
        assert got["grads"][
            f"roi_head.mask_head.{i}.conv_res.conv.weight"].abs().max() > 0
    assert not np.any(np.asarray(
        want["jax_grads"]["htc_mask_head_0"]["conv_res"]["kernel"]))


def test_build_detector_and_dispatch():
    from iif_torch.detection.simple_test import make_simple_test
    from iif_torch.engine.detection import DetectionTrainer

    cfg = Config.fromfile(CONFIG)
    with torch.device("meta"):
        model = td.build_detector(dict(cfg.model))
        alias = td.build_detector({"type": "HybridTaskCascade",
                                   "num_classes": 3, "depth": 50})
    assert isinstance(model, HTC) and isinstance(alias, HTC)
    assert model.num_classes == 1203 and len(model.backbone.layer3) == 23
    assert model.backbone.compute_dtype == torch.bfloat16
    assert model.reg_class_agnostic
    assert make_simple_test(model, DetIIFLoss(np.ones(1204)),
                            td.DetTestCfg()).func is htc_simple_test
    small = HTC(num_classes=3, depth=50)
    assert DetectionTrainer(small, DetIIFLoss(np.ones(4)), lambda s: 0.0,
                            device="cpu").loss_fn is htc_loss
    with pytest.raises(NotImplementedError, match="FASA"):
        DetectionTrainer(small, DetIIFLoss(np.ones(4)), lambda s: 0.0,
                         device="cpu", fasa_cfg={"decay_ratio": 0.1})
    with pytest.raises(NotImplementedError, match="with_semantic"):
        td.build_detector({"type": "HTC", "with_semantic": True})
    with pytest.raises(NotImplementedError, match="normed"):
        td.build_detector({"type": "HTC", "mask_predictor": "normed"})


def _shrunk(cfg):
    cfg.merge_from_options({
        "model.depth": DEPTH, "model.num_classes": NUM_CLASSES,
        "model.compute_dtype": None, "pipeline.canvas": CANVAS,
        "pipeline.scales": [(96, 64)],
        **{f"train_cfg.{k}": v for k, v in CFG.items()},
        "test_cfg.rpn_nms_pre": 100, "test_cfg.rpn_max_per_img": 30,
        "test_cfg.max_per_img": 10})
    return cfg


def test_trainer_steps_the_htc_config_with_clipping(shallow):
    """``trainer_from_config`` on the headline HTC config (shrunk; every
    tensor from ``fresh_init_``, ``conv_res`` too): a step with
    ``grad_clip`` 35 moves the flow's ``conv_res``."""
    from iif_torch.engine.detection import trainer_from_config

    cfg = _shrunk(Config.fromfile(CONFIG))
    trainer = trainer_from_config(cfg, DetIIFLoss(IIF), 10, device="cpu")
    assert trainer.grad_clip == 35 and trainer.loss_fn is htc_loss
    m = trainer.model
    before = {k: v.clone() for k, v in m.state_dict().items()
              if "mask_head" in k}
    state, metrics = trainer.train_step(trainer.init_state(),
                                        _batch(np.random.RandomState(6)))
    assert np.isfinite(metrics["loss"].item())
    assert metrics["grad_norm"].item() > 0 and state.step == 1
    assert {f"s{s}.loss_mask" for s in range(3)} <= set(metrics)
    for i in (1, 2):
        k = f"roi_head.mask_head.{i}.conv_res.conv.weight"
        assert not torch.equal(m.state_dict()[k], before[k]), k


def test_init_detector_serves_the_htc_config(shallow, tmp_path):
    """The headline HTC config as it stands but for depth, class count,
    canvas and proposal counts: ``init_detector`` (seeded random weights)
    and ``inference_detector`` on the CPU."""
    from iif_torch.detection.inference import (
        inference_detector,
        init_detector,
    )

    cfg = _shrunk(Config.fromfile(CONFIG))
    cfg.merge_from_options({"data.test.ann_file": str(tmp_path / "no.json")})
    det = init_detector(cfg, device="cpu")
    assert isinstance(det.model, HTC)
    image = np.random.RandomState(4).randint(0, 256, (50, 80, 3),
                                             dtype=np.uint8)
    out = inference_detector(det, image)
    assert out["boxes"].shape == (10, 4) and out["masks"].shape == (
        10, 50, 80)
    assert np.isfinite(out["scores"]).all() and out["valid"].any()
