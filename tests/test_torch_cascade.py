"""Cascade Mask R-CNN and the cosine-normed heads against the JAX package,
on the CPU: one seeded ``iif_tpu`` ``CascadeMaskRCNN`` as the FASA
cascade config sets it (normed classifier at temperature 8, normed mask
predictor at 20, class-specific regressors, stage stds with the 0.33
third stage) at depth 14 ((1, 1, 1, 1) bottlenecks, through
``_DEPTH_LAYERS`` of both packages), 8 classes, f32, every parameter and
BN statistic randomised (the normed classifiers' kernels from U(0, 2), as
their init draws them), carried into the port by
``cascade_state_from_jax``. Held against JAX:

- ``NormedConv2d``, the normed ``FCNMaskHead`` (full logits and
  ``logits_for_labels``) and the normed, class-specific
  ``Shared2FCBBoxHead`` with ``cls_only``, each within 1e-5 of the
  tensor's largest magnitude (measured at most 2.3e-6, ``NormedConv2d``
  alone 2.8e-7);
- the whole ``cascade_simple_test`` on a 64x96 canvas, B=2, with the IIF
  loss's activation: boxes, scores and masks within 1e-4 of their
  largest magnitude (two f32 trunks sum their convolutions in another
  order; measured at most 6.8e-6), labels and ``valid`` equal;
- the depth-101 cascade's parameter names and shapes after
  ``cascade_state_from_jax`` against ``jax.eval_shape`` of its ``init``
  (no forward pass);
- the dispatch: ``build_detector`` and ``make_simple_test`` route the
  cascade, and ``init_detector`` + ``inference_detector`` serve the FASA
  cascade config (shrunk in depth and size) on the CPU.

JAX's program compiles at XLA's backend optimisation level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection import detector as td
from iif_torch.detection.cascade import CascadeMaskRCNN, cascade_simple_test
from iif_torch.detection.convert import cascade_state_from_jax
from iif_torch.detection.losses import DetIIFLoss
from iif_torch.detection.mask_head import FCNMaskHead, NormedConv2d
from iif_torch.detection.simple_test import make_simple_test
from tests.test_torch_c4 import _randomise

torch.set_num_threads(1)

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
NUM_CLASSES = 8
CANVAS = (64, 96)
DEPTH = 14                       # (1, 1, 1, 1) bottlenecks, for the test
CONFIG = "configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py"
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.33, 0.33, 0.067, 0.067))
MODEL = dict(num_classes=NUM_CLASSES, depth=DEPTH, cls_predictor="normed",
             mask_predictor="normed", reg_class_agnostic=False,
             stage_stds=STAGE_STDS)
TEST_CFG = dict(rpn_nms_pre=128, rpn_max_per_img=48, score_thr=1e-4,
                nms_iou=0.3, max_per_img=40)
IIF = np.linspace(0.8, 1.2, NUM_CLASSES + 1).astype(np.float32)


@pytest.fixture(scope="module")
def shallow():
    from iif_tpu.detection import detector as jd

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jd._DEPTH_LAYERS, DEPTH, ((1, 1, 1, 1), "bottleneck"))
        mp.setitem(td._DEPTH_LAYERS, DEPTH, (1, 1, 1, 1))
        yield


def random_cascade_variables(jmodel, rng):
    """Every leaf randomised (``_randomise``); the normed classifiers'
    kernels from U(0, 2), their init's family, so that the classes'
    columns differ once JAX subtracts 1."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, rng)
    for name, p in variables["params"].items():
        if name.startswith("bbox_head_"):
            p["fc_cls"]["kernel"] = rng.uniform(
                0.0, 2.0, p["fc_cls"]["kernel"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def models(shallow):
    from iif_tpu.detection.cascade import CascadeMaskRCNN as JaxCascade

    jmodel = JaxCascade(**MODEL)
    variables = random_cascade_variables(jmodel, np.random.RandomState(0))
    tmodel = CascadeMaskRCNN(**MODEL).eval()
    tmodel.load_state_dict(cascade_state_from_jax(variables["params"],
                                                  variables["batch_stats"]))
    return jmodel, variables, tmodel


def _close(got, want, rtol):
    """Within ``rtol`` of the largest magnitude."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale,
                               rtol=0)


def test_converter_names_every_port_tensor(models):
    """``load_state_dict`` above is strict; mmdet's cascade names, the
    normed kernels (in, out), the normed classifier less JAX's 1."""
    _, variables, tmodel = models
    sd = cascade_state_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(tmodel.state_dict())
    for i in range(3):
        w = sd[f"roi_head.bbox_head.{i}.fc_cls.weight"]
        assert w.shape == (1024, NUM_CLASSES + 1)
        np.testing.assert_array_equal(
            w.numpy(), variables["params"][f"bbox_head_{i}"]["fc_cls"]
            ["kernel"] - np.float32(1.0))
        assert f"roi_head.bbox_head.{i}.fc_cls.bias" not in sd
        assert sd[f"roi_head.bbox_head.{i}.fc_reg.weight"].shape == (
            4 * NUM_CLASSES, 1024)
        assert sd[f"roi_head.mask_head.{i}.conv_logits.weight"].shape == (
            256, NUM_CLASSES)
        assert f"roi_head.mask_head.{i}.convs.3.conv.weight" in sd


def test_normed_conv2d_matches_jax():
    from iif_tpu.detection.mask_head import NormedConv2d as JaxNormedConv

    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 5, 32).astype(np.float32)
    kernel = rng.randn(32, 6).astype(np.float32)
    conv = NormedConv2d(32, 6, temperature=20.0)
    conv.weight.data = torch.from_numpy(kernel)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    want = JaxNormedConv(6, temperature=20.0).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))
    _close(got, want, 1e-5)


def test_normed_heads_match_jax(models):
    """Each stage's bbox head (scores, class-specific deltas, embedding,
    ``cls_only``) and mask head (full logits, ``logits_for_labels``) on
    seeded RoI features."""
    from iif_tpu.detection.cascade import CascadeMaskRCNN as JaxCascade

    jmodel, variables, tmodel = models
    rng = np.random.RandomState(2)
    x7 = rng.randn(6, 7, 7, 256).astype(np.float32)
    x14 = rng.randn(4, 14, 14, 256).astype(np.float32)
    labels = np.array([0, 7, 3, 3])
    emb = np.abs(rng.randn(9, 1024)).astype(np.float32)
    for stage in range(3):
        bbox = tmodel.roi_head.bbox_head[stage]
        mask = tmodel.roi_head.mask_head[stage]
        assert isinstance(mask, FCNMaskHead) and mask.predictor == "normed"
        with torch.no_grad():
            got = bbox(torch.from_numpy(x7)) + (
                bbox.cls_only(torch.from_numpy(emb)),
                mask(torch.from_numpy(x14)),
                mask.logits_for_labels(torch.from_numpy(x14),
                                       torch.from_numpy(labels)))
        want = jmodel.apply(variables, jnp.asarray(x7), stage,
                            method=JaxCascade.forward_bbox_stage) + (
            jmodel.apply(variables, jnp.asarray(emb), stage,
                         method=JaxCascade.forward_cls_only_stage),
            jmodel.apply(variables, jnp.asarray(x14), stage,
                         method=JaxCascade.forward_mask_stage),
            jmodel.apply(variables, jnp.asarray(x14), jnp.asarray(labels),
                         stage,
                         method=JaxCascade.forward_mask_for_labels_stage))
        assert got[0].shape == (6, NUM_CLASSES + 1)
        assert got[1].shape == (6, 4 * NUM_CLASSES)
        assert got[4].shape == (4, 28, 28, NUM_CLASSES)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-5)


def test_cascade_simple_test_matches_jax(models):
    from iif_tpu.detection.cascade import cascade_simple_test as jax_test
    from iif_tpu.detection.detector import DetTestCfg as JaxTestCfg
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    jmodel, variables, tmodel = models
    images = np.random.RandomState(3).randint(
        0, 256, (2,) + CANVAS + (3,)).astype(np.uint8)
    jloss = JaxIIF(jnp.asarray(IIF))
    jcfg = JaxTestCfg(**TEST_CFG)
    fn = jax.jit(lambda v, im: jax_test(jmodel, v, im, [jloss] * 3, jcfg))
    want = fn.lower(variables, jnp.asarray(images)).compile(
        compiler_options=FAST)(variables, jnp.asarray(images))
    got = cascade_simple_test(tmodel, torch.from_numpy(images),
                              DetIIFLoss(IIF), td.DetTestCfg(**TEST_CFG))
    valid = np.asarray(want["valid"])
    assert valid.sum() >= 16 and len(set(np.asarray(
        want["labels"])[valid].tolist())) >= 3
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    for key in ("boxes", "scores", "masks"):
        _close(got[key].numpy(), want[key], 1e-4)
    assert got["masks"].shape == (2, 40, 28, 28)


def test_depth_101_cascade_names_and_shapes_match_jax():
    """``CascadeMaskRCNN(depth=101)`` of the FASA config, at 1203 classes:
    the port's state_dict has exactly the names and shapes
    ``cascade_state_from_jax`` makes of JAX's ``init`` shapes."""
    from iif_tpu.detection.cascade import CascadeMaskRCNN as JaxCascade

    kw = dict(MODEL, depth=101, num_classes=1203)
    shapes = jax.eval_shape(lambda: JaxCascade(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = cascade_state_from_jax(zeros["params"], zeros["batch_stats"])
    with torch.device("meta"):               # shapes, no storage
        port = {k: tuple(v.shape) for k, v in
                CascadeMaskRCNN(**kw).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == port
    assert len([k for k in port if k.startswith("backbone.layer3.")
                and k.endswith("conv1.weight")]) == 23
    assert port["roi_head.bbox_head.2.fc_reg.weight"] == (4812, 1024)


def test_build_detector_and_dispatch():
    cfg = Config.fromfile(CONFIG)
    with torch.device("meta"):
        model = td.build_detector(dict(cfg.model))
    assert isinstance(model, CascadeMaskRCNN)
    assert model.stage_stds[2] == (0.33, 0.33, 0.067, 0.067)
    assert not model.reg_class_agnostic and model.num_classes == 1203
    assert model.backbone.compute_dtype == torch.bfloat16
    assert make_simple_test(model, DetIIFLoss(np.ones(1204)),
                            td.DetTestCfg()).func is cascade_simple_test
    with torch.device("meta"):
        assert isinstance(td.build_detector({"type": "CascadeRCNN",
                                             "num_classes": 3}),
                          CascadeMaskRCNN)
    with pytest.raises(NotImplementedError, match="detectors"):
        td.build_detector({"type": "CascadeMaskRCNN",
                           "backbone_type": "detectors"})
    # the IIF-normed classifier needs the loss's IIF vector
    with pytest.raises(ValueError, match="IIF weights"):
        td.build_detector({"type": "CascadeMaskRCNN",
                           "cls_predictor": "iif_normed"})
    with torch.device("meta"):
        model = td.build_detector({"type": "CascadeMaskRCNN",
                                   "num_classes": 3,
                                   "cls_predictor": "iif_normed",
                                   "iif_weights": (1.0, 2.0, 0.5, 1.0)})
    assert all(type(h.fc_cls).__name__ == "IIFNormedLinear"
               for h in model.roi_head.bbox_head)


def test_init_detector_serves_the_fasa_cascade_config(shallow, tmp_path):
    """The flagship config as it stands but for depth, class count,
    canvas and proposal counts: ``init_detector`` (seeded random weights)
    and ``inference_detector`` on the CPU."""
    from iif_torch.detection.inference import (
        inference_detector,
        init_detector,
    )

    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options({
        "model.depth": DEPTH, "model.num_classes": NUM_CLASSES,
        "model.compute_dtype": None, "pipeline.canvas": CANVAS,
        "pipeline.scales": [(96, 64)],
        "test_cfg.rpn_nms_pre": 100, "test_cfg.rpn_max_per_img": 30,
        "test_cfg.max_per_img": 10,
        "data.test.ann_file": str(tmp_path / "missing.json")})
    det = init_detector(cfg, device="cpu")
    assert isinstance(det.model, CascadeMaskRCNN)
    image = np.random.RandomState(4).randint(0, 256, (50, 80, 3),
                                             dtype=np.uint8)
    out = inference_detector(det, image)
    assert out["boxes"].shape == (10, 4) and out["masks"].shape == (
        10, 50, 80)
    assert np.isfinite(out["scores"]).all() and out["valid"].any()
