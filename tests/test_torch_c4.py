"""Faster R-CNN R50-C4 against the JAX package: one seeded ``iif_tpu``
``C4FasterRCNN(depth=50)`` with every parameter and BN statistic
randomised (the residual ``bn3`` scale, zero at JAX's init, too), carried
into the port by ``c4_state_from_jax``. Held against JAX: the C4 trunk
(``ResNet(num_stages=3)``), res5 per RoI (``ResLayer``), ``C4BBoxHead``,
the anchors, and the whole ``c4_simple_test`` on a 64x96 canvas in f32;
then the dispatch and ``init_detector`` + ``inference_detector`` on the
CPU with the C4 config shrunk in size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection.c4 import (
    C4FasterRCNN,
    c4_anchor_generator,
    c4_simple_test,
)
from iif_torch.detection.convert import c4_state_from_jax
from iif_torch.detection.detector import (
    DetTestCfg,
    MaskRCNN,
    build_detector,
    maskrcnn_simple_test,
)
from iif_torch.detection.losses import DetCrossEntropyLoss
from iif_torch.detection.simple_test import make_simple_test

torch.set_num_threads(1)

NUM_CLASSES = 3
CANVAS = (64, 96)
CFG = dict(rpn_nms_pre=128, rpn_max_per_img=64, score_thr=0.0, nms_iou=0.5,
           max_per_img=16)
C4_CONFIG = "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py"


def _randomise(tree, rng, path=()):
    """Seeded values for every leaf of a flax variable tree: conv and
    dense kernels normal(0, 1/sqrt(fan_in)), biases normal(0, 0.01); BN
    scale in [0.5, 1] ([0.1, 0.3] for bn3), BN bias and mean normal(0,
    0.1), variance in [0.5, 1.5]."""
    if hasattr(tree, "items"):
        return {k: _randomise(v, rng, path + (k,)) for k, v in tree.items()}
    shape, leaf = tuple(tree.shape), path[-1]
    is_bn = path[-2].startswith("bn") or path[-2] == "downsample_bn"
    if leaf == "kernel":
        v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
    elif leaf == "scale":
        lo, hi = (0.1, 0.3) if path[-2] == "bn3" else (0.5, 1.0)
        v = rng.uniform(lo, hi, shape)
    elif leaf == "var":
        v = rng.uniform(0.5, 1.5, shape)
    elif leaf == "mean" or (leaf == "bias" and is_bn):
        v = rng.normal(0.0, 0.1, shape)
    else:                                   # conv / dense bias
        v = rng.normal(0.0, 0.01, shape)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    from iif_tpu.detection.c4 import C4FasterRCNN as JaxC4

    jmodel = JaxC4(num_classes=NUM_CLASSES, depth=50)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, np.random.RandomState(0))
    tmodel = C4FasterRCNN(num_classes=NUM_CLASSES, depth=50).eval()
    tmodel.load_state_dict(c4_state_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return jmodel, variables, tmodel


def _close(got, want, rtol):
    """Within ``rtol`` of the largest magnitude: two f32 trunks sum their
    convolutions in another order."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def test_converter_names_every_port_tensor(models):
    """``load_state_dict`` above is strict; the names are mmdet's."""
    _, variables, tmodel = models
    sd = c4_state_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(tmodel.state_dict())
    for name in ("backbone.layer3.0.conv1.weight",
                 "backbone.layer3.0.downsample.0.weight",
                 "rpn_head.rpn_conv.weight", "rpn_head.rpn_cls.bias",
                 "rpn_head.rpn_reg.weight",
                 "roi_head.shared_head.layer4.0.downsample.1.running_var",
                 "roi_head.shared_head.layer4.2.bn3.weight",
                 "roi_head.bbox_head.fc_cls.weight",
                 "roi_head.bbox_head.fc_reg.bias"):
        assert name in sd, name
    assert not any(k.startswith("backbone.layer4") for k in sd)
    assert sd["roi_head.bbox_head.fc_cls.weight"].shape == (
        NUM_CLASSES + 1, 2048)
    assert sd["roi_head.bbox_head.fc_reg.weight"].shape == (
        4 * NUM_CLASSES, 2048)
    assert sd["rpn_head.rpn_cls.weight"].shape == (15, 1024, 1, 1)


def test_res_layer_and_bbox_head_match_jax(models):
    """res5 per RoI (14x14 -> 7x7x2048) and the mean-pool + fc head on
    seeded RoI features, each within 1e-5 of its largest value (measured
    1.2e-6 for res5, 7.1e-7 for the logits); the head alone on JAX's res5
    output within 1e-6 (measured 7.1e-7)."""
    jmodel, variables, tmodel = models
    x = np.random.RandomState(2).randn(5, 14, 14, 1024).astype(np.float32)

    def jax_fn(v, x):
        shared = jmodel.apply(v, x, method="forward_shared")
        return (shared,) + tuple(jmodel.apply(v, shared,
                                              method="forward_bbox"))

    j_shared, j_cls, j_reg, j_e = map(np.array, jax.jit(jax_fn)(
        variables, jnp.asarray(x)))
    with torch.inference_mode():
        shared = tmodel.forward_shared(torch.from_numpy(x))
        cls, reg, e = tmodel.forward_bbox(shared)
    assert shared.shape == (5, 2048, 7, 7)
    _close(shared.permute(0, 2, 3, 1).numpy(), j_shared, 1e-5)
    _close(e.numpy(), j_e, 1e-5)
    assert cls.shape == (5, NUM_CLASSES + 1)
    assert reg.shape == (5, 4 * NUM_CLASSES)
    _close(cls.numpy(), j_cls, 1e-5)
    _close(reg.numpy(), j_reg, 1e-5)
    # the same head on the shared features JAX computed: the head alone
    with torch.inference_mode():
        cls2, reg2, _ = tmodel.forward_bbox(
            torch.from_numpy(j_shared).permute(0, 3, 1, 2))
    _close(cls2.numpy(), j_cls, 1e-6)
    _close(reg2.numpy(), j_reg, 1e-6)


def test_anchors_match_jax():
    from iif_tpu.detection.c4 import c4_anchor_generator as jax_gen

    got = c4_anchor_generator().grid_anchors([(50, 84)])[0]
    want = jax_gen().grid_anchors([(50, 84)])[0]
    assert got.shape == (50 * 84 * 15, 4)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def c4_run(models):
    """``c4_simple_test`` of both packages on one 64x96 batch of 2 uint8
    canvases, with the C4 map and the proposals beside it (one JAX
    compile for all three)."""
    from iif_tpu.detection import c4 as jc4
    from iif_tpu.detection.detector import DetTestCfg as JaxDetTestCfg
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE
    from iif_tpu.detection.rpn import rpn_proposals as jax_rpn_proposals

    jmodel, variables, tmodel = models
    images = np.random.RandomState(3).randint(0, 256, (2,) + CANVAS + (3,))
    images = images.astype(np.uint8)
    jcfg = JaxDetTestCfg(**CFG)
    jloss = JaxCE(NUM_CLASSES)

    def jax_fn(v, img):
        feat = jmodel.apply(v, img, False, method="extract_feat")
        cls, reg = jmodel.apply(v, feat, method=jc4.C4FasterRCNN.forward_rpn)
        anchors = jc4.c4_anchor_generator().grid_anchors(
            [(feat.shape[1], feat.shape[2])])
        props, _, pvalid = jax_rpn_proposals(
            cls, reg, [jnp.asarray(anchors[0])], CANVAS,
            nms_pre=jcfg.rpn_nms_pre, max_per_img=jcfg.rpn_max_per_img,
            nms_iou=jcfg.rpn_nms_iou)
        return (feat, props, pvalid,
                jc4.c4_simple_test(jmodel, v, img, jloss, jcfg))

    jfeat, jprops, jvalid, jout = jax.jit(jax_fn)(variables,
                                                  jnp.asarray(images))

    timg = torch.from_numpy(images)
    tcfg = DetTestCfg(**CFG)
    from iif_torch.detection.rpn import rpn_proposals

    with torch.inference_mode():
        feat = tmodel.extract_feat(timg)
        cls, reg = tmodel.forward_rpn(feat)
        tprops, _, tvalid = rpn_proposals(
            cls, reg, tmodel.anchors(feat.shape[2:], "cpu"), CANVAS,
            nms_pre=tcfg.rpn_nms_pre, max_per_img=tcfg.rpn_max_per_img,
            nms_iou=tcfg.rpn_nms_iou)
    tout = c4_simple_test(tmodel, timg, DetCrossEntropyLoss(NUM_CLASSES),
                          tcfg)
    return {"jax": (np.asarray(jprops), np.asarray(jvalid),
                    jax.tree_util.tree_map(np.asarray, jout)),
            "torch": (tprops.numpy(), tvalid.numpy(),
                      {k: v.numpy() for k, v in tout.items()}),
            "feat": (np.asarray(jfeat), feat)}


def test_trunk_num_stages_3_matches_jax(models, c4_run):
    """The C4 map of the uint8 canvases: three stages, stride 16, 1024
    channels, a contiguous NHWC view; within 1e-5 of its largest value
    (measured 8.0e-7)."""
    tmodel = models[2]
    want, got = c4_run["feat"]
    assert len(tmodel.backbone(torch.zeros(1, 3, 64, 96))) == 3
    assert got.shape == (2, 1024, 4, 6)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


def test_c4_simple_test_proposals(c4_run):
    """Validity exact; boxes atol 5e-4 px (conv summation order, as in
    ``test_torch_slice.py``; measured 3.2e-4)."""
    jp, jv, _ = c4_run["jax"]
    tp, tv, _ = c4_run["torch"]
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(tp, jp, atol=5e-4)


def test_c4_simple_test_detections(c4_run):
    """Keys, shapes and dtypes as JAX's; validity and labels exact;
    scores atol 1e-5; boxes atol 1e-3 px (measured 8.9e-8 and 1.8e-4)."""
    jout, tout = c4_run["jax"][2], c4_run["torch"][2]
    assert set(tout) == set(jout) == {"boxes", "scores", "labels", "valid"}
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        assert tout[k].dtype.kind == jout[k].dtype.kind, k
        assert np.isfinite(tout[k].astype(np.float64)).all(), k
    assert tout["boxes"].shape == (2, CFG["max_per_img"], 4)
    assert jout["valid"].sum() > 0
    np.testing.assert_array_equal(tout["valid"], jout["valid"])
    np.testing.assert_array_equal(tout["labels"], jout["labels"])
    np.testing.assert_allclose(tout["scores"], jout["scores"], atol=1e-5)
    np.testing.assert_allclose(tout["boxes"], jout["boxes"], atol=1e-3)


def test_build_detector_and_dispatch():
    """``FasterRCNNC4`` builds the port's C4 detector (dropping the
    MaskRCNN-only keys, as the JAX registry does); ``make_simple_test``
    routes each family to its own pass; the rest raise."""
    model = build_detector({"type": "FasterRCNNC4", "depth": 50,
                            "num_classes": NUM_CLASSES, "with_mask": False,
                            "cls_predictor": "linear",
                            "compute_dtype": "bfloat16"})
    assert isinstance(model, C4FasterRCNN)
    assert model.backbone.compute_dtype == torch.bfloat16
    assert model.backbone.num_stages == 3
    assert len(model.roi_head.shared_head.layer4) == 3
    with pytest.raises(NotImplementedError):
        build_detector({"type": "FasterRCNNC4", "with_mask": True})
    with pytest.raises(NotImplementedError):
        build_detector({"type": "CascadeRPN"})
    cfg = DetTestCfg()
    loss = DetCrossEntropyLoss(NUM_CLASSES)
    assert make_simple_test(model, loss, cfg).func is c4_simple_test
    mask_rcnn = MaskRCNN(num_classes=NUM_CLASSES)
    assert make_simple_test(mask_rcnn, loss, cfg).func is \
        maskrcnn_simple_test
    with pytest.raises(NotImplementedError):
        make_simple_test(torch.nn.Linear(2, 2), loss, cfg)
    with pytest.raises(NotImplementedError):
        c4_simple_test(model, torch.zeros(1, 64, 64, 3, dtype=torch.uint8),
                       loss, cfg._replace(nms_kind="fast"))


@pytest.fixture(scope="module")
def c4_detector():
    """The C4 config as it stands, shrunk in size only: a 64x96 canvas
    (scale (96, 64)) and a slate of 16 proposals from 64 candidates.
    80 classes, the bf16 trunk and the rest of test_cfg stay."""
    from iif_torch.detection.inference import init_detector

    cfg = Config.fromfile(C4_CONFIG)
    cfg.pipeline["canvas"] = CANVAS
    cfg.pipeline["scales"] = [(96, 64)]
    cfg.test_cfg.update(rpn_nms_pre=64, rpn_max_per_img=16)
    return init_detector(cfg, device="cpu")


def test_init_detector_serves_c4_config_on_cpu(c4_detector):
    """``init_detector`` builds the config's detector; the test split has
    no annotation file here, so the class names fall back to numbers and
    the loss is the config's CE (a softmax)."""
    from iif_torch.detection.inference import (
        inference_detector,
        inference_detector_batch,
    )

    det = c4_detector
    assert isinstance(det.model, C4FasterRCNN)
    assert det.model.num_classes == 80
    assert det.model.backbone.compute_dtype == torch.bfloat16
    assert det.model.backbone.frozen_stages == 1
    assert isinstance(det.loss_cls, DetCrossEntropyLoss)
    assert det.CLASSES == [str(i) for i in range(80)]
    assert det.test_cfg.score_thr == 0.05 and det.test_cfg.max_per_img == 100
    img = np.random.RandomState(4).randint(0, 256, (48, 80, 3)).astype(
        np.uint8)
    res = inference_detector(det, img)
    assert set(res) == {"boxes", "scores", "labels", "valid"}
    assert res["boxes"].shape == (100, 4)
    for v in res.values():
        assert np.isfinite(v.astype(np.float64)).all()
    # the request is the model's pass on the pipeline's canvas, rescaled
    sample = det.pipeline(img, det.device)
    out = c4_simple_test(det.model, sample["image"][None], det.loss_cls,
                         det.test_cfg)
    np.testing.assert_array_equal(res["valid"], out["valid"][0].numpy())
    np.testing.assert_array_equal(
        res["boxes"], (out["boxes"][0] / float(sample["scale_factor"]))
        .numpy())
    batched = inference_detector_batch(det, [img], pad_to=2)
    assert len(batched) == 1
    np.testing.assert_array_equal(batched[0]["scores"], res["scores"])


def test_server_answers_c4(c4_detector):
    """The HTTP server over the C4 detector: ping, then one PNG request.
    Seeded heads score about 1/81, under the config's 0.05, so this
    request's ``score_thr`` is 0 to make the answer carry detections."""
    import json
    import threading
    import urllib.request

    import cv2

    from iif_torch.cli.serve import make_server
    from iif_torch.detection.inference import Detector

    d = c4_detector
    det = Detector(d.model, d.loss_cls, d.test_cfg._replace(score_thr=0.0),
                   d.pipeline, d.CLASSES, d.device)
    server = make_server(det, score_thr=0.0, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/ping", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "Healthy"}
        img = np.random.RandomState(5).randint(0, 256, (40, 56, 3))
        ok, png = cv2.imencode(".png", img.astype(np.uint8))
        assert ok
        req = urllib.request.Request(base + "/predictions/model",
                                     data=png.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            preds = json.loads(r.read())
        assert preds and {"class_name", "bbox", "score"} <= set(preds[0])
        assert all(p["class_name"] in d.CLASSES for p in preds)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
