"""Test-time augmentation (``iif_torch/detection/tta.py``) against the JAX
package's ``detection/tta.py``, on the CPU:

- ``multi_scale_flip_views``, ``flip_boxes`` and ``merge_aug_detections``
  (a flipped view at another scale mapping onto the same box, several
  classes, empty input): equal;
- the view mappings ``_boxes_to_view`` / ``_boxes_from_view`` within
  1e-6 of scale;
- ``DetectionPipeline.eval_view`` against JAX's (cv2's resize there,
  PyTorch's bilinear here: at most one grey level apart, as the eval
  branch): shapes, scale factors and flips equal;
- ``maskrcnn_aug_test`` (MaskRCNN with the normed heads, IIF
  activation) and
  ``cascade_aug_test`` (the FASA cascade: normed heads, class-specific
  regressors, the 0.33 stage stds) on two views of one image (another
  scale each, the second flipped; the port's canvases given to both) at
  depth 14, 8 classes, a 64x96 canvas, JAX's ``"ml"`` RoIAlign route as
  its CPU tests run it: labels and ``valid`` equal, boxes, scores and
  masks within 1e-4 of their largest magnitude (two f32 trunks sum their
  convolutions in another order);
- the dispatch: HTC with masks and C4 raise ``NotImplementedError`` (JAX
  fails on both, ``ROADMAP.md`` Queue 3), HTC without masks takes the
  cascade's path.

JAX's programs compile at XLA's backend optimisation level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection import detector as td
from iif_torch.detection import tta
from iif_torch.detection.convert import maskrcnn_state_from_jax
from iif_torch.detection.losses import DetIIFLoss
from iif_torch.detection.pipeline import DetectionPipeline
from tests.test_torch_c4 import _randomise
from tests.test_torch_cascade import (  # noqa: F401  (fixtures)
    CANVAS,
    DEPTH,
    FAST,
    NUM_CLASSES,
    models,
    shallow,
)

torch.set_num_threads(1)

TEST_CFG = dict(rpn_nms_pre=128, rpn_max_per_img=32, score_thr=1e-4,
                nms_iou=0.5, max_per_img=10)
# not monotonic in the class: a rising IIF ranks the last class first
IIF = (1.0 + 0.1 * np.cos(np.arange(NUM_CLASSES + 1))).astype(np.float32)
ORIG = (40, 56)                          # the image's (h, w)
VIEWS = [{"scale": (80, 56), "flip": False}, {"scale": (96, 64),
                                              "flip": True}]
TOL = 1e-4
# the FASA MaskRCNN's heads: a seeded linear classifier ranks one class
# first on every RoI
MASKRCNN = dict(num_classes=NUM_CLASSES, depth=DEPTH, cls_predictor="normed",
                mask_predictor="normed")


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol * scale, rtol=0)


def _image():
    rng = np.random.RandomState(4)
    return rng.randint(0, 256, ORIG + (3,)).astype(np.uint8)


def test_views_and_merge_match_jax():
    from iif_tpu.detection import tta as jtta

    scales = [(1333, 640), (1333, 800)]
    for flip in (True, False):
        assert tta.multi_scale_flip_views(scales, flip) == \
            jtta.multi_scale_flip_views(scales, flip)
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 60, (7, 4)).astype(np.float32)
    np.testing.assert_array_equal(tta.flip_boxes(boxes, 80.0),
                                  jtta.flip_boxes(boxes, 80.0))
    # one object at [10, 10, 30, 30] seen at scale 2 and flipped at 1,
    # plus boxes of two other classes and padding
    per_view = [
        {"boxes": np.array([[20, 20, 60, 60], [2, 2, 40, 30],
                            [0, 0, 0, 0]], np.float32),
         "scores": np.array([0.9, 0.4, 0.0], np.float32),
         "labels": np.array([3, 1, -1]),
         "valid": np.array([True, True, False])},
        {"boxes": np.array([[50, 10, 70, 30], [60, 5, 78, 20]], np.float32),
         "scores": np.array([0.8, 0.7], np.float32),
         "labels": np.array([3, 3]), "valid": np.array([True, True])}]
    meta = [{"scale_factor": 2.0, "flip": False},
            {"scale_factor": 1.0, "flip": True}]
    got = tta.merge_aug_detections(per_view, meta, (100, 80), 0.5)
    want = jtta.merge_aug_detections(per_view, meta, (100, 80), 0.5)
    assert len(got["boxes"]) == 3
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    empty = [{"boxes": np.zeros((2, 4)), "scores": np.zeros(2),
              "labels": np.zeros(2, np.int64), "valid": np.zeros(2, bool)}]
    got = tta.merge_aug_detections(empty, meta[:1], (50, 50))
    assert got["boxes"].shape == (0, 4) and got["labels"].dtype == np.int64


def test_view_mappings_match_jax():
    from iif_tpu.detection import tta as jtta

    rng = np.random.RandomState(1)
    boxes = rng.uniform(0, 50, (3, 5, 4)).astype(np.float32)
    sf = np.array([1.0, 1.6, 0.75], np.float32)[:, None]
    flips = np.array([False, True, True])[:, None]
    cw = np.array([96.0, 90.0, 42.0], np.float32)[:, None]
    for name in ("_boxes_to_view", "_boxes_from_view"):
        got = getattr(tta, name)(*(torch.from_numpy(a) for a in (
            boxes, sf, flips, cw)))
        want = getattr(jtta, name)(*(jnp.asarray(a) for a in (
            boxes, sf, flips, cw)))
        _close(got.numpy(), want, 1e-6)
    back = tta._boxes_from_view(tta._boxes_to_view(
        torch.from_numpy(boxes), *(torch.from_numpy(a) for a in (
            sf, flips, cw))), *(torch.from_numpy(a) for a in (sf, flips, cw)))
    _close(back.numpy(), boxes, 1e-6)


def test_eval_view_matches_jax():
    from iif_tpu.detection.pipeline import DetectionPipeline as JaxPipeline

    image = _image()
    ours = DetectionPipeline(canvas=CANVAS)
    theirs = JaxPipeline(canvas=CANVAS, flip_prob=0.0, max_gt=1,
                         emit_uint8=True)
    for v in VIEWS:
        got = ours.eval_view(image, v["scale"], v["flip"],
                             torch.device("cpu"))
        want = theirs.eval_view(image, v["scale"], v["flip"])
        np.testing.assert_array_equal(got["img_shape"], want["img_shape"])
        assert got["scale_factor"] == want["scale_factor"]
        assert bool(got["flip"]) == bool(want["flip"]) == v["flip"]
        diff = np.abs(got["image"].numpy().astype(int)
                      - want["image"].astype(int))
        assert diff.max() <= 1, diff.max()
    assert got["img_shape"].tolist() == [64, 90]


def _views_batch():
    """The two views on the port's canvases: images (V, H, W, 3) uint8,
    scale factors, flips, content (h, w)."""
    pipe = DetectionPipeline(canvas=CANVAS)
    samples = [pipe.eval_view(_image(), v["scale"], v["flip"],
                              torch.device("cpu")) for v in VIEWS]
    return (torch.stack([s["image"] for s in samples]).numpy(),
            np.array([s["scale_factor"] for s in samples], np.float32),
            np.array([bool(s["flip"]) for s in samples]),
            np.stack([s["img_shape"] for s in samples]).astype(np.float32))


def _compare(jax_fn, jmodel, variables, tmodel, port_fn):
    from iif_tpu.detection.detector import DetTestCfg as JaxTestCfg
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    args = _views_batch()
    jloss, jcfg = JaxIIF(jnp.asarray(IIF)), JaxTestCfg(**TEST_CFG)
    fn = jax.jit(lambda v, *a: jax_fn(jmodel, v, *a, jloss, jcfg))
    jargs = [jnp.asarray(a) for a in args]
    want = fn.lower(variables, *jargs).compile(compiler_options=FAST)(
        variables, *jargs)
    got = port_fn(tmodel, *(torch.from_numpy(a) for a in args),
                  DetIIFLoss(IIF), td.DetTestCfg(**TEST_CFG))
    valid = np.asarray(want["valid"])
    # seeded heads rank one class first on most RoIs of this image
    assert valid.sum() >= 5
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert got["masks"].shape == (TEST_CFG["max_per_img"], 28, 28)
    for key in ("boxes", "scores", "masks"):
        _close(got[key].numpy(), want[key], TOL)
    b = got["boxes"].numpy()[valid]
    assert (b >= -1e-3).all() and (b[:, 2] <= ORIG[1] + 1e-3).all() \
        and (b[:, 3] <= ORIG[0] + 1e-3).all()


def test_maskrcnn_aug_test_matches_jax(shallow):
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.tta import maskrcnn_aug_test as jax_aug

    rng = np.random.RandomState(5)
    jmodel = jd.MaskRCNN(**MASKRCNN)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, rng)
    fc = variables["params"]["bbox_head"]["fc_cls"]
    fc["kernel"] = rng.uniform(0.0, 2.0, fc["kernel"].shape).astype(
        np.float32)
    tmodel = td.MaskRCNN(**MASKRCNN).eval()
    tmodel.load_state_dict(maskrcnn_state_from_jax(variables["params"],
                                                   variables["batch_stats"]))
    _compare(jax_aug, jmodel, variables, tmodel, tta.maskrcnn_aug_test)


def test_cascade_aug_test_matches_jax(models):
    from iif_tpu.detection.tta import cascade_aug_test as jax_aug

    jmodel, variables, tmodel = models

    def jax_fn(m, v, *args):
        *views, jloss, jcfg = args
        return jax_aug(m, v, *views, [jloss] * 3, jcfg)

    _compare(jax_fn, jmodel, variables, tmodel, tta.cascade_aug_test)


def test_aug_test_dispatch(shallow):
    """HTC with masks and C4 refused with the reason; HTC without masks
    runs the cascade's aug-test, as JAX's does."""
    from iif_torch.detection.c4 import C4FasterRCNN
    from iif_torch.detection.htc import HTC

    args = [torch.from_numpy(a) for a in _views_batch()]
    loss, cfg = DetIIFLoss(IIF), td.DetTestCfg(**TEST_CFG)
    with pytest.raises(NotImplementedError, match="mask_head"):
        tta.aug_test(HTC(num_classes=NUM_CLASSES, depth=DEPTH), *args, loss,
                     cfg)
    with pytest.raises(NotImplementedError, match="C4"):
        tta.aug_test(C4FasterRCNN(num_classes=NUM_CLASSES, depth=DEPTH),
                     *args, loss, cfg)
    htc = td.random_init_(HTC(num_classes=NUM_CLASSES, depth=DEPTH,
                              with_mask=False).eval(),
                          torch.Generator().manual_seed(0))
    out = tta.aug_test(htc, *args, loss, cfg)
    assert set(out) == {"boxes", "scores", "labels", "valid"}
    assert out["boxes"].shape == (TEST_CFG["max_per_img"], 4)
    assert bool(torch.isfinite(out["boxes"]).all())
