"""The whole serving slice against the JAX package: ``maskrcnn_simple_test``
of ``iif_tpu`` and of ``iif_torch`` on one small canvas (64x96), depth 50,
7 classes, f32, the same seeded weights (one torch-named state_dict, into
JAX through its own converter) and the same uint8 images."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection import detector as td
from iif_torch.detection.losses import (
    DetIIFLoss,
    compute_det_iif_from_counts,
)
from iif_torch.detection.rpn import rpn_proposals
from tests.test_torch_convert import jax_variables, random_mmdet_state

torch.set_num_threads(1)

NUM_CLASSES = 7
CANVAS = (64, 96)
CFG = dict(rpn_nms_pre=60, rpn_max_per_img=40, score_thr=0.05,
           nms_iou=0.5, max_per_img=20)


@pytest.fixture(scope="module")
def slice_run():
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.losses import DetIIFLoss as JaxDetIIFLoss
    from iif_tpu.detection.rpn import rpn_proposals as jax_rpn_proposals

    rng = np.random.RandomState(0)
    model = td.MaskRCNN(num_classes=NUM_CLASSES, depth=50).eval()
    state = random_mmdet_state(model, rng)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    variables = jax_variables(state)
    counts = np.exp(rng.uniform(0, np.log(5000), NUM_CLASSES)).astype(int)
    weights = compute_det_iif_from_counts(counts, 10000)
    images = rng.randint(0, 256, (2,) + CANVAS + (3,)).astype(np.uint8)

    jmodel = jd.MaskRCNN(num_classes=NUM_CLASSES, depth=50)
    jloss = JaxDetIIFLoss(weights=jnp.asarray(weights))
    jcfg = jd.DetTestCfg(**CFG)

    def jax_fn(v, img):
        feats = jmodel.apply(v, img, False, method="extract_feat")
        cls, reg = jmodel.apply(v, feats, method=jd.MaskRCNN.forward_rpn)
        anchors = jd.make_anchor_generator().grid_anchors(
            jd.fpn_shapes(CANVAS))
        props, _, pvalid = jax_rpn_proposals(
            cls, reg, [jnp.asarray(a) for a in anchors], CANVAS,
            nms_pre=jcfg.rpn_nms_pre, max_per_img=jcfg.rpn_max_per_img,
            nms_iou=jcfg.rpn_nms_iou)
        out = jd.maskrcnn_simple_test(jmodel, v, img, jloss, jcfg)
        return props, pvalid, out

    jprops, jvalid, jout = jax.jit(jax_fn)(variables, jnp.asarray(images))

    timg = torch.from_numpy(images)
    tloss = DetIIFLoss(weights)
    tcfg = td.DetTestCfg(**CFG)
    with torch.inference_mode():
        feats = model.extract_feat(timg)
        cls, reg = model.rpn_head(feats)
        tprops, _, tvalid = rpn_proposals(
            cls, reg, model.anchors(CANVAS, "cpu"), CANVAS,
            nms_pre=tcfg.rpn_nms_pre, max_per_img=tcfg.rpn_max_per_img,
            nms_iou=tcfg.rpn_nms_iou)
    tout = td.maskrcnn_simple_test(model, timg, tloss, tcfg)
    return {"jax": (np.asarray(jprops), np.asarray(jvalid),
                    jax.tree_util.tree_map(np.asarray, jout)),
            "torch": (tprops.numpy(), tvalid.numpy(),
                      {k: v.numpy() for k, v in tout.items()})}


def test_slice_output_keys_shapes_dtypes(slice_run):
    jout, tout = slice_run["jax"][2], slice_run["torch"][2]
    assert set(tout) == set(jout) == {"boxes", "scores", "labels", "valid",
                                      "masks"}
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        assert tout[k].dtype.kind == jout[k].dtype.kind, k
        assert np.isfinite(tout[k].astype(np.float64)).all(), k
    assert jout["valid"].sum() > 0


def test_slice_proposals(slice_run):
    """Validity exact; boxes atol 5e-4 px: the two f32 trunks sum their
    convolutions in another order, which leaves a relative difference of
    about 2e-6 in the RPN outputs after 50 layers."""
    jp, jv, _ = slice_run["jax"]
    tp, tv, _ = slice_run["torch"]
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(tp, jp, atol=5e-4)


def test_slice_detections(slice_run):
    """Validity and labels exact; scores atol 1e-5; boxes atol 1e-3 px;
    mask probabilities atol 1e-5."""
    jout, tout = slice_run["jax"][2], slice_run["torch"][2]
    np.testing.assert_array_equal(tout["valid"], jout["valid"])
    np.testing.assert_array_equal(tout["labels"], jout["labels"])
    np.testing.assert_allclose(tout["scores"], jout["scores"], atol=1e-5)
    np.testing.assert_allclose(tout["boxes"], jout["boxes"], atol=1e-3)
    np.testing.assert_allclose(tout["masks"], jout["masks"], atol=1e-5)
