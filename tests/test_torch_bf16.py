"""The detectors' bf16 path against the JAX package, stage by stage, at
depth (1, 1, 1, 1) (``_DEPTH_LAYERS`` of both packages given a depth 14
for the test) on a 64x96 canvas, every parameter and BN statistic
randomised: MaskRCNN's trunk C2-C5, the FPN outputs, the RPN head's logits
and deltas and the bbox head's logits on fixed RoI features; Faster R-CNN
C4's trunk (``backbone``) and res5 on fixed f32 RoI features (K3's
output dtype). Every served and trained config computes in bf16
(``compute_dtype="bfloat16"``).

Tolerances, of each tensor's largest magnitude, measured in brackets: a
bf16 rounding at every conv and BN output (2^-8 relative), at other
places in the two frameworks' convolutions, compounds through the stages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_c4 import _randomise
from tests.test_torch_convert import jax_variables, random_mmdet_state

torch.set_num_threads(1)

CANVAS = (64, 96)
DEPTH = 14                       # (1, 1, 1, 1) bottlenecks, for the test


@pytest.fixture
def shallow(monkeypatch):
    from iif_tpu.detection import detector as jd

    from iif_torch.detection import detector as td

    monkeypatch.setitem(jd._DEPTH_LAYERS, DEPTH, ((1, 1, 1, 1),
                                                  "bottleneck"))
    monkeypatch.setitem(td._DEPTH_LAYERS, DEPTH, (1, 1, 1, 1))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _images(seed):
    return np.random.RandomState(seed).randint(
        0, 256, (2,) + CANVAS + (3,)).astype(np.uint8)


# (measured) C2-C5 5.4e-3, 7.6e-3, 5.8e-3, 1.1e-2; P2-P6 up to 1.2e-2; RPN
# logits up to 1.4e-2, deltas 1.1e-2; the bbox head, f32 on the same bf16
# RoI features as in JAX, logits 9.3e-7 and deltas 1.0e-6
MASKRCNN_TOL = {"trunk": 3e-2, "fpn": 3e-2, "rpn": 4e-2, "bbox": 1e-5}


def test_maskrcnn_bf16_stages_match_jax(shallow):
    from iif_tpu.detection import detector as jd

    from iif_torch.detection import detector as td

    model = td.MaskRCNN(num_classes=7, depth=DEPTH,
                        compute_dtype=torch.bfloat16).eval()
    state = random_mmdet_state(model, np.random.RandomState(0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    variables = jax_variables(state)
    jm = jd.MaskRCNN(num_classes=7, depth=DEPTH,
                     compute_dtype=jnp.bfloat16)
    images = _images(1)
    rois = np.random.RandomState(2).randn(6, 7, 7, 256).astype(np.float32)

    def jax_fn(v, img, rois):
        def stages(m, img, rois):
            c = m.backbone(jd.normalize_if_uint8(img), train=False,
                           return_features=True)
            p = m.neck(c)
            return c, p, m.rpn_head(p), m.bbox_head(rois)
        return jm.apply(v, img, rois, method=stages)

    jc, jp, (jcls, jreg), jbbox = jax.jit(jax_fn)(
        variables, jnp.asarray(images),
        jnp.asarray(rois).astype(jnp.bfloat16))
    with torch.inference_mode():
        x = td.normalize_if_uint8(torch.from_numpy(images)).permute(
            0, 3, 1, 2)
        tc = model.backbone(x)
        tp = model.neck(tc)
        tcls, treg = model.rpn_head(tp)
        tbbox = model.roi_head.bbox_head(
            torch.from_numpy(rois).to(torch.bfloat16))
    assert all(t.dtype == torch.bfloat16 for t in tc + tuple(tp))
    for g, w in zip(tc, jc):
        assert _rel(_nhwc(g), w) < MASKRCNN_TOL["trunk"]
    for g, w in zip(tp, jp):
        assert _rel(_nhwc(g), w) < MASKRCNN_TOL["fpn"]
    for gs, ws in ((tcls, jcls), (treg, jreg)):
        for g, w in zip(gs, ws):
            g = g if g.dim() == w.ndim and g.shape[-1] == w.shape[-1] \
                else g.permute(0, 2, 3, 1)
            assert _rel(g.float().numpy(), w) < MASKRCNN_TOL["rpn"]
    for g, w in zip(tbbox[:2], jbbox[:2]):
        assert _rel(g.float().numpy(), w) < MASKRCNN_TOL["bbox"]


# (measured) C4 map 8.8e-3, res5 on f32 RoI features 5.8e-3
C4_TOL = {"trunk": 3e-2, "res5": 3e-2}


def test_c4_bf16_backbone_and_res5_match_jax(shallow):
    from iif_tpu.detection.c4 import C4FasterRCNN as JaxC4

    from iif_torch.detection.c4 import C4FasterRCNN
    from iif_torch.detection.convert import c4_state_from_jax

    jm = JaxC4(num_classes=3, depth=DEPTH, compute_dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)), False))
    variables = _randomise(shapes, np.random.RandomState(3))
    model = C4FasterRCNN(num_classes=3, depth=DEPTH,
                         compute_dtype=torch.bfloat16).eval()
    model.load_state_dict(c4_state_from_jax(variables["params"],
                                            variables["batch_stats"]))
    images = _images(4)
    rois = np.random.RandomState(5).randn(5, 14, 14, 1024).astype(
        np.float32)

    def jax_fn(v, img, rois):
        return (jm.apply(v, img, method="extract_feat"),
                jm.apply(v, rois, method="forward_shared"))

    jfeat, jshared = jax.jit(jax_fn)(variables, jnp.asarray(images),
                                     jnp.asarray(rois))
    with torch.inference_mode():
        feat = model.extract_feat(torch.from_numpy(images))
        shared = model.forward_shared(torch.from_numpy(rois))
    assert feat.dtype == shared.dtype == torch.bfloat16
    assert jfeat.dtype == jshared.dtype == jnp.bfloat16
    assert _rel(_nhwc(feat), jfeat) < C4_TOL["trunk"]
    assert _rel(_nhwc(shared), jshared) < C4_TOL["res5"]
