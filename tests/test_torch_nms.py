"""NMS, multiclass NMS and RPN proposals against the JAX package on the
same seeded inputs. Scores are jittered: exact ties order differently in
``torch.topk`` and ``lax.top_k`` (docs/parity_matrix.md), though the
port's stable sort follows ``lax.top_k``'s index order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.ops.nms import batched_nms, multiclass_nms, nms, top_k
from iif_torch.detection.rpn import rpn_proposals

torch.set_num_threads(1)


def _boxes(rng, n, extent=200.0):
    xy = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * extent / 4 + 2.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n,thr", [(50, 0.5), (300, 0.7), (300, 0.3)])
def test_nms_keep_set_matches_jax(n, thr):
    """Keep mask and order exact; 300 boxes span three 128-blocks."""
    from iif_tpu.ops.nms import nms as jax_nms

    rng = np.random.RandomState(n)
    boxes = _boxes(rng, n, 120.0)
    scores = rng.rand(n).astype(np.float32)
    jk, jo = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), thr)
    tk, to = nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < n


def test_nms_batched_equals_per_item():
    rng = np.random.RandomState(7)
    boxes = torch.from_numpy(np.stack([_boxes(rng, 200) for _ in range(3)]))
    scores = torch.from_numpy(rng.rand(3, 200).astype(np.float32))
    keep, order = nms(boxes, scores, 0.5)
    for i in range(3):
        k, o = nms(boxes[i], scores[i], 0.5)
        assert torch.equal(k, keep[i]) and torch.equal(o, order[i])


def test_batched_nms_matches_jax():
    from iif_tpu.ops.nms import batched_nms as jax_batched_nms

    rng = np.random.RandomState(8)
    boxes = _boxes(rng, 150, 80.0)
    scores = rng.rand(150).astype(np.float32)
    idxs = rng.randint(0, 5, 150)
    jk, jo = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(idxs), 0.5)
    tk, to = batched_nms(torch.from_numpy(boxes)[None],
                         torch.from_numpy(scores)[None],
                         torch.from_numpy(idxs)[None], 0.5)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk))


def test_top_k_breaks_ties_like_lax():
    x = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("class_specific", [True, False])
@pytest.mark.parametrize("score_thr,max_per_img", [(0.05, 100), (0.3, 20)])
def test_multiclass_nms_matches_jax(class_specific, score_thr, max_per_img):
    """Keep sets and labels exact; boxes and scores atol 1e-6."""
    from iif_tpu.ops.nms import multiclass_nms as jax_mc

    rng = np.random.RandomState(11)
    n, c = 60, 6
    base = _boxes(rng, n, 100.0)
    if class_specific:
        boxes = (np.repeat(base, c, 1)
                 + rng.randn(n, 4 * c).astype(np.float32) * 3.0)
    else:
        boxes = base
    logits = rng.randn(n, c + 1).astype(np.float32) * 2.0
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    jd, js, jl, jv = jax_mc(jnp.asarray(boxes), jnp.asarray(scores),
                            score_thr, 0.5, max_per_img)
    td, ts, tl, tv = multiclass_nms(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(scores)[None],
                                    score_thr, 0.5, max_per_img)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), atol=1e-6)
    assert 0 < tv.sum()


@pytest.mark.parametrize("nms_pre,max_per_img", [(100, 120), (40, 300)])
def test_rpn_proposals_match_jax(nms_pre, max_per_img):
    """Seeded RPN outputs over the 5 levels of a 128x160 canvas, two
    images. Validity exact; boxes atol 1e-4 px; scores atol 1e-6."""
    from iif_tpu.detection.detector import fpn_shapes as jax_fpn_shapes
    from iif_tpu.detection.detector import (
        make_anchor_generator as jax_anchors,
    )
    from iif_tpu.detection.rpn import rpn_proposals as jax_rpn

    from iif_torch.detection.detector import fpn_shapes, make_anchor_generator

    rng = np.random.RandomState(nms_pre)
    canvas = (128, 160)
    shapes = fpn_shapes(canvas)
    assert shapes == jax_fpn_shapes(canvas)
    anchors = make_anchor_generator().grid_anchors(shapes)
    for a, b in zip(anchors, jax_anchors().grid_anchors(shapes)):
        np.testing.assert_array_equal(a, b)
    cls = [rng.randn(2, h, w, 3).astype(np.float32) * 2 for h, w in shapes]
    reg = [rng.randn(2, h, w, 12).astype(np.float32) * 0.3
           for h, w in shapes]
    jb, js, jv = jax.jit(lambda c, r, a: jax_rpn(
        c, r, a, canvas, nms_pre=nms_pre, max_per_img=max_per_img))(
        [jnp.asarray(x) for x in cls], [jnp.asarray(x) for x in reg],
        [jnp.asarray(a) for a in anchors])
    tb, ts, tv = rpn_proposals([torch.from_numpy(x) for x in cls],
                               [torch.from_numpy(x) for x in reg],
                               [torch.from_numpy(a) for a in anchors],
                               canvas, nms_pre=nms_pre,
                               max_per_img=max_per_img)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert tv.sum() > 0
