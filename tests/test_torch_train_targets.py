"""The training targets and losses of the port against the JAX package on
the same numpy inputs: ``bbox2delta``, ``valid_flags``, ``max_iou_assign``,
the random sampler, ``rpn_loss``, ``bbox_targets``, ``bbox_head_loss``,
``unpack_mask_bits``, ``mask_targets``, ``mask_head_loss`` and the IIF loss
with the weights the bbox head passes.

``jax.random`` and ``torch.Generator`` give different bits, so each
sampler here gets the JAX package's own draw, rebuilt from its key chain
(``jax_sampler_noise``), and must then pick the same indices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection import bbox_head as tbh
from iif_torch.detection import detector as td
from iif_torch.detection import mask_head as tmh
from iif_torch.detection.losses import DetIIFLoss
from iif_torch.detection.rpn import rpn_loss
from iif_torch.ops.anchors import AnchorGenerator
from iif_torch.ops.assigner import max_iou_assign
from iif_torch.ops.boxes import bbox2delta
from iif_torch.ops.sampler import random_sample_pos_neg

torch.set_num_threads(1)

CANVAS = (64, 96)


def jax_sampler_noise(key, b, n):
    """The uniform draws of ``iif_tpu``'s ``random_sample_pos_neg`` for b
    images from the key its caller gets: ``split(key, b)`` per image
    (``rpn.py:86``, ``bbox_head.py:235``), then ``split`` into
    ``k_pos, k_neg`` (``sampler.py:67``) and ``uniform(k, (n,))``
    (``sampler.py:37``). Returns (pos, neg), each (b, n) float32."""
    pos, neg = [], []
    for k in jax.random.split(key, b):
        k_pos, k_neg = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(k_pos, (n,))))
        neg.append(np.asarray(jax.random.uniform(k_neg, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def jax_loss_noise(key, b, n_anchors, n_cand):
    """All draws of ``iif_tpu``'s ``maskrcnn_loss`` under ``key``
    (``detector.py:471``: ``split(key, 3)`` -> ``k_rpn, k_rcnn``)."""
    k_rpn, k_rcnn, _ = jax.random.split(key, 3)
    return {"rpn": jax_sampler_noise(k_rpn, b, n_anchors),
            "rcnn": jax_sampler_noise(k_rcnn, b, n_cand)}


def random_boxes(rng, shape, canvas=CANVAS, lo=4.0, hi=40.0):
    h, w = canvas
    x1 = rng.uniform(0, w - lo, shape)
    y1 = rng.uniform(0, h - lo, shape)
    x2 = np.minimum(x1 + rng.uniform(lo, hi, shape), w)
    y2 = np.minimum(y1 + rng.uniform(lo, hi, shape), h)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def make_gt(rng, b, g, num_classes, canvas=CANVAS, p_valid=0.7):
    boxes = random_boxes(rng, (b, g), canvas, 6.0, 40.0)
    labels = rng.randint(0, num_classes, (b, g)).astype(np.int32)
    valid = rng.rand(b, g) < p_valid
    valid[:, 0] = True
    return boxes, labels, valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_bbox2delta_matches_jax():
    from iif_tpu.ops.boxes import bbox2delta as jax_b2d

    rng = np.random.RandomState(0)
    props = random_boxes(rng, (64,))
    gts = random_boxes(rng, (64,))
    props[0, 2] = props[0, 0]              # degenerate: clamp at 1e-6
    means, stds = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)
    got = bbox2delta(_t(props), _t(gts), means, stds).numpy()
    want = np.asarray(jax_b2d(jnp.asarray(props), jnp.asarray(gts), means,
                              stds))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_valid_flags_match_jax():
    from iif_tpu.detection.detector import (
        make_anchor_generator as jax_gen,
    )

    shapes = td.fpn_shapes(CANVAS)
    gen = td.make_anchor_generator()
    assert isinstance(gen, AnchorGenerator)
    for pad in (CANVAS, (50, 70)):
        got = gen.valid_flags(shapes, pad)
        want = jax_gen().valid_flags(shapes, pad)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert not np.concatenate(gen.valid_flags(shapes, (50, 70))).all()


def _jax_assign(boxes, gtb, gtv, *args, **kw):
    from iif_tpu.ops.assigner import max_iou_assign as jax_assign

    out = [jax_assign(jnp.asarray(boxes), jnp.asarray(g), jnp.asarray(v),
                      *args, **kw) for g, v in zip(gtb, gtv)]
    return (np.stack([np.asarray(a) for a, _ in out]),
            np.stack([np.asarray(m) for _, m in out]))


@pytest.mark.parametrize("low_quality", [True, False])
def test_max_iou_assign_matches_jax(low_quality):
    """Image 0 has duplicate gts (ties across gts: the last one wins) and
    a box equal to a gt (ties within a gt); image 1 has no valid gt (every
    box negative)."""
    rng = np.random.RandomState(1)
    boxes = random_boxes(rng, (300,))
    gtb, _, gtv = make_gt(rng, 2, 5, 3)
    gtb[0, 3] = gtb[0, 1]
    boxes[7] = gtb[0, 2]
    boxes[8] = gtb[0, 2]
    gtv[1] = False
    args = (0.7, 0.3, 0.3)
    got_a, got_m = max_iou_assign(_t(boxes), _t(gtb), _t(gtv), *args,
                                  match_low_quality=low_quality)
    want_a, want_m = _jax_assign(boxes, gtb, gtv, *args,
                                 match_low_quality=low_quality)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert (want_a[1] == 0).all()
    assert (want_a[0] > 0).any()
    if low_quality:
        assert want_a[0, 7] == want_a[0, 8] == 3


@pytest.mark.parametrize("case", ["mixed", "scarce_pos", "no_pos",
                                  "pool_below_num"])
def test_sampler_matches_jax_with_its_noise(case):
    from iif_tpu.ops.sampler import random_sample_pos_neg as jax_sample

    rng = np.random.RandomState(2)
    n, num, frac = (40, 64, 0.25) if case == "pool_below_num" else \
        (700, 128, 0.25)
    assigned = rng.choice([-1, 0, 0, 1, 2, 3], size=(2, n)).astype(np.int32)
    if case == "scarce_pos":
        assigned[:, :] = np.where(assigned > 0, 0, assigned)
        assigned[0, [5, 90]] = [1, 2]
    if case == "no_pos":
        assigned[1] = np.where(assigned[1] > 0, -1, assigned[1])
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want = [jax_sample(k, jnp.asarray(a), num, frac)
            for k, a in zip(keys, assigned)]
    pos, neg = [], []
    for k in keys:
        k_pos, k_neg = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(k_pos, (n,))))
        neg.append(np.asarray(jax.random.uniform(k_neg, (n,))))
    inds, is_pos, valid = random_sample_pos_neg(
        _t(assigned), num, frac, _t(np.stack(pos)), _t(np.stack(neg)))
    for i, (wi, wp, wv) in enumerate(want):
        np.testing.assert_array_equal(inds[i].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(is_pos[i].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(wv))


def test_sampler_draws_from_generator_without_noise():
    assigned = torch.tensor([[0, 1, 0, 2, -1, 0, 0, 1]] * 2)
    a = random_sample_pos_neg(assigned, 4, 0.5,
                              generator=torch.Generator().manual_seed(3))
    b = random_sample_pos_neg(assigned, 4, 0.5,
                              generator=torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    inds, is_pos, valid = a
    assert valid.all() and is_pos[:, :2].all() and not is_pos[:, 2:].any()
    assert (assigned.gather(1, inds)[:, :2] > 0).all()


def _rpn_inputs(rng, b=2, g=6):
    shapes = td.fpn_shapes(CANVAS)
    gen = td.make_anchor_generator()
    anchors = np.concatenate(gen.grid_anchors(shapes))
    valid = np.concatenate(gen.valid_flags(shapes, (56, 88)))
    cls = [rng.randn(b, h, w, 3).astype(np.float32) for h, w in shapes]
    reg = [0.3 * rng.randn(b, h, w, 12).astype(np.float32)
           for h, w in shapes]
    gtb, gtl, gtv = make_gt(rng, b, g, 5)
    return anchors, valid, cls, reg, gtb, gtl, gtv


def test_rpn_loss_matches_jax():
    """rtol 1e-5: the batch's sums run in another order."""
    from iif_tpu.detection.rpn import rpn_loss as jax_rpn_loss

    rng = np.random.RandomState(3)
    anchors, valid, cls, reg, gtb, _, gtv = _rpn_inputs(rng)
    key = jax.random.PRNGKey(11)
    want = jax.jit(jax_rpn_loss)(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        jnp.asarray(anchors), jnp.asarray(valid), jnp.asarray(gtb),
        jnp.asarray(gtv), key)
    got = rpn_loss([_t(c) for c in cls], [_t(r) for r in reg], _t(anchors),
                   _t(valid), _t(gtb), _t(gtv),
                   noise=jax_sampler_noise(key, 2, anchors.shape[0]))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.item(), float(w), rtol=1e-5)
    assert float(want[1]) > 0


def _bbox_inputs(rng, num_classes=5, b=2, p=40, g=6):
    props = random_boxes(rng, (b, p))
    pvalid = rng.rand(b, p) < 0.9
    gtb, gtl, gtv = make_gt(rng, b, g, num_classes)
    # proposals near the gts, so that some are positives
    props[:, :g] = gtb + rng.uniform(-3, 3, gtb.shape).astype(np.float32)
    return props, pvalid, gtb, gtl, gtv


def test_bbox_targets_match_jax():
    from iif_tpu.detection.bbox_head import bbox_targets as jax_targets

    rng = np.random.RandomState(4)
    props, pvalid, gtb, gtl, gtv = _bbox_inputs(rng)
    key = jax.random.PRNGKey(12)
    want = jax.jit(jax_targets, static_argnums=(6,), static_argnames=(
        "num_samples", "pos_fraction"))(
        key, jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gtb),
        jnp.asarray(gtl), jnp.asarray(gtv), 5, num_samples=32,
        pos_fraction=0.25)
    got = tbh.bbox_targets(
        _t(props), _t(pvalid), _t(gtb), _t(gtl), _t(gtv), 5,
        num_samples=32, pos_fraction=0.25,
        noise=jax_sampler_noise(key, 2, props.shape[1] + gtb.shape[1]))
    for name in tbh.BBoxTargets._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "bbox_targets":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert np.asarray(want.bbox_weights).sum() > 0


def test_bbox_head_loss_and_iif_loss_match_jax():
    """The IIF CE with the label weights and avg_factor that
    ``bbox_head_loss`` passes, and the L1 on positives; rtol 1e-6."""
    from iif_tpu.detection.bbox_head import BBoxTargets as JaxTargets
    from iif_tpu.detection.bbox_head import bbox_head_loss as jax_loss
    from iif_tpu.detection.losses import DetIIFLoss as JaxIIF

    rng = np.random.RandomState(5)
    c, n = 5, 64
    weights = np.linspace(0.5, 3.0, c + 1).astype(np.float32)
    cls = rng.randn(n, c + 1).astype(np.float32)
    pred = rng.randn(n, 4 * c).astype(np.float32)
    labels = rng.randint(0, c + 1, (2, n // 2)).astype(np.int64)
    lw = (rng.rand(2, n // 2) < 0.8).astype(np.float32)
    bw = ((labels < c) * lw).astype(np.float32)
    tgt = rng.randn(2, n // 2, 4).astype(np.float32)
    gi = np.zeros((2, n // 2), np.int64)
    rois = random_boxes(rng, (2, n // 2))
    fields = (rois, labels, lw, tgt, bw, gi)
    want = jax_loss(jnp.asarray(cls), jnp.asarray(pred),
                    JaxTargets(*[jnp.asarray(f) for f in fields]),
                    JaxIIF(weights=jnp.asarray(weights)), c)
    got = tbh.bbox_head_loss(_t(cls), _t(pred),
                             tbh.BBoxTargets(*[_t(f) for f in fields]),
                             DetIIFLoss(weights), c)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.item(), float(w), rtol=1e-6)
    w_iif = JaxIIF(weights=jnp.asarray(weights))(
        jnp.asarray(cls), jnp.asarray(labels.reshape(-1)),
        weight=jnp.asarray(lw.reshape(-1)), avg_factor=jnp.asarray(7.0))
    g_iif = DetIIFLoss(weights)(_t(cls), _t(labels.reshape(-1)),
                                weight=_t(lw.reshape(-1)),
                                avg_factor=torch.tensor(7.0))
    np.testing.assert_allclose(g_iif.item(), float(w_iif), rtol=1e-6)


def test_unpack_mask_bits_matches_jax():
    from iif_tpu.detection.detector import unpack_mask_bits as jax_unpack

    rng = np.random.RandomState(6)
    masks = (rng.rand(2, 3, 10, 45) < 0.4).astype(np.uint8)
    packed = np.packbits(masks, axis=-1)
    got = td.unpack_mask_bits(_t(packed), 45).numpy()
    np.testing.assert_array_equal(got, masks)
    np.testing.assert_array_equal(
        got, np.asarray(jax_unpack(jnp.asarray(packed), 45)))
    batch = {"gt_masks_packed": _t(packed)}
    assert torch.equal(td.resolve_gt_masks(batch, 45), _t(masks))
    assert td.resolve_gt_masks({"gt_masks": _t(masks)}, 45) is not None


@pytest.mark.parametrize("gt_stride", [1, 2])
def test_mask_targets_match_jax(gt_stride):
    """Blobby masks (thresholded smooth noise), RoIs on the canvas, some
    past its border. The port rounds where JAX rounds, so the 0/1 targets
    agree exactly."""
    from iif_tpu.detection.mask_head import mask_targets as jax_targets

    rng = np.random.RandomState(7 + gt_stride)
    b, g = 2, 4
    h, w = CANVAS[0] // gt_stride, CANVAS[1] // gt_stride
    coarse = rng.rand(b, g, h // 4 + 1, w // 4 + 1)
    masks = (np.kron(coarse, np.ones((4, 4)))[:, :, :h, :w] > 0.5).astype(
        np.uint8)
    r = 24
    rois = np.concatenate([rng.randint(0, b, (r, 1)).astype(np.float32),
                           random_boxes(rng, (r,), CANVAS, 4.0, 70.0)], 1)
    gt_inds = rng.randint(0, g, r)
    want = np.asarray(jax_targets(jnp.asarray(rois), jnp.asarray(gt_inds),
                                  jnp.asarray(masks), 28, gt_stride))
    got = tmh.mask_targets(_t(rois), _t(gt_inds), _t(masks), 28,
                           gt_stride).numpy()
    assert got.shape == (r, 28, 28) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9


def test_mask_head_loss_matches_jax():
    from iif_tpu.detection.mask_head import mask_head_loss as jax_loss

    rng = np.random.RandomState(8)
    pred = 3 * rng.randn(12, 28, 28).astype(np.float32)
    tgt = (rng.rand(12, 28, 28) < 0.5).astype(np.float32)
    pos_w = (rng.rand(12) < 0.7).astype(np.float32)
    labels = np.zeros(12, np.int32)
    want = jax_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(labels),
                    jnp.asarray(pos_w))
    got = tmh.mask_head_loss(_t(pred), _t(tgt), _t(pos_w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_train_cfg_from_dict_refuses_unported_knobs():
    cfg = td.train_cfg_from_dict({"rpn_nms_pre": 2000, "roi_ext": "ml",
                                  "rcnn_loss_bbox": "l1",
                                  "mask_gt_stride": 2})
    assert cfg.rpn_nms_pre == 2000 and cfg.mask_gt_stride == 2
    for bad in ({"rcnn_loss_bbox": "smooth_l1"}, {"rcnn_dynamic": True},
                {"rcnn_neg_sampler": "ohem"}, {"rcnn_isr": (("k", 2.0),)}):
        with pytest.raises(NotImplementedError):
            td.train_cfg_from_dict(bad)
