"""RoI heads and mask paste-back against the JAX package: the Shared2FC
bbox head (CHW flatten vs the JAX HWC flatten, bridged by the converter),
the FCN mask head's per-label logits, and ``paste_masks``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection.bbox_head import Shared2FCBBoxHead
from iif_torch.detection.mask_head import FCNMaskHead, paste_masks
from tests.test_torch_convert import random_mmdet_state

torch.set_num_threads(1)


def _jax_params(state, prefix):
    from iif_tpu.detection.pretrained_det import convert_mmdet_maskrcnn

    params, _ = convert_mmdet_maskrcnn(
        {f"roi_head.{prefix}.{k}": v for k, v in state.items()})
    return params[prefix]


def test_bbox_head_matches_jax():
    """bf16 RoI features in, f32 compute: cls_score and bbox_pred rel
    1e-5."""
    from iif_tpu.detection.bbox_head import Shared2FCBBoxHead as JaxHead

    rng = np.random.RandomState(0)
    head = Shared2FCBBoxHead(7).eval()
    state = random_mmdet_state(head, rng)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    x = rng.randn(12, 7, 7, 256).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jc, jr, _ = JaxHead(7).apply({"params": _jax_params(state, "bbox_head")},
                                 xb)
    with torch.inference_mode():
        tc, tr, _ = head(torch.from_numpy(np.asarray(xb.astype(jnp.float32)))
                         .to(torch.bfloat16))
    for g, w in ((tc, jc), (tr, jr)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_mask_head_logits_for_labels_match_jax():
    """Per-label 28x28 logits: rel 1e-5 (f32)."""
    from iif_tpu.detection.mask_head import FCNMaskHead as JaxHead

    rng = np.random.RandomState(1)
    head = FCNMaskHead(5).eval()
    state = random_mmdet_state(head, rng)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    x = rng.randn(6, 14, 14, 256).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    want = np.asarray(JaxHead(5).apply(
        {"params": _jax_params(state, "mask_head")}, jnp.asarray(x),
        jnp.asarray(labels), method=JaxHead.logits_for_labels))
    with torch.inference_mode():
        got = head.logits_for_labels(torch.from_numpy(x),
                                     torch.from_numpy(labels)).numpy()
        full = head(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 28, 28)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(
        got, full[np.arange(6), :, :, labels], rtol=1e-5, atol=1e-5)


# boxes smaller than, equal to and larger than 28 px; the last ones touch
# or cross the image border
PASTE_BOXES = np.array([
    [10.3, 12.7, 21.9, 20.2],
    [30.0, 8.0, 58.0, 36.0],
    [5.5, 3.25, 75.75, 50.5],
    [0.0, 0.0, 40.0, 30.0],
    [60.2, 40.9, 96.0, 64.0],
    [-4.0, 50.0, 20.0, 70.0],
], np.float32)


def _jax_paste_values(masks, boxes, hw):
    """The interpolated map behind ``iif_tpu`` ``paste_masks`` before its
    threshold (the same scale_and_translate call), for the report."""
    import jax

    s = masks.shape[-1]
    out = []
    for m, (x1, y1, x2, y2) in zip(np.pad(masks, ((0, 0), (1, 1), (1, 1))),
                                   boxes):
        bw, bh = max(x2 - x1, 1.0) / s, max(y2 - y1, 1.0) / s
        out.append(np.asarray(jax.image.scale_and_translate(
            jnp.asarray(m)[..., None], hw + (1,), (0, 1),
            jnp.asarray([bh, bw]), jnp.asarray([y1 - bh, x1 - bw]),
            method="bilinear", antialias=False))[..., 0])
    return np.stack(out)


@pytest.mark.parametrize("threshold", [0.5, 0.4])
def test_paste_masks_matches_jax(threshold):
    """Booleans equal. A differing pixel is reported with both frameworks'
    interpolated values: a difference there can only come from float
    rounding of a value at the threshold."""
    from iif_tpu.detection.mask_head import paste_masks as jax_paste

    rng = np.random.RandomState(2)
    masks = rng.rand(len(PASTE_BOXES), 28, 28).astype(np.float32)
    hw = (64, 96)
    want = np.asarray(jax_paste(jnp.asarray(masks), jnp.asarray(PASTE_BOXES),
                                hw, threshold))
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(PASTE_BOXES),
                      hw, threshold).numpy()
    assert got.shape == want.shape == (len(PASTE_BOXES),) + hw
    diff = np.argwhere(got != want)
    if len(diff):
        jf = _jax_paste_values(masks, PASTE_BOXES, hw)
        lines = [f"roi {r} pixel ({y},{x}): port {got[r, y, x]} jax "
                 f"{want[r, y, x]}, interpolated {jf[r, y, x]!r}"
                 for r, y, x in diff[:10]]
        pytest.fail(f"{len(diff)} pixels differ from JAX:\n"
                    + "\n".join(lines))
    assert want.any() and not want.all()
