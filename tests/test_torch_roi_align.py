"""Multi-level RoIAlign (kernel K1's plain version and the extractor that
calls it) against the JAX package's ``SingleRoIExtractor(...,
use_pallas="ml")``, which on the CPU runs ``_flat_gather``. The CUDA
kernels K1 and K2 themselves run only on the card (``cuda`` marker):

    python3 -m pytest tests/test_torch_roi_align.py -m cuda -q
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection.roi_extractor import SingleRoIExtractor
from iif_torch.ops.roi_align_ml import (
    map_roi_levels,
    roi_align_ml,
    roi_align_ml_grad_reference,
    roi_align_ml_reference,
)

torch.set_num_threads(1)

LVIS_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
SMALL_LEVELS = [(16, 24), (8, 12), (4, 6), (2, 3)]


def make_rois(rng, r, canvas_hw, scale_range):
    """RoIs as in tests/test_pallas_roi_align.py: log-uniform size and
    aspect, the first four at aspect 8, 12, 1/8 and 16, clamped to the
    canvas (so some touch its border), batch index 0 or 1."""
    h, w = canvas_hw
    centers = rng.rand(r, 2) * [w - 44, h - 20]
    scale_px = np.exp(rng.uniform(np.log(scale_range[0]),
                                  np.log(scale_range[1]), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    aspect[:4] = [8.0, 12.0, 1.0 / 8.0, 16.0]
    w_px = scale_px * np.sqrt(aspect)
    h_px = scale_px / np.sqrt(aspect)
    x1 = np.clip(centers[:, 0] - w_px / 2, 0, w - 1)
    y1 = np.clip(centers[:, 1] - h_px / 2, 0, h - 1)
    x2 = np.clip(centers[:, 0] + w_px / 2, 0, w - 1)
    y2 = np.clip(centers[:, 1] + h_px / 2, 0, h - 1)
    bidx = rng.randint(0, 2, r)
    bidx[:2] = 1
    return np.stack([bidx, x1, y1, x2, y2], 1).astype(np.float32)


def _jax_ml(feats, rois, o):
    from iif_tpu.detection.roi_extractor import SingleRoIExtractor as JaxExt

    return np.asarray(JaxExt((o, o), use_pallas="ml")(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois)))


@pytest.mark.parametrize("o", [7, 14])
def test_plain_matches_jax_small_canvas(o):
    """atol 1e-5 in f32. Coordinates here stay below 24 cells, where one
    ulp of a sample position is below 2e-6 cells."""
    rng = np.random.RandomState(o)
    feats = [rng.randn(2, h, w, 8).astype(np.float32)
             for h, w in SMALL_LEVELS]
    rois = make_rois(rng, 48, (64, 96), (4, 96))
    got = roi_align_ml_reference([torch.from_numpy(f) for f in feats],
                                 torch.from_numpy(rois), (o, o))
    np.testing.assert_allclose(got.numpy(), _jax_ml(feats, rois, o),
                               atol=1e-5)


@pytest.mark.parametrize("o", [7, 14])
def test_plain_matches_jax_lvis_coordinates(o):
    """The LVIS serving levels (800x1344 canvas, narrow C). atol 2e-4:
    XLA on the CPU compiles the bin width into a multiply by 1/o and the
    sample position into a fused multiply-add, while the port rounds a
    true division and a separate multiply and add (the kernel's order).
    At a coordinate of ~336 cells the two positions differ by an ulp
    (3e-5 cells), times a neighbour difference of up to ~7 for randn
    features, divided over 4 samples."""
    rng = np.random.RandomState(10 + o)
    feats = [rng.randn(2, h, w, 4).astype(np.float32)
             for h, w in LVIS_LEVELS]
    rois = make_rois(rng, 96, (800, 1344), (16, 512))
    got = roi_align_ml_reference([torch.from_numpy(f) for f in feats],
                                 torch.from_numpy(rois), (o, o))
    np.testing.assert_allclose(got.numpy(), _jax_ml(feats, rois, o),
                               atol=2e-4)


def test_map_roi_levels_matches_jax():
    from iif_tpu.detection.roi_extractor import map_roi_levels as jax_map

    rng = np.random.RandomState(3)
    rois = make_rois(rng, 512, (800, 1344), (8, 1024))
    got = map_roi_levels(torch.from_numpy(rois), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_map(
        jnp.asarray(rois), 4)))
    assert set(got.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o,sampling_ratio", [(7, 0), (14, 0), (7, 3)])
def test_extractor_routes_return_feature_dtype(dtype, o, sampling_ratio):
    """The extractor's one route casts to the feature dtype (the JAX ml
    path's ``.astype(feats[0].dtype)``) and, on the CPU, is the plain
    version bit for bit at its output size and sampling ratio."""
    rng = np.random.RandomState(5)
    feats = [torch.from_numpy(rng.randn(2, h, w, 8).astype(np.float32))
             .to(dtype) for h, w in SMALL_LEVELS]
    rois = torch.from_numpy(make_rois(rng, 16, (64, 96), (4, 96)))
    got = SingleRoIExtractor((o, o), sampling_ratio=sampling_ratio)(
        feats, rois)
    assert got.dtype == dtype and got.shape == (16, o, o, 8)
    want = roi_align_ml_reference(feats, rois, (o, o),
                                  sampling_ratio=sampling_ratio).to(dtype)
    assert torch.equal(got, want)


def test_wrapper_cpu_is_plain_version():
    rng = np.random.RandomState(6)
    feats = [torch.from_numpy(rng.randn(2, h, w, 8).astype(np.float32))
             for h, w in SMALL_LEVELS]
    rois = torch.from_numpy(make_rois(rng, 16, (64, 96), (4, 96)))
    before = (dict(roi_align_ml.launches_by_size),
              dict(roi_align_ml.launches_by_path))
    got = roi_align_ml(feats, rois, (14, 14))
    assert torch.equal(got, roi_align_ml_reference(feats, rois, (14, 14)))
    assert (roi_align_ml.launches_by_size,
            roi_align_ml.launches_by_path) == before  # no kernel on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("o,r", [(7, 2000), (14, 600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(o, r, dtype):
    """K1 on the card against its plain version at the LVIS serving
    shapes: f32 to 1e-5 (sum order only); bf16 within one bf16 ulp of the
    value after the cast."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(o)
    feats = [torch.from_numpy(rng.randn(2, h, w, 256).astype(np.float32))
             .to("cuda", dtype) for h, w in LVIS_LEVELS]
    rois = torch.from_numpy(make_rois(rng, r, (800, 1344), (16, 512))).cuda()
    got = roi_align_ml(feats, rois, (o, o)).float()
    torch.cuda.synchronize()
    want = roi_align_ml_reference(feats, rois, (o, o))
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        cast = want.to(dtype).float()
        ulp = torch.pow(2.0, torch.floor(torch.log2(cast.abs().clamp(
            min=2.0 ** -126))) - 7)
        assert bool(((got - cast).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("o,r", [(7, 2048), (14, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain_backward_on_card(o, r, dtype):
    """K2 through ``RoIAlignML`` on the card against the plain backward at
    the LVIS training shapes (B=4). Atomics add in an order that changes
    from run to run, so f32 agrees to 1e-5 of the largest magnitude; bf16
    also to 2^-8 of each value (one rounding of an f32 sum that may
    differ in its last bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(o)
    feats = [torch.from_numpy(rng.randn(4, h, w, 256).astype(np.float32))
             .to("cuda", dtype) for h, w in LVIS_LEVELS]
    rois = torch.from_numpy(make_rois(rng, r, (800, 1344), (16, 512)))
    rois[:, 0] = torch.from_numpy(rng.randint(0, 4, r).astype(np.float32))
    rois = rois.cuda()
    g = torch.from_numpy(rng.randn(r, o, o, 256).astype(np.float32)).to(
        "cuda", dtype)
    leaves = [f.clone().requires_grad_() for f in feats]
    roi_align_ml(leaves, rois, (o, o)).backward(g)
    torch.cuda.synchronize()
    want = roi_align_ml_grad_reference(
        [f.float() for f in feats], rois, g.float(), (o, o))
    scale = max(w.abs().max().item() for w in want)
    for leaf, w in zip(leaves, want):
        err = (leaf.grad.float() - w).abs()
        bound = 1e-5 * scale
        if dtype == torch.bfloat16:
            bound = bound + 2.0 ** -8 * w.abs()
        assert bool((err <= bound).all())


def _bf16_within_ulp(got, want):
    cast = want.to(torch.bfloat16).float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(cast.abs().clamp(
        min=2.0 ** -126))) - 7)
    return bool(((got.float() - cast).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 256])
@pytest.mark.parametrize("o,sr", [(7, 0), (14, 0), (7, 1), (7, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_paths_on_card(c, o, sr, dtype):
    """K1's eight-channel path (C=256) and its two-channel one (C=2)
    against the plain version on small levels, sampling ratios 0 (s=2,
    the unrolled loop), 1 and 4: f32 within 1e-5, bf16 within one bf16
    ulp of the value after the cast. Then the same levels as views 2
    elements into their storage (an odd count of channel pairs): the
    two-channel path, with the same bits as the aligned levels'. The
    launch counters record the path of each launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from iif_torch.ops.roi_align import kernel_path
    from iif_torch.ops.roi_align_ml import reset_launches

    rng = np.random.RandomState(c + o + sr)
    feats = [torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32))
             .to("cuda", dtype) for h, w in SMALL_LEVELS]
    rois = torch.from_numpy(make_rois(rng, 64, (64, 96), (4, 96))).cuda()
    reset_launches()
    got = roi_align_ml(feats, rois, (o, o), sampling_ratio=sr)
    torch.cuda.synchronize()
    path = "vec8" if c % 8 == 0 else "pair"
    assert kernel_path(*feats, got) == path
    assert roi_align_ml.launches_by_path == {path: 1}
    want = roi_align_ml_reference(feats, rois, (o, o), sampling_ratio=sr)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _bf16_within_ulp(got, want)
    views = []
    for f in feats:
        buf = torch.empty(f.numel() + 2, dtype=dtype, device="cuda")
        views.append(buf[2:].view(f.shape))
        views[-1].copy_(f)
    again = roi_align_ml(views, rois, (o, o), sampling_ratio=sr)
    torch.cuda.synchronize()
    assert kernel_path(*views, again) == "pair"
    assert roi_align_ml.launches_by_path == (
        {"pair": 2} if path == "pair" else {"vec8": 1, "pair": 1})
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 256])
def test_k1_no_rois_on_card(c):
    """R=0 on either path: an empty (0, 7, 7, C) in the feature dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    feats = [torch.zeros(1, h, w, c, dtype=torch.bfloat16, device="cuda")
             for h, w in SMALL_LEVELS]
    got = roi_align_ml(feats, torch.zeros(0, 5, device="cuda"), (7, 7))
    torch.cuda.synchronize()
    assert got.shape == (0, 7, 7, c) and got.dtype == torch.bfloat16


@pytest.mark.parametrize("c,offset,path", [
    (256, 0, "vec8"),
    (16, 0, "vec8"),
    (2, 0, "pair"),
    (258, 0, "pair"),
    (16, 2, "pair"),                    # g 4 or 8 bytes into its storage
    (16, 8, "vec8"),                    # 16 or 32 bytes in
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_path_choice(c, offset, path, dtype):
    """K2's buffers and path (plain Python, as on the card): one f32
    accumulator for the four levels back to back, the result in the
    feature dtype (the accumulator itself for f32), g read as contiguous
    in that dtype; eight channels a thread when C % 8 == 0 and g and the
    accumulator start on 16 bytes, two otherwise."""
    from iif_torch.ops.roi_align_ml import _bwd_buffers

    buf = torch.randn(3 * 7 * 7 * c + offset).to(dtype)
    grad = buf[offset:].view(3, 7, 7, c)
    shapes = [(2, h, w, c) for h, w in SMALL_LEVELS]
    acc, out, g, got = _bwd_buffers(shapes, dtype, grad)
    total = sum(2 * h * w * c for h, w in SMALL_LEVELS)
    assert acc.shape == (total,) and acc.dtype == torch.float32
    assert out.dtype == dtype and out.shape == (total,)
    assert (out is acc) == (dtype == torch.float32)
    assert g.data_ptr() == grad.data_ptr() and g.dtype == dtype
    assert got == path


def _lvis_rois_with_pile(rng, r):
    """``make_rois`` at LVIS scale over 2 images, the whole canvas (the
    coarsest level), then a pile of 16 identical RoIs, so that many RoIs
    add into the same cells."""
    rois = make_rois(rng, r, (800, 1344), (16, 512))
    extra = np.array([[0, 0.0, 0.0, 1343.0, 799.0]]
                     + [[1, 300.5, 200.25, 420.75, 290.5]] * 16, np.float32)
    return torch.from_numpy(np.concatenate([rois, extra])).cuda()


def _k2_matches_plain(feats, rois, o, sr):
    """K2 through ``RoIAlignML`` against the plain backward, as
    ``test_k2_matches_plain_backward_on_card`` holds it."""
    rng = np.random.RandomState(o + sr)
    c, dtype = feats[0].shape[-1], feats[0].dtype
    g = torch.from_numpy(rng.randn(rois.shape[0], o, o, c).astype(
        np.float32)).to("cuda", dtype)
    leaves = [f.clone().requires_grad_() for f in feats]
    roi_align_ml(leaves, rois, (o, o), sampling_ratio=sr).backward(g)
    torch.cuda.synchronize()
    want = roi_align_ml_grad_reference(
        [f.float() for f in feats], rois, g.float(), (o, o),
        sampling_ratio=sr)
    scale = max(w.abs().max().item() for w in want)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        err = (leaf.grad.float() - w).abs()
        bound = 1e-5 * scale
        if dtype == torch.bfloat16:
            bound = bound + 2.0 ** -8 * w.abs()
        assert bool((err <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 256])
@pytest.mark.parametrize("o,sr", [(7, 0), (14, 0), (7, 1), (7, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_paths_on_card(c, o, sr, dtype):
    """K2's eight-channel path (C=256) and its two-channel one (C=2)
    against the plain backward on the LVIS levels (B=2), sampling ratios
    0 (s=2), 1 and 4, RoIs on every level and a pile of identical ones.
    The launch counters record the path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from iif_torch.ops.roi_align_ml import grad_launches_by_path, reset_launches

    rng = np.random.RandomState(c + o + sr)
    feats = [torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32))
             .to("cuda", dtype) for h, w in LVIS_LEVELS]
    rois = _lvis_rois_with_pile(rng, 64)
    assert set(map_roi_levels(rois, 4).tolist()) == {0, 1, 2, 3}
    reset_launches()
    _k2_matches_plain(feats, rois, o, sr)
    assert grad_launches_by_path == {"vec8" if c % 8 == 0 else "pair": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_no_rois_on_card(c, dtype):
    """R=0 on either path: zero gradients of the levels' shapes and
    dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    leaves = [torch.ones(1, h, w, c, dtype=dtype, device="cuda",
                         requires_grad=True) for h, w in SMALL_LEVELS]
    roi_align_ml(leaves, torch.zeros(0, 5, device="cuda"), (7, 7)).backward(
        torch.zeros(0, 7, 7, c, dtype=dtype, device="cuda"))
    torch.cuda.synchronize()
    for leaf in leaves:
        assert leaf.grad.dtype == dtype and leaf.grad.shape == leaf.shape
        assert not leaf.grad.any()
