"""Single-level RoIAlign (kernel K3's plain version, reached through
``roi_align`` on CPU tensors) against the JAX package's jitted
``iif_tpu.ops.roi_align.roi_align`` and against ``roi_align_pallas``,
which off the TPU runs that same function. The CUDA kernels K3 and its
backward K4 (through autograd, against ``roi_align_grad_reference``) run
only on the card (``cuda`` marker):

    python3 -m pytest tests/test_torch_roi_align_single.py -m cuda -q
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.ops.roi_align import (
    grad_launches_by_size,
    roi_align,
    roi_align_grad_reference,
    roi_align_reference,
)

torch.set_num_threads(1)

C4_MAP = (50, 84)                  # the C4 map of an 800x1344 canvas


def make_rois(rng, r, map_hw, scale, batch=2):
    """RoIs in image pixels for a (H, W) map at ``scale``: log-uniform
    size from a fifth of a cell to the whole map, log-uniform aspect; then
    border cases (on and past each edge), RoIs wholly outside the image,
    sub-cell RoIs (under one cell a side, for the ``aligned=False``
    clamp) and RoIs wider and taller than 32 and 40 cells (a TPU window
    would have clamped their taps)."""
    h, w = map_hw[0] / scale, map_hw[1] / scale
    cell = 1.0 / scale
    centers = rng.rand(r, 2) * [w, h]
    size = np.exp(rng.uniform(np.log(0.2 * cell), np.log(min(h, w)), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    boxes = np.stack([centers[:, 0] - bw / 2, centers[:, 1] - bh / 2,
                      centers[:, 0] + bw / 2, centers[:, 1] + bh / 2], 1)
    special = np.array([
        [0.0, 0.0, w, h],                           # the whole image
        [-3 * cell, -2 * cell, 2 * cell, 3 * cell],  # past the top left
        [w - 2 * cell, h - 3 * cell, w + 4 * cell, h + cell],
        [w + cell, h + cell, w + 5 * cell, h + 4 * cell],  # outside
        [-6 * cell, -5 * cell, -cell, -2 * cell],           # outside
        [5.1 * cell, 2.2 * cell, 5.4 * cell, 2.3 * cell],   # sub-cell
        [0.5 * cell, 0.5 * cell, 0.9 * cell, 0.6 * cell],   # sub-cell
        [0.1 * w, 0.05 * h, 0.95 * w, 0.9 * h],     # wider than 40 cells
    ])
    boxes[:len(special)] = special
    bidx = rng.randint(0, batch, r)
    return np.concatenate([bidx[:, None], boxes], 1).astype(np.float32)


def _jax(fn_name, feats, rois, out, scale, sr, aligned):
    from iif_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
    from iif_tpu.ops.roi_align import roi_align as jax_roi_align

    fn = jax_roi_align if fn_name == "roi_align" else roi_align_pallas
    got = fn(jnp.asarray(feats), jnp.asarray(rois), output_size=out,
             spatial_scale=scale, sampling_ratio=sr, aligned=aligned)
    assert got.dtype == jnp.float32
    return np.asarray(got)


def _port(feats, rois, out, scale, sr, aligned, dtype=torch.float32):
    f = torch.from_numpy(feats).to(dtype)
    got = roi_align(f, torch.from_numpy(rois), out, scale, sr, aligned)
    assert got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("jax_fn", ["roi_align", "roi_align_pallas"])
@pytest.mark.parametrize("scale", [1 / 16, 1 / 4])
@pytest.mark.parametrize("sr", [0, 1, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_plain_matches_jax_small_map(jax_fn, scale, sr, aligned):
    """f32, a 12x20 map, 14x14 bins: atol 1e-5 (measured at most 7.2e-6).
    Coordinates stay within about 25 cells, where one ulp of a sample
    position is below 2e-6 cells."""
    rng = np.random.RandomState(int(1 / scale) + sr)
    feats = rng.randn(2, 12, 20, 8).astype(np.float32)
    rois = make_rois(rng, 40, (12, 20), scale)
    want = _jax(jax_fn, feats, rois, (14, 14), scale, sr, aligned)
    got = _port(feats, rois, (14, 14), scale, sr, aligned)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("jax_fn", ["roi_align", "roi_align_pallas"])
@pytest.mark.parametrize("out", [(7, 7), (5, 9)])
@pytest.mark.parametrize("aligned", [True, False])
def test_plain_matches_jax_bf16_features(jax_fn, out, aligned):
    """bf16 features upcast exactly, so the f32 output agrees to 1e-5;
    non-square outputs included."""
    rng = np.random.RandomState(7 + out[1])
    f32 = rng.randn(2, 12, 20, 8).astype(np.float32)
    bf = jnp.asarray(f32).astype(jnp.bfloat16)
    rois = make_rois(rng, 40, (12, 20), 1 / 4)
    want = _jax(jax_fn, bf, rois, out, 1 / 4, 0, aligned)
    got = _port(f32, rois, out, 1 / 4, 0, aligned, torch.bfloat16)
    assert got.shape == (40,) + out + (8,)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("jax_fn", ["roi_align", "roi_align_pallas"])
def test_plain_matches_jax_c4_coordinates(jax_fn):
    """The C4 serving geometry: a 50x84 map at scale 1/16, 14x14, s=2,
    aligned, RoIs up to the whole map. atol 5e-5: XLA on the CPU compiles
    the bin width into a multiply by 1/14 and the sample position into a
    fused multiply-add, while the port rounds a true division and a
    separate multiply and add (the kernel's order). At 84 cells an ulp of
    a position is 8e-6 cells, times a neighbour difference of up to ~7
    for randn features; measured 1.4e-5 to 2.2e-5 over seeds 20-25 (both
    JAX functions alike)."""
    rng = np.random.RandomState(20)
    feats = rng.randn(2, 50, 84, 4).astype(np.float32)
    rois = make_rois(rng, 96, C4_MAP, 1 / 16)
    want = _jax(jax_fn, feats, rois, (14, 14), 1 / 16, 0, True)
    got = _port(feats, rois, (14, 14), 1 / 16, 0, True)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_rois(dtype):
    """R=0 gives an empty f32 (0, oh, ow, C). The JAX function cannot be
    asked: its ``reshape(r, out_h, s, out_w, s, -1)`` divides by r=0."""
    feats = np.random.RandomState(0).randn(1, 6, 8, 4).astype(np.float32)
    got = _port(feats, np.zeros((0, 5), np.float32), (14, 14), 1 / 16, 0,
                True, dtype)
    assert got.shape == (0, 14, 14, 4)


def test_unaligned_clamps_sub_cell_rois():
    """``aligned=False`` widens a box under one cell to one cell before it
    is split into bins (``ops/roi_align.py:75-77``): a 0.3-cell RoI reads
    the same as the 1-cell RoI at its corner."""
    rng = np.random.RandomState(1)
    feats = torch.from_numpy(rng.randn(1, 10, 10, 4).astype(np.float32))
    sub = torch.tensor([[0, 8.0, 12.0, 9.2, 12.4]])     # scale 1/4: 0.3 x 0.1
    one = torch.tensor([[0, 8.0, 12.0, 12.0, 16.0]])    # 1 x 1 cell
    a = roi_align(feats, sub, (2, 2), 1 / 4, 2, aligned=False)
    b = roi_align(feats, one, (2, 2), 1 / 4, 2, aligned=False)
    assert torch.equal(a, b)
    assert not torch.equal(a, roi_align(feats, sub, (2, 2), 1 / 4, 2,
                                        aligned=True))


def test_wrapper_cpu_is_plain_version():
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(rng.randn(2, 12, 20, 8).astype(np.float32))
    rois = torch.from_numpy(make_rois(rng, 16, (12, 20), 1 / 16))
    before = (dict(roi_align.launches_by_size),
              dict(roi_align.launches_by_path))
    got = roi_align(feats, rois, (14, 14), 1 / 16)
    assert torch.equal(got, roi_align_reference(feats, rois, (14, 14),
                                                1 / 16))
    assert (roi_align.launches_by_size,
            roi_align.launches_by_path) == before  # no kernel on the CPU


def test_wrapper_raises_on_other_devices():
    feats = torch.zeros(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align(feats, torch.zeros(1, 5, device="meta"))


def _k3_case(rng, batch, map_hw, channels, r, scale, dtype):
    feats = torch.from_numpy(rng.randn(batch, *map_hw, channels).astype(
        np.float32)).to("cuda", dtype)
    rois = torch.from_numpy(make_rois(rng, r, map_hw, scale, batch)).cuda()
    return feats, rois


def _chunked_reference(feats, rois, out, scale, sr, aligned, chunk=100):
    return torch.cat([roi_align_reference(feats, rois[i:i + chunk], out,
                                          scale, sr, aligned)
                      for i in range(0, rois.shape[0], chunk)])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_on_card_c4_shapes(batch, dtype):
    """K3 on the card against its plain version at the C4 serving shapes
    (50x84x1024, R = 1000 a image, 14x14, s=0, aligned): f32 output
    within 1e-5, for bf16 features too (they upcast exactly). The plain
    version runs in chunks of 100 RoIs (its corner gathers are R x 28 x
    28 x C f32 each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(batch)
    feats, rois = _k3_case(rng, batch, C4_MAP, 1024, 1000 * batch, 1 / 16,
                           dtype)
    before = roi_align.launches_by_size.get((14, 14), 0)
    got = roi_align(feats, rois, (14, 14), 1 / 16)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert roi_align.launches_by_size[(14, 14)] == before + 1
    want = _chunked_reference(feats, rois, (14, 14), 1 / 16, 0, True)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("out,sr,aligned", [((14, 14), 0, False),
                                            ((7, 7), 1, True),
                                            ((7, 7), 4, True),
                                            ((5, 9), 2, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_on_card_options(out, sr, aligned, dtype):
    """K3's other options on a small map: unaligned with sub-cell RoIs,
    sampling ratios 1 and 4, a non-square output; within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(sr + out[1])
    feats, rois = _k3_case(rng, 2, (12, 20), 64, 200, 1 / 4, dtype)
    got = roi_align(feats, rois, out, 1 / 4, sr, aligned)
    torch.cuda.synchronize()
    want = roi_align_reference(feats, rois, out, 1 / 4, sr, aligned)
    assert (got - want).abs().max().item() <= 1e-5


def _k4_matches_plain(feats, rois, out, scale, sr, aligned, chunk=128):
    """K4, run by autograd through ``roi_align``, against the plain
    backward (in chunks of RoIs, summed in f32): f32 within 1e-5 of the
    largest gradient (its atomics add in another order on every run);
    bf16 besides within 2^-8 of each value (one rounding of an f32 sum
    that may differ in its last bits)."""
    leaf = feats.clone().requires_grad_()
    g = torch.randn((rois.shape[0],) + out + (feats.shape[-1],),
                    generator=torch.Generator("cuda").manual_seed(0),
                    device="cuda")
    before = grad_launches_by_size.get(out, 0)
    roi_align(leaf, rois, out, scale, sr, aligned).backward(g)
    torch.cuda.synchronize()
    assert grad_launches_by_size[out] == before + 1
    got = leaf.grad
    assert got.dtype == feats.dtype and got.shape == feats.shape
    want = torch.zeros(feats.shape, device="cuda")
    for i in range(0, rois.shape[0], chunk):
        want += roi_align_grad_reference(feats.float(), rois[i:i + chunk],
                                         g[i:i + chunk], out, scale, sr,
                                         aligned)
    bound = 1e-5 * want.abs().max()
    if feats.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.abs()
    assert ((got.float() - want).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_on_card_c4_train_shapes(dtype):
    """K4 at the C4 training shapes: B=4, the 50x84x1024 map, R=2048
    RoIs, 14x14, s=0, aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(10)
    feats, rois = _k3_case(rng, 4, C4_MAP, 1024, 2048, 1 / 16, dtype)
    _k4_matches_plain(feats, rois, (14, 14), 1 / 16, 0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("out,sr,aligned", [((14, 14), 0, False),
                                            ((7, 7), 1, True),
                                            ((7, 7), 4, True),
                                            ((5, 9), 2, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_on_card_options(out, sr, aligned, dtype):
    """K4's other options on a small map, as K3's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(20 + sr + out[1])
    feats, rois = _k3_case(rng, 2, (12, 20), 64, 200, 1 / 4, dtype)
    _k4_matches_plain(feats, rois, out, 1 / 4, sr, aligned)


def _strided_copy(t, offset):
    """``t`` as a contiguous view that starts ``offset`` elements into its
    storage."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("c,dtype,offset,path", [
    (16, torch.float32, 0, "vec8"),
    (16, torch.bfloat16, 0, "vec8"),
    (1024, torch.bfloat16, 0, "vec8"),
    (6, torch.float32, 0, "pair"),
    (258, torch.bfloat16, 0, "pair"),
    (16, torch.float32, 2, "pair"),      # 8 bytes in
    (16, torch.bfloat16, 2, "pair"),     # 4 bytes in
    (16, torch.float32, 4, "vec8"),      # 16 bytes in
    (16, torch.bfloat16, 8, "vec8"),     # 16 bytes in
])
def test_kernel_path_choice(c, dtype, offset, path):
    """The wrappers' choice between the forward kernels' two
    instantiations (plain Python, as on the card): eight channels a thread
    when C % 8 == 0 and the map and the output start on 16 bytes, two
    otherwise; a misaligned output alone sends it to the pair path."""
    from iif_torch.ops.roi_align import kernel_path

    feats = _strided_copy(torch.zeros(2, 3, 4, c, dtype=dtype), offset)
    out = torch.empty(5, 7, 7, c)
    assert feats.is_contiguous()
    assert kernel_path(feats, out) == path
    assert kernel_path(feats, _strided_copy(out, 2)) == "pair"


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 6, 258, 1024])
@pytest.mark.parametrize("out,sr,aligned", [((14, 14), 0, True),
                                            ((7, 7), 1, False),
                                            ((7, 7), 4, True),
                                            ((5, 9), 2, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_paths_on_card(c, out, sr, aligned, dtype):
    """K3's eight-channel path (C=1024) and its two-channel one (C = 2, 6,
    258) against the plain version on a small map: sampling ratios 0
    (s=2, the unrolled loop), 1 and 4, 7x7, 14x14 and non-square bins,
    aligned or not; within 1e-5. The launch counters record the path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from iif_torch.ops.roi_align import kernel_path, reset_launches

    rng = np.random.RandomState(c + sr)
    feats, rois = _k3_case(rng, 2, (12, 20), c, 64, 1 / 4, dtype)
    reset_launches()
    got = roi_align(feats, rois, out, 1 / 4, sr, aligned)
    torch.cuda.synchronize()
    path = "vec8" if c % 8 == 0 else "pair"
    assert kernel_path(feats, got) == path
    assert roi_align.launches_by_path == {path: 1}
    want = roi_align_reference(feats, rois, out, 1 / 4, sr, aligned)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_offset_view_on_card(dtype):
    """A map that is a view into its storage: 2 elements in (an odd count
    of channel pairs, so not 16-byte aligned) takes the two-channel path,
    16 bytes in the eight-channel one; both give the aligned map's bits,
    since each channel's sums run in the same order on either path. One
    element in is not pair-aligned and raises, as it always did."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from iif_torch.ops.roi_align import kernel_path

    rng = np.random.RandomState(30)
    feats, rois = _k3_case(rng, 2, C4_MAP, 64, 300, 1 / 16, dtype)
    want = roi_align(feats, rois, (14, 14), 1 / 16)
    assert kernel_path(feats, want) == "vec8"
    for offset, path in ((2, "pair"), (16 // feats.element_size(), "vec8")):
        view = _strided_copy(feats, offset)
        got = roi_align(view, rois, (14, 14), 1 / 16)
        torch.cuda.synchronize()
        assert kernel_path(view, got) == path
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="aligned to a channel pair"):
        roi_align(_strided_copy(feats, 1), rois, (14, 14), 1 / 16)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 1024])
def test_k3_no_rois_on_card(c):
    """R=0 on either path: an empty f32 (0, 14, 14, C), no launch
    failure."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    feats = torch.zeros(1, 6, 8, c, dtype=torch.bfloat16, device="cuda")
    got = roi_align(feats, torch.zeros(0, 5, device="cuda"), (14, 14), 1 / 16)
    torch.cuda.synchronize()
    assert got.shape == (0, 14, 14, c) and got.dtype == torch.float32


@pytest.mark.parametrize("c,offset,path", [
    (1024, 0, "vec8"),
    (16, 0, "vec8"),
    (6, 0, "pair"),
    (258, 0, "pair"),
    (16, 2, "pair"),                    # g 8 bytes into its storage
    (16, 4, "vec8"),                    # 16 bytes in
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_path_choice(c, offset, path, dtype):
    """K4's buffers and path (plain Python, as on the card): g is read as
    contiguous f32, whatever the gradient's dtype; eight channels a
    thread when C % 8 == 0 and g and the accumulator start on 16 bytes,
    two otherwise. A gradient that is an offset view already contiguous
    in f32 is read in place, so its offset decides."""
    from iif_torch.ops.roi_align import _bwd_buffers

    grad = _strided_copy(torch.randn(3, 7, 7, c).to(dtype), offset)
    acc, g, got = _bwd_buffers((2, 5, 6, c), grad)
    assert acc.shape == (2, 5, 6, c) and acc.dtype == torch.float32
    assert g.dtype == torch.float32 and g.is_contiguous()
    assert torch.equal(g, grad.float())
    want = path if dtype == torch.float32 else (
        "vec8" if c % 8 == 0 else "pair")   # a bf16 g is copied to f32
    assert got == want


def _k4_case_rois(rng, map_hw, scale, r, batch=2):
    """``make_rois``'s (the whole map, border, outside, sub-cell and
    wider-than-40-cell RoIs) plus a zero-size RoI, one with x2 < x1 and
    y2 < y1, a pile of 16 identical RoIs and a pile of 16 sub-cell RoIs
    inside one cell."""
    rois = make_rois(rng, r, map_hw, scale, batch)
    cell = 1.0 / scale
    extra = [[0, 3 * cell, 2 * cell, 3 * cell, 2 * cell],
             [1, 6.5 * cell, 4.5 * cell, 2.5 * cell, 1.5 * cell]]
    extra += [[1, 2.2 * cell, 1.4 * cell, 9.7 * cell, 6.1 * cell]] * 16
    x0, y0 = 4 * cell + rng.uniform(0, 0.5 * cell, (2, 16))
    extra += [[0, a, b, a + 0.4 * cell, b + 0.3 * cell]
              for a, b in zip(x0, y0)]
    return torch.from_numpy(np.concatenate(
        [rois, np.array(extra, np.float32)])).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 258, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_paths_on_card(c, dtype):
    """K4's two-channel path (C = 6, 258) and its eight-channel one
    (C=1024) against the plain backward, through autograd, on RoIs with
    piles of identical and of sub-cell RoIs, zero-size, reversed, outside
    and whole-map ones: as ``_k4_matches_plain``. The launch counters
    record the path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from iif_torch.ops.roi_align import grad_launches_by_path, reset_launches

    rng = np.random.RandomState(40 + c)
    feats = torch.from_numpy(rng.randn(2, 12, 20, c).astype(
        np.float32)).to("cuda", dtype)
    rois = _k4_case_rois(rng, (12, 20), 1 / 4, 64)
    reset_launches()
    _k4_matches_plain(feats, rois, (14, 14), 1 / 4, 0, True)
    assert grad_launches_by_path == {"vec8" if c % 8 == 0 else "pair": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_offset_grad_view_on_card(dtype):
    """A gradient that is a view 2 elements into its storage (an odd count
    of channel pairs) takes K4's two-channel path, 4 elements in (16
    bytes) the eight-channel one; both agree with the plain backward as
    in ``_k4_matches_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from iif_torch.ops.roi_align import (
        _launch_bwd,
        grad_launches_by_path,
        reset_launches,
    )

    rng = np.random.RandomState(50)
    rois = _k4_case_rois(rng, C4_MAP, 1 / 16, 200)
    shape = (2, *C4_MAP, 64)
    g = torch.from_numpy(rng.randn(rois.shape[0], 14, 14, 64).astype(
        np.float32)).cuda()
    want = sum(roi_align_grad_reference(
        torch.zeros(shape, device="cuda"), rois[i:i + 128], g[i:i + 128],
        (14, 14), 1 / 16) for i in range(0, rois.shape[0], 128))
    bound = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.abs()
    for offset, path in ((2, "pair"), (4, "vec8")):
        reset_launches()
        got = _launch_bwd(shape, dtype, rois, _strided_copy(g, offset), 14,
                          14, 2, 1 / 16, True)
        torch.cuda.synchronize()
        assert grad_launches_by_path == {path: 1}
        assert got.dtype == dtype and got.shape == shape
        assert ((got.float() - want).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 1024])
def test_k4_no_rois_on_card(c):
    """R=0 on either path: a zero gradient of the map's shape and dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    leaf = torch.ones(1, 6, 8, c, dtype=torch.bfloat16, device="cuda",
                      requires_grad=True)
    roi_align(leaf, torch.zeros(0, 5, device="cuda"), (14, 14),
              1 / 16).backward(torch.zeros(0, 14, 14, c, device="cuda"))
    torch.cuda.synchronize()
    assert leaf.grad.dtype == torch.bfloat16
    assert leaf.grad.shape == leaf.shape
    assert not leaf.grad.any()
