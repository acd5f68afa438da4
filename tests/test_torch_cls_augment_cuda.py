"""The augmentation policies on the card against the same functions on
the CPU on the same draws (``cuda``-marked; they skip without a card):
every op of ``iif_torch/data/autoaugment.py`` at levels 0, 4 and 9, a
drawn sub-policy of each policy, RandAugment, each OneOf branch, cutout
and random erasing, on a (16, 48, 48, 3) batch of k/255 values.

Tolerances, as ``chip_smoke.py``'s augmentation phase states them: the
elementwise and integer ops (color, posterize, solarize, brightness,
autocontrast, equalize, invert, identity) equal; contrast and sharpness
(a reduction, a convolution) within 2e-6; a warp within 2e-6 but for
pixels whose source point lies within 1e-4 of the image's edge; a
composition with no more than 0.1% of its elements beyond 2e-6 and
0.01% beyond one grey level (a pixel turned grey on one device only, a
truncation to the 256-level grid one level apart).

This file imports nothing from ``tests.*``: the card's Python has a
site-packages ``tests`` package that shadows the repo's."""
import pytest
import torch

EXACT = ("color", "posterize", "solarize", "brightness", "autocontrast",
         "equalize", "invert", "identity")
TOL = 2e-6
SHAPE = (16, 48, 48, 3)


def _card():
    """Skips without a card; else full f32 on it, as the port's entry
    points set it (TF32 would round the convolutions of sharpness and the
    motion blur to 10-bit mantissas)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ops run there against the CPU")
    from iif_torch.device import resolve_device

    resolve_device("cuda")


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, SHAPE, generator=g).float() / 255.0
    return x.cuda(), x


def _cpu(draw):
    if isinstance(draw, dict):
        return {k: _cpu(v) for k, v in draw.items()}
    if isinstance(draw, list):
        return [_cpu(v) for v in draw]
    return draw.cpu() if isinstance(draw, torch.Tensor) else draw


def _hold_composed(got, want, what):
    d = (got.cpu() - want).abs()
    n = d.numel()
    assert int((d > TOL).sum()) <= 1e-3 * n, what
    assert int((d > 1 / 255 + TOL).sum()) <= 1e-4 * n, what


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 4, 9])
def test_ops_on_card_equal_the_cpu(level):
    _card()
    from iif_torch.data import autoaugment as P

    x, xc = _batch(level)
    gen = torch.Generator(device="cuda").manual_seed(level)
    for name, op in P.OPS.items():
        sign = P.draw_signs(gen, SHAPE[0], "cuda")
        got = op(x, level, sign).cpu()
        want = op(xc, level, sign.cpu())
        d = (got - want).abs()
        if name in EXACT:
            assert torch.equal(got, want), name
        elif name in P.WARPS:
            near = P.near_boundary(P.warp_matrix(
                name, SHAPE[1], SHAPE[2], level, sign), SHAPE[1],
                SHAPE[2]).cpu()
            assert float(d[~near].max()) <= TOL, name
        else:
            assert float(d.max()) <= TOL, name


@pytest.mark.cuda
def test_policies_branches_cutout_and_erasing_on_card():
    _card()
    from iif_torch.data import augment as A
    from iif_torch.data import autoaugment as P
    from iif_torch.data import branch_augment as BA

    x, xc = _batch(3)
    b, h, w, _ = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    for key, policy in P.POLICIES.items():
        for index in range(len(policy)):
            draw = P.draw_policy(gen, b, policy, "cuda", index=index)
            _hold_composed(P.apply_policy(x, draw, policy),
                           P.apply_policy(xc, _cpu(draw), policy),
                           (key, index))
    draw = P.draw_randaugment(gen, b, "cuda")
    _hold_composed(P.randaugment(x, draw), P.randaugment(xc, _cpu(draw)),
                   "randaugment")
    for i in range(BA.N_BRANCHES):
        draw = BA.draw_one_of(gen, b, h, w, "cuda", index=i)
        _hold_composed(BA.one_of_augment(x, draw),
                       BA.one_of_augment(xc, _cpu(draw)), ("oneof", i))
    draw = A.draw_cutout(gen, b, h, w, "cuda", n_holes=2)
    assert torch.equal(A.cutout(x, draw, 16).cpu(),
                       A.cutout(xc, _cpu(draw), 16))
    draw = A.draw_random_erasing(gen, SHAPE, torch.float32, "cuda", 0.5)
    assert torch.equal(A.random_erasing(x, draw).cpu(),
                       A.random_erasing(xc, _cpu(draw)))
