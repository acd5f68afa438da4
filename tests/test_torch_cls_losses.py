"""The classification losses of the port against ``iif_tpu`` on the CPU:
the IIF weights of all seven variants with ``iif_norm`` 0, 1 and 2 (equal
bit for bit), every criterion with and without deferred re-weighting
(rtol 1e-6) and mixup's own draw (mixup on JAX's draw is in
``tests/test_torch_cls_trainer.py``, beside the step that uses it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

COUNTS = [500, 320, 200, 125, 80, 50, 31, 20, 12, 5]


@pytest.mark.parametrize("norm", [0, 1, 2])
@pytest.mark.parametrize("variant", ["raw", "smooth", "rel", "normit",
                                     "gombit", "base2", "base10"])
def test_iif_weights_equal(variant, norm):
    from iif_tpu.losses.iif import compute_iif_weights as jax_weights

    from iif_torch.losses.iif import compute_iif_weights

    got = compute_iif_weights(COUNTS, variant, norm)
    want = np.asarray(jax_weights(COUNTS, variant, norm))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


CRITERIA = [("iif", False, {}), ("iif", True, {}), ("iif", False,
            {"iif_variant": "smooth", "reduction": "sum"}),
            ("ce", False, {}), ("ce", True, {}), ("ce", True,
                                                 {"reduction": "sum"}),
            ("bce", False, {}), ("bce", True, {"reduction": "sum"}),
            ("focal_loss", False, {"gamma": 2.0, "alpha": 0.25}),
            ("focal_loss", True, {"gamma": 1.0})]


@pytest.mark.parametrize("classif,deferred,kw", CRITERIA,
                         ids=lambda v: str(v))
def test_criteria_match_jax(classif, deferred, kw):
    """Each criterion of ``get_criterion`` on the same f32 logits, and on
    bf16-rounded ones (the step casts the logits to f32 first; here the
    criterion casts)."""
    from iif_tpu.losses import get_criterion as jax_criterion

    from iif_torch.losses import get_criterion

    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(16, 10)).astype(np.float32)
    y = rng.randint(0, 10, 16)
    want_fn = jax_criterion(classif, COUNTS, deferred=deferred, **kw)
    got_fn = get_criterion(classif, COUNTS, deferred=deferred, **kw)
    want = jax.jit(lambda a, b: want_fn(a, b))(jnp.asarray(logits),
                                               jnp.asarray(y))
    got = got_fn(torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if classif == "iif":
        np.testing.assert_array_equal(
            got_fn.transform(torch.from_numpy(logits)).numpy(),
            np.asarray(want_fn.transform(jnp.asarray(logits))))
        assert got_fn.iif and not hasattr(get_criterion("ce", COUNTS), "iif")


def test_port_mixup_draw():
    """The port's own draw: a permutation, lambda in [0, 1] and an f32
    value with Beta(a, a)'s mean 1/2 and variance 1 / (4 (2a + 1)) over
    4000 draws (a = 0.2 and 1.0), the same from the same seeds, and
    lambda 1 for alpha 0."""
    from iif_torch.losses.mixup import sample_mixup

    for alpha in (0.2, 1.0):
        rng, g = np.random.RandomState(0), torch.Generator().manual_seed(0)
        lams = np.array([sample_mixup(rng, g, 4, alpha)[0]
                         for _ in range(4000)])
        assert ((lams >= 0) & (lams <= 1)).all()
        assert (lams.astype(np.float32) == lams).all()
        assert abs(float(lams.mean()) - 0.5) < 0.02
        var = 1.0 / (4.0 * (2.0 * alpha + 1.0))
        assert abs(float(lams.var()) / var - 1.0) < 0.08

    def draw():
        return sample_mixup(np.random.RandomState(5),
                            torch.Generator().manual_seed(5), 9, 0.2)

    a, b = draw(), draw()
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert sorted(a[1].tolist()) == list(range(9))
    assert sample_mixup(np.random.RandomState(0), torch.Generator(), 3,
                        0.0)[0] == 1.0
