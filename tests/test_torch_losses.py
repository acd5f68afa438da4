"""Detection IIF loss against the JAX package: weights of every variant,
the CSV loader, the inference activation and the training loss."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection.losses import (
    DET_IIF_VARIANTS,
    DetCrossEntropyLoss,
    DetIIFLoss,
    compute_det_iif_from_counts,
    load_iif_csv,
)

torch.set_num_threads(1)


def _counts(rng, c=40):
    """Long-tailed per-class image counts, 1 to 10^4."""
    return np.round(np.exp(rng.uniform(0, np.log(1e4), c))).astype(int)


@pytest.mark.parametrize("variant", list(DET_IIF_VARIANTS) + ["raw_obj"])
def test_weights_and_activation_match_jax(variant):
    """Weights and softmax(score x weights): rtol 1e-6."""
    from iif_tpu.detection.losses import DetIIFLoss as JaxLoss
    from iif_tpu.detection.losses import (
        compute_det_iif_from_counts as jax_weights,
    )

    rng = np.random.RandomState(len(variant))
    counts = _counts(rng)
    total = 100170 if not variant.endswith("_obj") else int(counts.sum())
    w = compute_det_iif_from_counts(counts, total, variant)
    jw = np.asarray(jax_weights(counts, total, variant))
    np.testing.assert_allclose(w, jw, rtol=1e-6)
    assert w.dtype == np.float32 and w[-1] == 1.0

    score = rng.randn(16, len(w)).astype(np.float32)
    got = DetIIFLoss(w).get_activation(torch.from_numpy(score)).numpy()
    want = np.asarray(JaxLoss(jnp.asarray(jw)).get_activation(
        jnp.asarray(score)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_unknown_variant_raises():
    with pytest.raises(ValueError):
        compute_det_iif_from_counts([1, 2], 10, "cubic")


def test_loss_matches_jax():
    """CE(score x weights, label), mean and weighted: rtol 1e-6."""
    from iif_tpu.detection.losses import DetIIFLoss as JaxLoss

    rng = np.random.RandomState(0)
    w = compute_det_iif_from_counts(_counts(rng, 9), 100170)
    score = rng.randn(32, 10).astype(np.float32)
    labels = rng.randint(0, 10, 32)
    sw = rng.rand(32).astype(np.float32)
    tl, jl = DetIIFLoss(w), JaxLoss(jnp.asarray(w))
    for kw_t, kw_j in (({}, {}),
                       ({"weight": torch.from_numpy(sw)},
                        {"weight": jnp.asarray(sw)})):
        got = tl(torch.from_numpy(score), torch.from_numpy(labels), **kw_t)
        want = jl(jnp.asarray(score), jnp.asarray(labels), **kw_j)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_csv_loader_matches_jax(tmp_path):
    """Reference-format CSV: row 0 dropped, background 1.0 appended."""
    from iif_tpu.detection.losses import load_iif_csv as jax_load

    rng = np.random.RandomState(1)
    path = tmp_path / "idf.csv"
    cols = {v: compute_det_iif_from_counts(_counts(rng, 12), 100170, v)[:-1]
            for v in ("raw", "smooth")}
    rows = ["raw,smooth", "0.0,0.0"] + [
        f"{float(a)!r},{float(b)!r}"
        for a, b in zip(cols["raw"], cols["smooth"])]
    path.write_text("\n".join(rows) + "\n")
    for v in cols:
        got = load_iif_csv(str(path), v)
        np.testing.assert_array_equal(got, jax_load(str(path), v))
        assert got.shape == (13,) and got[-1] == 1.0


def test_cross_entropy_activation_matches_jax():
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE

    score = np.random.RandomState(2).randn(8, 6).astype(np.float32)
    got = DetCrossEntropyLoss(5).get_activation(torch.from_numpy(score))
    want = JaxCE(5).get_activation(jnp.asarray(score))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert not DetCrossEntropyLoss.custom_activation
    assert DetIIFLoss.custom_activation
