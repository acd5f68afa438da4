"""The port's weight converter against the JAX package's: a torch-named
state_dict -> ``convert_mmdet_maskrcnn`` (JAX) -> ``maskrcnn_state_from_jax``
must give back the original exactly. Also hosts the seeded state_dict
helper the other ``test_torch_*`` files share."""
import numpy as np
import torch

from iif_torch.detection.convert import maskrcnn_state_from_jax
from iif_torch.detection.detector import MaskRCNN

torch.set_num_threads(1)


def random_mmdet_state(model: torch.nn.Module, rng: np.random.RandomState
                       ) -> dict:
    """Seeded numpy values for EVERY parameter and buffer of ``model``
    (incl. the residual ``bn3`` scale the JAX init sets to zero), at
    scales that keep a deep trunk finite: normal(0, 1/sqrt(fan_in))
    weights, BN scale in [0.5, 1] ([0.1, 0.3] for bn3), small shifts."""
    out = {}
    for name, t in model.state_dict().items():
        *mods, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            v = np.zeros(shape, np.int64)
        elif any(m.startswith("bn") for m in mods) or "downsample.1" in name:
            if leaf == "weight":
                lo, hi = (0.1, 0.3) if ".bn3" in name else (0.5, 1.0)
                v = rng.uniform(lo, hi, shape)
            elif leaf == "running_var":
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = rng.normal(0.0, 0.1, shape)
        elif leaf == "bias":
            v = rng.normal(0.0, 0.01, shape)
        else:
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        out[name] = v.astype(np.int64 if leaf == "num_batches_tracked"
                             else np.float32)
    return out


def jax_variables(state: dict) -> dict:
    """The same weights as ``iif_tpu`` MaskRCNN variables, through the JAX
    package's own converter (no ``model.init``)."""
    from iif_tpu.detection.pretrained_det import convert_mmdet_maskrcnn

    params, stats = convert_mmdet_maskrcnn(state)
    return {"params": params, "batch_stats": stats}


def test_converter_round_trip_is_exact():
    model = MaskRCNN(num_classes=7, depth=50)
    state = random_mmdet_state(model, np.random.RandomState(0))
    v = jax_variables(state)
    back = maskrcnn_state_from_jax(v["params"], v["batch_stats"])
    assert set(back) == set(state)
    for k, a in state.items():
        b = back[k].numpy()
        assert b.shape == a.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    # the result loads into the port under strict name matching
    model.load_state_dict(back)


def test_converter_covers_every_jax_leaf():
    """The JAX variables built from the converter have exactly the leaves
    (and shapes) ``MaskRCNN.init`` creates, so no test needs an init."""
    import jax
    import jax.numpy as jnp

    from iif_tpu.detection.detector import MaskRCNN as JaxMaskRCNN

    state = random_mmdet_state(MaskRCNN(num_classes=7, depth=50),
                               np.random.RandomState(1))
    v = jax_variables(state)
    ref = jax.eval_shape(
        lambda: JaxMaskRCNN(num_classes=7, depth=50).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))
    got = jax.tree_util.tree_map(lambda a: a.shape, v)
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(ref))
    assert got == want
