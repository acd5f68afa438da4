"""The classification optimizers of the port (``build_optimizer``: sgd,
nesterov, rmsprop, adamw) against ``iif_tpu``'s optax chains on the CPU:
five steps on the same gradients under a rate that changes every step,
with and without a trainable mask (the frozen tensor gets neither
gradient nor decay), and the unknown name's error.

Tolerance (measured, then set): the parameters (up to 3.6 in size)
after each step within 2.4e-7 of JAX's, one f32 ulp of the largest (atol
5e-7): optax computes in the same order, but XLA fuses multiply-adds
where the port rounds each product, and torch's SGD adds ``alpha * x``
in one fused step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NAMES = ("sgd", "nesterov", "rmsprop", "adamw")
STEPS = 5
MOMENTUM, WD = 0.9, 0.05
TOL = 5e-7


def _schedule(step):
    """JAX's ``0.02 * (1 + count)`` in f32."""
    return float(np.float32(0.02) * np.float32(1 + step))


def _case(seed=0):
    rng = np.random.RandomState(seed)
    params = {"conv": rng.randn(3, 2, 3, 3).astype(np.float32),
              "head": rng.randn(4, 5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name, masked):
    from iif_tpu.engine.schedules import build_optimizer as jax_build

    from iif_torch.engine.schedules import build_optimizer

    params, grads = _case()
    mask = {"conv": not masked, "head": True}
    tx = jax_build(name, lambda count: 0.02 * (1 + count), MOMENTUM, WD,
                   trainable_mask=mask if masked else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    for k, m in mask.items():
        tp[k].requires_grad_(m)
    opt, sched = build_optimizer(name, tp.values(), _schedule, MOMENTUM, WD)
    update = jax.jit(tx.update)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, state = update(jg, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]) if p.requires_grad else None
        opt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=TOL, err_msg=(name, k))
    if masked:
        np.testing.assert_array_equal(tp["conv"].detach().numpy(),
                                      params["conv"])
    assert not np.array_equal(tp["head"].detach().numpy(), params["head"])


def test_unknown_optimizer_raises_as_jax():
    from iif_torch.engine.schedules import build_optimizer

    with pytest.raises(ValueError, match="Invalid optimizer adagrad"):
        build_optimizer("adagrad", [torch.nn.Parameter(torch.zeros(2))],
                        _schedule)
