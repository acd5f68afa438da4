"""The ten branches of the OneOf augmentation (``--auto-augment oneof``),
cutout and random erasing of the port against ``iif_tpu`` on the CPU, on
JAX's draws (the tests repeat JAX's key splits with ``jax.random``; the
branches with "rbg" keys, cheaper to compile). The OneOf pipelines are
held in ``tests/test_torch_cls_autoaugment.py``.

Tolerances (measured, then set): each branch within 1.2e-6 (atol 2e-6;
its warps as ``tests/test_torch_cls_autoaugment.py`` holds them, none of
this batch's pixels on the edge); cutout and random erasing equal.
JAX's programs compile at XLA's backend optimisation level 0
(``jax_run``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
B, H, W = 4, 16, 20
TOL = 2e-6


def jax_run(fn, *args):
    """``fn`` jitted and run, compiled with FAST."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _tree(x):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)),
                                  x)


def _u(key, shape, lo, hi):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _noise(key, shape):
    k1, k2 = jax.random.split(key)
    return {"scale": _u(k1, (shape[0], 1, 1, 1), 0.0, 15.0 / 255.0),
            "noise": jax.random.normal(k2, shape)}


def _multiply(key, b, mul=(0.5, 1.5), add=(-30 / 255, 30 / 255)):
    k1, k2 = jax.random.split(key)
    return {"m": _u(k1, (b, 1, 1, 1), *mul), "a": _u(k2, (b, 1, 1, 1), *add)}


def _cutout(key, b, h, w, n_holes):
    cy, cx = [], []
    for hole in range(n_holes):
        ky, kx = jax.random.split(jax.random.fold_in(key, hole))
        cy.append(jax.random.randint(ky, (b,), 0, h))
        cx.append(jax.random.randint(kx, (b,), 0, w))
    return {"cy": jnp.stack(cy), "cx": jnp.stack(cx)}


def _translate(key, b, h, w, fy=0.0, fx=0.0):
    ky, kx = jax.random.split(key)
    return {"ty": _u(ky, (b,), -fy, fy) * h, "tx": _u(kx, (b,), -fx, fx) * w}


def _scale(key, b, lo, hi):
    kx, ky = jax.random.split(key)
    return {"sx": _u(kx, (b,), lo, hi), "sy": _u(ky, (b,), lo, hi)}


def branch_draw(index, k, shape):
    """Branch ``index``'s draws from its key ``k``, as ``_branches`` and
    its primitives split it; the port's keys."""
    b, h, w, _ = shape
    k1, k2, k3 = jax.random.split(k, 3)
    flip = lambda key: jax.random.bernoulli(key, 0.5, (b,))  # noqa: E731
    if index == 0:
        return {"contrast": _u(k1, (b, 1, 1, 1), 0.75, 1.25),
                "flip": flip(k2),
                "hue": _u(jax.random.split(k3, 4)[3], (b, 1, 1),
                          -50.0 / 255.0, 50.0 / 255.0)}
    if index == 1:
        return {"gray": _u(k1, (b, 1, 1, 1), 0.1, 0.3), "flip": flip(k2),
                **_translate(k3, b, h, w, fy=0.15)}
    if index == 2:
        return {"horiz": flip(k1), "contrast": _u(k2, (b, 1, 1, 1), 0.6, 1.4),
                "deg": _u(k3, (b,), -10.0, 10.0)}
    if index == 3:
        return {**_noise(k1, shape), **_multiply(k2, b),
                "deg": _u(k3, (b,), -10.0, 10.0)}
    if index == 4:
        return {"cutout": _cutout(k1, b, h, w, 2),
                **_multiply(k2, b, (0.8, 1.2), (0.0, 0.0)), "flip": flip(k3)}
    if index == 5:
        return {**_multiply(k1, b), "contrast": _u(k2, (b, 1, 1, 1), 0.6, 1.4),
                **_translate(k3, b, h, w, fx=0.25)}
    if index == 6:
        return {"cutout": _cutout(k1, b, h, w, 3), **_noise(k2, shape),
                **_scale(k3, b, 0.9, 1.1)}
    if index == 7:
        ka, kb, _ = jax.random.split(k1, 3)
        return {"p": _u(ka, (b, 1, 1), 0.0, 0.05),
                "grid": jax.random.uniform(kb, (b, max(h // 8, 1),
                                                max(w // 8, 1))),
                **_noise(k2, shape), **_scale(k3, b, 0.8, 1.2)}
    return {}


def _images(seed=0, shape=(B, H, W, 3)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, shape) / 255.0).astype(np.float32)


def test_each_branch_on_jax_draws():
    """The ten branches of ``_branches`` on one batch and key, in one
    program, against ``apply_branch`` on JAX's draws; ``coarse_dropout``
    drops cells (its nearest upsampling with half-pixel centres)."""
    from iif_tpu.data import branch_augment as jb

    from iif_torch.data import branch_augment as P

    x = _images(shape=(B, 40, 40, 3))
    key = jax.random.key(4, impl="rbg")

    def run(k, v):
        return ([br((k, v)) for br in jb._branches(k, v)],
                [branch_draw(i, k, v.shape) for i in range(P.N_BRANCHES)])

    want, draws = jax_run(run, key, jnp.asarray(x))
    draws = _tree(draws)
    assert len(want) == P.N_BRANCHES
    for i, d in enumerate(draws):
        got = P.apply_branch(torch.from_numpy(x), i, d).numpy()
        np.testing.assert_allclose(got, np.asarray(want[i]), rtol=0,
                                   atol=TOL, err_msg=f"branch {i}")
    assert bool((draws[7]["grid"] < draws[7]["p"]).any())


def test_cutout_and_random_erasing_on_jax_draws():
    """``cutout`` (two holes, grey fill, side 5: the clipped squares) and
    ``random_erasing`` (prob 0.9: the area, the log-ratio, the truncated
    sides and offsets, the noise) on JAX's draws: equal."""
    from iif_tpu.data import augment as ja

    from iif_torch.data import augment

    x = _images(2, (6, 12, 14, 3))
    kc, ke = (jax.random.key(s, impl="rbg") for s in (8, 9))

    def run(kc, ke, v):
        k1, k2, k3, k4, k5, k6 = jax.random.split(ke, 6)
        erase = {"apply": jax.random.bernoulli(k1, 0.9, (6,)),
                 "scale": _u(k2, (6,), 0.02, 0.33),
                 "log_r": _u(k3, (6,), jnp.log(0.3), jnp.log(3.3)),
                 "uy": jax.random.uniform(k4, (6,)),
                 "ux": jax.random.uniform(k5, (6,)),
                 "noise": jax.random.normal(k6, v.shape, v.dtype)}
        return (ja.cutout(kc, v, length=5, n_holes=2, fill=0.5),
                ja.random_erasing(ke, v, prob=0.9),
                _cutout(kc, 6, 12, 14, 2), erase)

    wc, we, dc, de = _tree(jax_run(run, kc, ke, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(augment.cutout(xt, dc, 5, 0.5).numpy(),
                                  wc.numpy())
    np.testing.assert_array_equal(augment.random_erasing(xt, de).numpy(),
                                  we.numpy())
    assert bool(de["apply"].any()) and not np.array_equal(we.numpy(), x)
