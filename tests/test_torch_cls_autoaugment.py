"""The AutoAugment / RandAugment ops and policies and the two training
pipelines of the port against ``iif_tpu`` on the CPU, on JAX's draws (the
tests repeat JAX's key splits with ``jax.random``).

Tolerances (measured on a (3, 12, 10, 3) batch of k/255 values, then
set):

- solarize, brightness, autocontrast, invert, identity: equal;
- color, posterize, contrast, sharpness: 1.8e-7 (atol 3e-7): XLA
  multiplies by 1/255 where the source divides and fuses multiply-adds;
- equalize: the jitted JAX step ``(sum - hist[255]) / 255`` becomes a
  multiply by the reciprocal, one ulp above the quotient, which moves
  LUT entries on the ``+ 0.5`` truncation by one grey level (585 of 1080
  elements here), and its last ``/ 255`` by an ulp; the port divides as
  the source reads, as JAX's eager (unjitted) equalize does, and equals
  a NumPy transcription of it bit for bit;
- the warps: 1.1e-6 (atol 2e-6) but for pixels whose source point lies
  within 1e-4 of the image's edge, where a rounding moves it between the
  image and the grey fill (none here; counted);
- the policies and pipelines: their ops' tolerances.

JAX's programs compile at XLA's backend optimisation level 0
(``jax_run``), which halves their compile time here and moves results by
an ulp at most.

JAX picks a policy's sub-policy with ``lax.switch``, whose tracing of
all 25 branches costs 6-10 s a policy here; the port draws that pick on
the host from a stream of its own. ``_apply_policy``'s draw logic, the
pick included, is held on a two-sub-policy list with the real
``lax.switch``; the tables are compared verbatim; the pipelines run with
``jax.lax.switch`` replaced, in the test, by a call of a set sub-policy
(the same on both sides), on JAX's per-image draws, with "rbg" keys
(cheaper to compile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

LEVELS = (0, 4, 9)
EXACT = ("solarize", "brightness", "autocontrast", "invert", "identity")
ULP_OPS = ("color", "posterize", "contrast", "sharpness")
PHOTO_TOL = 3e-7
WARP_TOL = 2e-6


FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def jax_run(fn, *args):
    """``fn`` jitted and run, compiled with FAST."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _t(x):
    return torch.from_numpy(np.array(x))


def _grid_images(b=3, h=12, w=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (b, h, w, 3)) / 255.0).astype(np.float32)


def _hold_warp(got, want, mats, h, w):
    """Within WARP_TOL outside the pixels near the edge; returns how many
    near-edge pixels differ more."""
    from iif_torch.data.autoaugment import near_boundary

    near = near_boundary(mats, h, w).numpy()[..., None]
    d = np.abs(got - want)
    assert np.where(near, 0.0, d).max() <= WARP_TOL
    return int(((d > WARP_TOL) & near).any(-1).sum())


def test_ops_match_jax_at_three_levels():
    """The 15 ops of ``_OPS`` at levels 0, 4 and 9 on JAX's signs."""
    from iif_tpu.data import autoaugment as ja

    from iif_torch.data import autoaugment as P

    x = _grid_images()
    b, h, w, _ = x.shape
    key = jax.random.PRNGKey(0)
    names = list(ja._OPS)
    assert names == list(P.OPS)
    want, heads = jax_run(lambda k, v: (
        [ja._OPS[n](k, v, lvl) for n in names for lvl in LEVELS],
        jax.random.bernoulli(k, 0.5, (b,))), key, jnp.asarray(x))
    sign = torch.where(_t(heads), 1.0, -1.0)      # JAX's ``_signs(key)``
    i, edge = 0, 0
    for name in names:
        for lvl in LEVELS:
            got = P.OPS[name](_t(x), lvl, sign).numpy()
            ref = np.asarray(want[i])
            i += 1
            if name in EXACT:
                np.testing.assert_array_equal(got, ref, err_msg=name)
            elif name in ULP_OPS:
                np.testing.assert_allclose(got, ref, rtol=0, atol=PHOTO_TOL,
                                           err_msg=f"{name} {lvl}")
            elif name in P.WARPS:
                edge += _hold_warp(got, ref, P.warp_matrix(
                    name, h, w, lvl, sign), h, w)
            else:
                assert name == "equalize"
                d = np.abs(got - ref)
                assert np.all((d <= PHOTO_TOL)
                              | (np.abs(d - 1 / 255) <= PHOTO_TOL))
    assert edge == 0
    np.testing.assert_array_equal(P.equalize(_t(x), 0, sign).numpy(),
                                  _equalize_source(x))


def _equalize_source(x):
    """JAX's ``equalize`` as its source reads (PIL's LUT), in NumPy f32:
    what its eager run gives."""
    out = np.empty_like(x)
    xi = np.clip((x * np.float32(255)).astype(np.int32), 0, 255)
    for b in range(x.shape[0]):
        for c in range(x.shape[3]):
            v = xi[b, :, :, c]
            hist = np.bincount(v.ravel(), minlength=256).astype(np.float32)
            step = (hist.sum() - hist[255]) / np.float32(255)
            cdf = np.cumsum(hist, dtype=np.float32)
            lut = np.clip(((cdf - hist) / max(step, np.float32(1e-8))
                           + np.float32(0.5)).astype(np.int32), 0, 255)
            lut = lut if step > 0 else np.arange(256)
            out[b, :, :, c] = lut[v].astype(np.float32) / np.float32(255)
    return out


TWO = [(("invert", 0.6, 9), ("color", 0.5, 4)),
       (("solarize", 0.7, 5), ("brightness", 0.8, 3))]


def test_apply_policy_draw_logic_on_two_sub_policies():
    """``_apply_policy`` with the real ``lax.switch`` on a two-sub-policy
    list, two keys that pick each sub-policy: the port's
    ``apply_policy`` on JAX's index, applications and signs."""
    from iif_tpu.data import autoaugment as ja

    from iif_torch.data import autoaugment as P

    x = _grid_images(4, 12, 12, seed=1)
    keys = [jax.random.PRNGKey(seed) for seed in (0, 3)]

    def run(key, v):
        k_sel, k_ops = jax.random.split(key)
        return (ja._apply_policy(key, v, TWO),
                jax.random.randint(k_sel, (), 0, len(TWO)),
                _branch_uniforms(k_ops, 2))

    picked = set()
    for key in keys:
        want, index, uniforms = jax_run(run, key, jnp.asarray(x))
        index = int(index)
        picked.add(index)
        draw = {"index": index, "ops": _policy(_tree(uniforms), TWO[index])}
        got = P.apply_policy(_t(x), draw, TWO).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PHOTO_TOL)
    assert picked == {0, 1}


def test_policy_tables_are_jax_s():
    """The two AutoAugment tables and RandAugment's op list, verbatim."""
    from iif_tpu.data import autoaugment as ja

    from iif_torch.data import autoaugment as P

    assert P.CIFAR10_POLICY == ja.CIFAR10_POLICY
    assert P.IMAGENET_POLICY == ja.IMAGENET_POLICY
    assert P.RANDAUG_OPS == ja._RANDAUG_OPS


@pytest.fixture
def chosen_branch(monkeypatch):
    """``jax.lax.switch`` replaced by a call of the branch that JAX's key
    picks: the test appends the indices, in the order of the calls,
    before it traces."""
    chosen = []
    monkeypatch.setattr(jax.lax, "switch",
                        lambda index, branches, *ops: branches[
                            chosen.pop(0)](*ops))
    return chosen


MEAN, STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
IMEAN, ISTD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
ERASE = 0.8
# each pipeline's key; the sub-policies and RandAugment ops its
# ``lax.switch`` runs (the port draws these picks on the host, so the test
# sets them on both sides: JAX's ``randint`` picks are not the port's)
KEYS = {"cifar_policy": 22, "cifar_oneof": 23, "imagenet_policy": 6,
        "imagenet_randaugment": 7, "imagenet_oneof": 8}
CIFAR_SUB, IMAGENET_SUB, RANDAUG = 6, 3, [5, 4]
ONEOF = {"cifar_oneof": 0, "imagenet_oneof": 5}     # the OneOf branches


def _branch_uniforms(kk, n):
    """``_apply_policy``'s per-op uniforms (its Bernoulli draws are
    ``uniform < prob``) and signs from the branch key ``kk``."""
    out = []
    for i in range(n):
        k_p, k_op, kk = jax.random.split(jax.random.fold_in(kk, i), 3)
        out.append((jax.random.uniform(k_p, (4,)),
                    jax.random.bernoulli(k_op, 0.5, (4,))))
    return out


def _erasing(key, shape):
    b = shape[0]
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    return {"apply": jax.random.bernoulli(k1, ERASE, (b,)),
            "scale": jax.random.uniform(k2, (b,), minval=0.02, maxval=0.33),
            "log_r": jax.random.uniform(k3, (b,), minval=jnp.log(0.3),
                                        maxval=jnp.log(3.3)),
            "uy": jax.random.uniform(k4, (b,)),
            "ux": jax.random.uniform(k5, (b,)),
            "noise": jax.random.normal(k6, shape, jnp.float32)}


def _jax_window(key, images, size=224):
    """Stands for JAX's ``random_resized_crop`` in the pipeline test: the
    ``size`` x ``size`` window at the origin (the resized crop itself is
    held in ``tests/test_torch_cls_data.py``)."""
    return images[:, :size, :size, :]


def _port_window(images, draw, size=224):
    return images[:, :size, :size, :]


def _jax_pipelines(keys, uc, ui):
    """Every pipeline variant's output and its draws, in one program."""
    from iif_tpu.data import augment as ja

    from tests.test_torch_cls_branch_augment import branch_draw

    out, draws = {}, {}
    key = keys["cifar_oneof"]
    out["cifar_oneof"] = ja.cifar_train_augment(key, uc, MEAN, STD,
                                                use_oneof=True)
    k_ops = jax.random.split(jax.random.split(key, 5)[2])[1]
    draws["cifar_oneof"] = {"oneof": branch_draw(ONEOF["cifar_oneof"],
                                                 k_ops, uc.shape)}
    for name in ("cifar_policy",):
        key = keys[name]
        out[name] = ja.cifar_train_augment(key, uc, MEAN, STD,
                                           use_policy=True,
                                           random_erase=ERASE)
        k_crop, k_flip, k_pol, k_cut, k_re = jax.random.split(key, 5)
        ky, kx = jax.random.split(k_crop)
        d = {"oy": jax.random.randint(ky, (4,), 0, 9),
             "ox": jax.random.randint(kx, (4,), 0, 9),
             "flip": jax.random.bernoulli(k_flip, 0.5, (4,))}
        d["policy"] = _branch_uniforms(jax.random.split(k_pol)[1], 2)
        hy, hx = jax.random.split(jax.random.fold_in(k_cut, 0))
        d["cutout"] = {"cy": jax.random.randint(hy, (4,), 0, 16)[None],
                       "cx": jax.random.randint(hx, (4,), 0, 16)[None]}
        d["erase"] = _erasing(k_re, (4, 16, 16, 3))
        draws[name] = d
    for name, value in (("imagenet_policy", "imagenet"),
                        ("imagenet_randaugment", "randaugment"),
                        ("imagenet_oneof", "oneof")):
        key = keys[name]
        erase = ERASE if value == "imagenet" else 0.0
        out[name] = ja.imagenet_train_augment(key, ui, IMEAN, ISTD, size=12,
                                              auto_augment=value,
                                              random_erase=erase)
        _, k_flip, k_cj, k_re = jax.random.split(key, 4)
        d = {"crop": {},
             "flip": jax.random.bernoulli(k_flip, 0.5, (4,))}
        if value == "imagenet":
            d["policy"] = _branch_uniforms(jax.random.split(k_cj)[1], 2)
            d["erase"] = _erasing(k_re, (4, 12, 12, 3))
        elif value == "oneof":
            d["oneof"] = branch_draw(ONEOF[name], jax.random.split(k_cj)[1],
                                     (4, 12, 12, 3))
        else:
            d["randaugment"] = [jax.random.bernoulli(jax.random.split(
                jax.random.fold_in(k_cj, i))[1], 0.5, (4,)) for i in range(2)]
        draws[name] = d
    return out, draws


def _tree(x):
    return jax.tree_util.tree_map(_t, x)


def _policy(uniforms, sub):
    return [{"apply": u < np.float32(prob),
             "sign": torch.where(sign, 1.0, -1.0)}
            for (u, sign), (_n, prob, _l) in zip(uniforms, sub)]


def test_pipelines_on_jax_draws(chosen_branch, monkeypatch):
    """Both pipelines on JAX's draws, each ``--auto-augment`` value:
    CIFAR with the CIFAR-10 policy, cutout 16 and random erasing after
    normalisation, and with ``oneof`` in place of crop and flip (branch
    0: contrast, flip, hue); ImageNet with the ImageNet policy and random
    erasing, with RandAugment, with ``oneof`` after the resized crop and
    the flip (branch 5: brightness, contrast, translate). ``cifar`` on
    ImageNet (which does not fit the dataset and leaves ColorJitter, as in
    JAX) is held by ``test_port_draws_follow_the_flags``. The ten
    branches are held one by one in
    ``tests/test_torch_cls_branch_augment.py``; the resized crop, held in
    ``tests/test_torch_cls_data.py``, is a fixed window here on both
    sides. Within 5.5e-6 (a warp's 1.1e-6 over a std of 0.2)."""
    from iif_tpu.data.autoaugment import CIFAR10_POLICY, IMAGENET_POLICY

    from iif_torch.data import augment

    from iif_tpu.data import augment as ja

    monkeypatch.setattr(ja, "random_resized_crop", _jax_window)
    monkeypatch.setattr(augment, "random_resized_crop", _port_window)
    keys = {k: jax.random.key(v, impl="rbg") for k, v in KEYS.items()}
    chosen_branch.extend([ONEOF["cifar_oneof"], CIFAR_SUB, IMAGENET_SUB]
                         + RANDAUG + [ONEOF["imagenet_oneof"]])
    rng = np.random.RandomState(2)
    uc = rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)
    ui = rng.randint(0, 256, (4, 20, 18, 3)).astype(np.uint8)
    want, draws = jax_run(_jax_pipelines, keys, jnp.asarray(uc),
                          jnp.asarray(ui))
    draws = _tree(draws)
    d = draws["cifar_policy"]
    d["policy"] = {"index": CIFAR_SUB, "ops": _policy(
        d["policy"], CIFAR10_POLICY[CIFAR_SUB])}
    d = draws["imagenet_policy"]
    d["policy"] = {"index": IMAGENET_SUB, "ops": _policy(
        d["policy"], IMAGENET_POLICY[IMAGENET_SUB])}
    d = draws["imagenet_randaugment"]
    d["randaugment"] = {"ops": [{"index": i, "sign": torch.where(
        s, 1.0, -1.0)} for i, s in zip(RANDAUG, d["randaugment"])]}
    for name, index in ONEOF.items():
        draws[name]["oneof"] = {"index": index, "draw": draws[name]["oneof"]}
    for name, d in draws.items():
        if name.startswith("cifar"):
            got = augment.cifar_train_augment(_t(uc), d, MEAN, STD)
        else:
            got = augment.imagenet_train_augment(_t(ui), d, IMEAN, ISTD,
                                                 size=12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]),
                                   rtol=0, atol=WARP_TOL / 0.199,
                                   err_msg=name)
        if "erase" in d:
            assert bool(d["erase"]["apply"].any()), name
    assert not chosen_branch


def test_port_draws_follow_the_flags():
    """The port's own draws: the policy keys each ``--auto-augment`` value
    gives, the host's sub-policy index keyed by the generator's seed (the
    same seed, the same index; mixup's (seed, step) stream apart), and
    the shapes."""
    from iif_torch.data import augment
    from iif_torch.data.autoaugment import host_rng

    gen = lambda: torch.Generator().manual_seed((3 << 32) | 7)  # noqa: E731
    keys = lambda d: set(d)                                     # noqa: E731
    assert keys(augment.draw_cifar(gen(), 2, "cpu")) == {"oy", "ox", "flip"}
    assert keys(augment.draw_cifar(gen(), 2, "cpu", "cifar", 0.2)) == {
        "oy", "ox", "flip", "policy", "cutout", "erase"}
    assert keys(augment.draw_cifar(gen(), 2, "cpu", "oneof")) == {"oneof"}
    assert keys(augment.draw_cifar(gen(), 2, "cpu", "imagenet")) == {
        "oy", "ox", "flip"}
    for value, key in (("imagenet", "policy"), ("randaugment",
                                                 "randaugment"),
                       ("oneof", "oneof"), ("cifar", "jitter"),
                       (None, "jitter")):
        d = augment.draw_imagenet(gen(), 2, 30, 30, "cpu",
                                  auto_augment=value, size=16)
        assert keys(d) == {"crop", "flip", key}, value
    a = augment.draw_imagenet(gen(), 2, 30, 30, "cpu", auto_augment="imagenet")
    b = augment.draw_imagenet(gen(), 2, 30, 30, "cpu", auto_augment="imagenet")
    assert a["policy"]["index"] == b["policy"]["index"]
    assert torch.equal(a["policy"]["ops"][0]["sign"],
                       b["policy"]["ops"][0]["sign"])
    assert host_rng(gen()).randint(1 << 30) != np.random.RandomState(
        [3, 7]).randint(1 << 30)
    e = augment.draw_cifar(gen(), 2, "cpu", None, 0.5)["erase"]
    assert e["noise"].shape == (2, 32, 32, 3)


def _script_calls():
    """The argument lists of ``scripts/repro_imagenet_lt.sh``'s three
    training calls on ImageNet-LT (not its synthetic smoke run), its
    shell variables given dummy values."""
    import shlex
    from pathlib import Path

    text = Path(__file__).resolve().parents[1].joinpath(
        "scripts", "repro_imagenet_lt.sh").read_text()
    text = text.replace("\\\n", " ")
    calls = []
    for line in text.splitlines():
        if "python -m iif_tpu.cli.train" not in line or "COMMON" in line:
            continue
        argv = shlex.split(line.split("|")[0].replace('"', ""))
        argv = argv[argv.index("iif_tpu.cli.train") + 1:]
        calls.append([a.replace("$DATA_ROOT", "/d").replace(
            "$LT_LISTS", "/d").replace("$OUT", "/o") for a in argv])
    return calls


def test_cli_takes_the_recipe_flags():
    """``python -m iif_torch.cli.train`` parses and accepts every flag of
    the three calls of ``scripts/repro_imagenet_lt.sh``
    (``--auto-augment imagenet`` included); each ``--auto-augment``
    value with ``--random-erase`` gives a train transform that runs on
    the dataset kind's batch; the four ``--opt`` names and the seven new
    ``--model`` names are taken; ``--pretrained`` is still refused."""
    from iif_torch.cli import train

    calls = _script_calls()
    assert len(calls) == 3 and calls[0].count("--auto-augment") == 1
    parser = train.get_args_parser()
    for argv in calls:
        train.refuse_unported(parser.parse_args(argv))
    gen = torch.Generator().manual_seed(1)
    for kind, dset, shape in (("cifar", "cifar100", (2, 32, 32, 3)),
                              ("imagenet", "imagenet_lt", (2, 40, 36, 3))):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen)
        for value in ("cifar", "imagenet", "randaugment", "oneof", None):
            args = parser.parse_args(
                ["--dset_name", dset, "--random-erase", "0.5"]
                + (["--auto-augment", value] if value else []))
            train.refuse_unported(args)
            aug, _ = train.transforms(args, kind)
            out = aug(torch.Generator().manual_seed(2), x)
            size = 32 if kind == "cifar" else 224
            assert out.shape == (2, size, size, 3), (kind, value)
            assert bool(torch.isfinite(out).all())
    from iif_torch.models.factory import build_classifier

    for flags in (["--opt", "sgd"], ["--opt", "nesterov"],
                  ["--opt", "rmsprop"], ["--opt", "adamw"]):
        train.refuse_unported(parser.parse_args(flags))
    for name in ("resnet18", "resnet34", "resnext50_32x4d",
                 "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
                 "se_resnext50_32x4d"):
        args = parser.parse_args(["--model", name])
        train.refuse_unported(args)
        with torch.device("meta"):
            build_classifier(args.model, 10)
    with pytest.raises(NotImplementedError, match="--pretrained"):
        train.refuse_unported(parser.parse_args(["--pretrained", "x.pth"]))
