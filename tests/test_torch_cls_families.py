"""The classifier families the port adds (JAX's ``BasicBlockV1`` ResNets,
ResNeXt, the wide ResNets, SE-ResNeXt) against ``iif_tpu`` on the CPU:
the seven constructors' configurations (stages, block, groups, width per
group, SE, head), and the two block kinds they build, ``BasicBlock`` and
the grouped bottleneck with SE (ResNeXt's 32 groups of width 4, whose
widths are the wide variant's too), in a trunk at depth (1, 1) (the
stem and two stages: a block without and one with the projection
shortcut) in f32 on JAX's variables carried over by
``classifier_state_from_jax``: the features in training mode (batch
statistics), the new running statistics and the gradients of every
parameter and of the input; the fresh init's grouped fans and zero
``bn2``. The heads and the full-depth stacking are the ResNet-50's,
held in ``tests/test_torch_cls_models.py``.

Tolerances (measured, then set): features and running statistics
within 3.6e-6 of each tensor's largest (1e-5), gradients within 1.1e-5
in relative norm (1e-4; the BatchNorm backward's sums over the batch run
in another order). JAX's program compiles at XLA's
backend optimisation level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
NEW = ("resnet18", "resnet34", "resnext50_32x4d", "resnext101_32x8d",
       "wide_resnet50_2", "wide_resnet101_2", "se_resnext50_32x4d")
# the distinct families at depth (1, 1, 1, 1): block, groups, width per
# group, SE
FAMILIES = {"basic": ("basic", 1, 64, False),
            "se_resnext_32x4d": ("bottleneck", 32, 4, True)}
TOL = {"features": 1e-5, "stats": 1e-5, "grad": 1e-4}


def _structure(model):
    """(layers, block, groups, width per group, SE) of a port ResNet."""
    from iif_torch.models.resnet import BasicBlock

    first = model.layer1[0]
    basic = isinstance(first, BasicBlock)
    groups = 1 if basic else first.conv2.groups
    width = 64 if basic else first.conv2.out_channels // groups
    return (tuple(len(getattr(model, f"layer{s}")) for s in range(1, 5)),
            "basic" if basic else "bottleneck", groups, width,
            first.se is not None)


@pytest.mark.parametrize("name", NEW)
def test_constructors_match_jax(name):
    """Each constructor builds JAX's configuration (stages, block,
    groups, width per group, SE) with a head of ``num_classes``."""
    from iif_tpu.models.factory import build_classifier as jax_build

    from iif_torch.models.factory import build_classifier

    jm = jax_build(name, 7)
    with torch.device("meta"):
        pm = build_classifier(name, 7)
    assert _structure(pm) == (tuple(jm.layers), jm.block, jm.groups,
                              jm.width_per_group, jm.use_se)
    assert pm.fc.out_features == 7
    assert pm.fc.in_features == (512 if jm.block == "basic" else 2048)


def _random_vars(module, x, seed):
    """Seeded variables of ``module``'s structure (no compile): kernels
    N(0, 1 / fan_in), BN scales about 1, variances positive."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), x, train=False, return_features=True))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        v = rng.randn(*s.shape).astype(np.float32)
        if path[-1].key == "var":
            v = np.abs(v) + 0.5
        elif path[-1].key == "scale":
            v = 1.0 + 0.3 * v
        if path[-1].key == "kernel":
            v = v / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _with_head(tree):
    """``tree`` with a dummy ``linear`` head, which
    ``classifier_state_from_jax`` expects (its keys dropped after)."""
    return {**tree, "linear": {"kernel": np.zeros((1, 1), np.float32),
                               "bias": np.zeros(1, np.float32)}}


def _state(params, stats):
    from iif_torch.models.convert import classifier_state_from_jax

    out = classifier_state_from_jax(_with_head(params), stats)
    return {k: v for k, v in out.items() if not k.startswith("linear.")}


def test_blocks_forward_and_gradients_match_jax():
    """Training-mode features of the second stage, new running
    statistics and the gradients of ``sum(features * r)`` for every
    parameter and the input, each block kind on its variables and the
    batch (4, 32, 32, 3), f32; one program for both."""
    from iif_tpu.models.resnet import ResNet as JaxResNet

    from iif_torch.models.resnet import ResNet

    rng = np.random.RandomState(3)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    r = rng.randn(4, 4, 4, 512).astype(np.float32)
    jms, pms, variables = {}, {}, {}
    for i, (name, (block, groups, wpg, se)) in enumerate(FAMILIES.items()):
        jms[name] = JaxResNet((1, 1), block, None, groups=groups,
                              width_per_group=wpg, use_se=se, num_stages=2)
        pms[name] = ResNet((1, 1), num_stages=2, block=block, groups=groups,
                           width_per_group=wpg, use_se=se)
        variables[name] = _random_vars(jms[name], jnp.asarray(x), seed=i)

    def run(variables, xx, rr):
        out = {}
        for name, jm in jms.items():
            v = variables[name]

            def loss(params, inp):
                feats, mut = jm.apply(
                    {"params": params, "batch_stats": v["batch_stats"]},
                    inp, train=True, mutable=["batch_stats"],
                    return_features=True)
                f = feats[-1]
                return (f * rr[..., :f.shape[-1]]).sum(), (
                    f, mut["batch_stats"])

            (_, (feats, stats)), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(v["params"], xx)
            out[name] = (feats, stats, grads)
        return out

    args = (variables, jnp.asarray(x), jnp.asarray(r))
    want = jax.jit(run).lower(*args).compile(compiler_options=FAST)(*args)

    def close(got, ref, tol, what, norm=False):
        got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
        err = (np.linalg.norm(got - ref) / np.linalg.norm(ref) if norm
               else np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= tol, (what, err)

    for name, pm in pms.items():
        v = variables[name]
        feats, stats, (gparams, gx) = want[name]
        pm.load_state_dict(_state(v["params"], v["batch_stats"]))
        pm.train()
        xt = torch.from_numpy(x).requires_grad_(True)
        out = pm(xt.permute(0, 3, 1, 2))[-1].permute(0, 2, 3, 1)
        rr = torch.from_numpy(r)[..., :out.shape[-1]]
        (out * rr).sum().backward()
        close(out.detach(), feats, TOL["features"], (name, "features"))
        ref = _state(gparams, stats)
        for k, t in pm.state_dict().items():
            if "running" in k:
                close(t, ref[k], TOL["stats"], (name, k))
        for k, p in pm.named_parameters():
            close(p.grad, ref[k], TOL["grad"], (name, k), norm=True)
        close(xt.grad, gx, TOL["grad"], (name, "input"), norm=True)


def test_fresh_init_of_the_new_families():
    """``classifier_fresh_init_``: a grouped 3x3 conv N(0, 2 / fan_out)
    with flax's fan-out ``9 * out`` (its (3, 3, in / groups, out) kernel),
    a basic block's ``bn2`` scale 0 and ``bn1``'s 1; std within 10%."""
    from iif_torch.models.init import classifier_fresh_init_
    from iif_torch.models.resnet import ResNet

    g = torch.Generator().manual_seed(0)
    m = classifier_fresh_init_(ResNet((1, 1, 1, 1), num_classes=10,
                                      groups=32, width_per_group=4), g)
    w = m.layer3[0].conv2.weight.detach()
    assert tuple(w.shape) == (512, 16, 3, 3)
    std = float(w.std())
    assert abs(std / (2 / (9 * 512)) ** 0.5 - 1) < 0.1, std
    assert torch.equal(m.layer3[0].bn3.weight, torch.zeros(1024))
    b = classifier_fresh_init_(ResNet((2, 2, 2, 2), num_classes=10,
                                      block="basic"), g)
    assert torch.equal(b.layer2[1].bn2.weight, torch.zeros(128))
    assert torch.equal(b.layer2[1].bn1.weight, torch.ones(128))
    std = float(b.layer4[0].conv1.weight.detach().std())
    assert abs(std / (2 / (9 * 512)) ** 0.5 - 1) < 0.1, std
