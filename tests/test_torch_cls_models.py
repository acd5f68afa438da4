"""The classifiers of the port against ``iif_tpu`` on the CPU: BatchNorm
with batch statistics (flax ``BatchNorm`` for ``"bn"`` and
``LocalBatchNorm`` for ``"bn@2"``; output, new running statistics and the
gradients of the analytic backward, f32 and bf16), each classifier head,
``ResNetS((1, 1, 1))`` with SE and the normed head and a ResNet-50-layout
classifier at depth (1, 1, 1, 1) with SE, the cosine head and ``bn@2``,
both in bf16, in train and eval mode, on JAX's variables carried
over by ``classifier_state_from_jax``; the port's fresh init, the factory
and the trunk's BatchNorm modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).permute(0, 3, 1, 2)


def _random_vars(module, *args, seed=0, **kw):
    """Variables of ``module``'s structure (``eval_shape``, no compile)
    with seeded values: kernels N(0, 1 / fan_in), so that activations keep
    their scale, BN scales about 1 and variances positive."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
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


# (output, running statistics, gradients), of each tensor's largest;
# measured: f32 1.4e-7, 1.8e-7, 2.7e-7; bf16 0 (the same bf16 values),
# 9.1e-8, and the input's gradient 3.0e-3 (one bf16 ulp; the statistics'
# sums run in another order), the affine parameters' 3.4e-7
BN_TOL = {"float32": (1e-6, 1e-6, 2e-6), "bfloat16": (4e-3, 1e-6, 8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["bn", "bn@2"])
def test_batch_norm_train_matches_flax(norm, dtype):
    from flax import linen as nn
    from iif_tpu.models.norm import LocalBatchNorm

    from iif_torch.models.resnet import BatchNorm2d

    jdt = getattr(jnp, dtype)
    if norm == "bn":
        mod = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jdt)
    else:
        mod = LocalBatchNorm(groups=2, use_running_average=False,
                             momentum=0.9, epsilon=1e-5, dtype=jdt)
    rng = np.random.RandomState(1)
    x = (2 + 3 * rng.randn(4, 5, 5, 6)).astype(np.float32)
    g = rng.randn(4, 5, 5, 6).astype(np.float32)
    v = _random_vars(mod, jnp.asarray(x, jdt))
    xj = jnp.asarray(x, jdt)

    @jax.jit
    def run(xx, params):
        def f(xx, params):
            y, mut = mod.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, xx,
                               mutable=["batch_stats"])
            return (y.astype(jnp.float32) * g).sum(), (y, mut)
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            xx, params)

    (_, (want, mut)), (gx, gp) = run(xj, v["params"])
    bn = BatchNorm2d(6, 1e-5, {"bn": 0, "bn@2": 2}[norm]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(v["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.array(
            v["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(
            v["batch_stats"]["var"])))
    xt = _nchw(xj.astype(jnp.float32)).to(getattr(torch, dtype))
    xt.requires_grad_()
    y = bn(xt)
    assert y.dtype == xt.dtype
    (y.float() * _nchw(g)).sum().backward()
    out_tol, stat_tol, grad_tol = BN_TOL[dtype]

    def close(a, b, tol):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
            np.abs(a - b).max() / np.abs(b).max()

    close(y.detach().float().permute(0, 2, 3, 1),
          want.astype(jnp.float32), out_tol)
    close(bn.running_mean, mut["batch_stats"]["mean"], stat_tol)
    close(bn.running_var, mut["batch_stats"]["var"], stat_tol)
    close(xt.grad.float().permute(0, 2, 3, 1), gx.astype(jnp.float32),
          grad_tol)
    close(bn.weight.grad, gp["scale"], grad_tol)
    close(bn.bias.grad, gp["bias"], grad_tol)


@pytest.mark.parametrize("use_norm", [None, "norm", "cosine", "lr_cosine"])
def test_heads_match_flax(use_norm):
    """Each head on an f32 and a bf16 feature: flax's ``Dense`` promotes
    the bf16 feature to f32, the normed heads compute in bf16. Measured:
    f32 within 1.9e-6, bf16 within one bf16 ulp of the logit (0.0625 at
    the cosine head's scale 16)."""
    from iif_tpu.models.layers import make_classifier_head as jax_head

    from iif_torch.models.convert import _head
    from iif_torch.models.layers import make_classifier_head

    feat = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    head = jax_head(7, use_norm)
    v = _random_vars(head, jnp.asarray(feat), seed=3)
    name = {None: "linear", "norm": "NormedLinear_0",
            "cosine": "CosNormClassifier_0",
            "lr_cosine": "CosNormClassifier_0"}[use_norm]
    state = {}
    _head(state, "h", {name: v["params"]})
    port = make_classifier_head(16, 7, use_norm)
    port.load_state_dict({k[2:]: t for k, t in state.items()})
    run = jax.jit(lambda x: head.apply(v, x))
    for dt, tol in (("float32", 5e-6), ("bfloat16", 2e-2)):
        xj = jnp.asarray(feat).astype(dt)
        want = run(xj)
        got = port(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            getattr(torch, dt)))
        assert str(got.dtype).endswith(str(want.dtype)), (got.dtype,
                                                          want.dtype)
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


# (JAX model, port model, input size, dtype, tolerance of each tensor's
# largest), in bf16 (a rounding at every conv and BN output; the f32
# ResNet-s is held in ``tests/test_torch_cls_trainer.py``'s f32 step, and
# here measured at 4.3e-7): logits 2.6e-3 (ResNet-s, train) to 1.06e-2
# (the SE ResNet-50 layout, train), statistics 1.1e-3. The layout
# runs at 64x64: at 32x32 its last stage is 1x1, and ``bn@2``'s groups of
# 2 samples there make the statistics ill-conditioned (1e-2 apart in f32)
def _models():
    from iif_tpu.models import resnet as jax_big
    from iif_tpu.models import resnet_cifar as jax_cifar

    from iif_torch.models.resnet import ResNet
    from iif_torch.models.resnet_cifar import ResNetS

    return {
        "resnet_s_se_norm_bf16": (
            jax_cifar.ResNetS((1, 1, 1), 10, "norm", use_se=True,
                              dtype=jnp.bfloat16),
            ResNetS((1, 1, 1), 10, "norm", use_se=True,
                    compute_dtype=torch.bfloat16), 16, "bfloat16", 3e-2),
        "se_resnet50_layout_cosine_bn2_bf16": (
            jax_big.ResNet((1, 1, 1, 1), "bottleneck", 12, "cosine",
                           use_se=True, norm="bn@2", dtype=jnp.bfloat16),
            ResNet((1, 1, 1, 1), num_classes=12, use_norm="cosine",
                   use_se=True, bn_groups=2, compute_dtype=torch.bfloat16),
            64, "bfloat16", 3e-2),
    }


@pytest.mark.parametrize("name", ["resnet_s_se_norm_bf16",
                                  "se_resnet50_layout_cosine_bn2_bf16"])
def test_classifier_matches_flax(name):
    """Train mode (batch statistics: logits and the new running ones) and
    eval mode (running statistics) on the same variables."""
    from iif_torch.models.convert import classifier_state_from_jax

    jm, pm, size, dt, tol = _models()[name]
    x = np.random.RandomState(4).randn(4, size, size, 3).astype(np.float32)
    v = _random_vars(jm, jnp.asarray(x), seed=5, train=False)
    pm.load_state_dict(classifier_state_from_jax(v["params"],
                                                 v["batch_stats"]))

    @jax.jit
    def run(xx):
        train, mut = jm.apply(v, xx, train=True, mutable=["batch_stats"])
        return train, mut["batch_stats"], jm.apply(v, xx, train=False)

    want_train, want_stats, want_eval = run(jnp.asarray(x))
    got_eval = pm.eval()(_nchw(x)).detach()
    got_train = pm.train()(_nchw(x)).detach()

    def close(a, b, what=""):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (what, err)

    close(got_train.float(), want_train.astype(jnp.float32), "train")
    close(got_eval.float(), want_eval.astype(jnp.float32), "eval")
    got_stats = classifier_state_from_jax(v["params"], want_stats)
    for k, t in pm.state_dict().items():
        if "running" in k:
            close(t, got_stats[k])


def test_fresh_init_follows_flax_families():
    """``classifier_fresh_init_``: CIFAR convs N(0, 2 / fan_in), ImageNet
    convs N(0, 2 / fan_out), BN 1 / 0 (``bn3`` 0) with statistics 0 / 1,
    SE and the plain head N(0, 2 / fan_in) with bias 0, the normed heads
    U(-1, 1) (cosine / sqrt(in), learned scale 5); std within 10%."""
    from iif_torch.models.factory import build_classifier
    from iif_torch.models.init import classifier_fresh_init_

    def std_ok(t, want):
        std = float(t.detach().std())
        assert abs(std / want - 1) < 0.1, (std, want)

    m = classifier_fresh_init_(build_classifier("se_resnet32", 100),
                               torch.Generator().manual_seed(0))
    std_ok(m.layer2[0].conv1.weight, (2 / (16 * 9)) ** 0.5)
    std_ok(m.layer3[1].se.fc1.weight, (2 / 64) ** 0.5)
    std_ok(m.linear.weight, (2 / 64) ** 0.5)
    assert torch.equal(m.linear.bias, torch.zeros(100))
    assert torch.equal(m.layer1[0].bn2.weight, torch.ones(16))
    big = classifier_fresh_init_(build_classifier("se_resnet50", 50,
                                                  "lr_cosine"),
                                 torch.Generator().manual_seed(0))
    std_ok(big.layer3[0].conv2.weight, (2 / (256 * 9)) ** 0.5)
    std_ok(big.layer4[2].conv3.weight, (2 / 2048) ** 0.5)
    assert torch.equal(big.layer2[1].bn3.weight, torch.zeros(512))
    assert torch.equal(big.layer2[1].bn2.running_var, torch.ones(128))
    w = big.fc.weight
    assert w.abs().max() <= 2048 ** -0.5 and w.abs().max() > 0.95 * 2048 ** -0.5
    assert float(big.fc.scale) == 5.0
    normed = classifier_fresh_init_(build_classifier("resnet20", 10, "norm"),
                                    torch.Generator().manual_seed(0))
    assert 0.95 < float(normed.linear.weight.abs().max()) <= 1.0


def test_factory_names_and_refusals():
    from iif_torch.models.factory import build_classifier, \
        classifier_model_names
    from iif_torch.models.resnet import ResNet
    from iif_torch.models.resnet_cifar import ResNetS

    from iif_tpu.models.factory import classifier_model_names as jax_names

    names = classifier_model_names()
    assert names == jax_names() and len(names) == 18
    assert isinstance(build_classifier("resnet32", 100), ResNetS)
    m = build_classifier("se_resnet50", 1000, "cosine", bn_groups=4)
    assert isinstance(m, ResNet) and m.layer1[0].se is not None
    assert {b.groups for b in m.modules()
            if isinstance(b, torch.nn.BatchNorm2d)} == {4}
    assert isinstance(build_classifier("resnet18", 10), ResNet)
    with pytest.raises(KeyError):
        build_classifier("vit", 10)


def test_trunk_batch_norm_modes():
    """``train()``: ``norm_eval`` keeps every BatchNorm on its running
    statistics, ``frozen_stages`` the stem's and the frozen stages'; the
    rest take the batch's statistics and update their running ones."""
    from iif_torch.models.resnet import ResNet

    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    det = ResNet((1, 1, 1, 1), frozen_stages=1, norm_eval=True).train()
    assert not any(m.training for m in det.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    trunk = ResNet((1, 1, 1, 1), frozen_stages=1).train()
    before = {k: v.clone() for k, v in trunk.state_dict().items()}
    trunk(x)
    after = trunk.state_dict()
    for k in ("bn1.running_mean", "layer1.0.bn2.running_var"):
        assert torch.equal(after[k], before[k]), k
    for k in ("layer2.0.bn1.running_mean", "layer4.0.bn3.running_var"):
        assert not torch.equal(after[k], before[k]), k
