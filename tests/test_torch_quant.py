"""Int8 QAT of the port (``iif_torch/quant.py``, the trainer's QAT
hooks) and the calibration metrics against ``iif_tpu`` on the CPU:
``fake_quant`` and its straight-through gradient, ``weight_scale`` in
each layout, the trees (``observe_scales``, ``fake_quant_params``,
``quantize_tree``, ``dequantize_tree``) over a ResNet-s with SE and the
normed head and over the cosine head, one QAT training step with
``quant_on`` and one with BatchNorm frozen and frozen scales against
JAX's ``_train_step_impl``, ``evaluate_quantized`` against ``evaluate``
on the dequantized weights, and ECE / MCE.

Tolerances (measured, then set): int8 weights equal, scales and
fake-quantized weights within one ulp (``NormedLinear``'s too, whose
stored weight is flax's kernel less 1: ``(k - 1) + 1`` rounds where ``k
< 0.5``); the QAT steps as ``tests/test_torch_cls_trainer.py``'s f32
step (loss 1e-5 relative, the update 1e-4 and the statistics 1e-5 of
each tensor's largest). Inside a jitted program XLA divides by 127 and
by a broadcast scale as a multiply by the reciprocal: JAX's scales and
fake-quantized weights there lie within one ulp of the port's, which
divides as the source reads (and equals JAX's eager ``weight_scale``
and ``fake_quant``). JAX's programs compile at XLA's backend
optimisation level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen

from tests.test_torch_cls_trainer import _port, _port_model

torch.set_num_threads(1)

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
C, B, SIZE = 10, 8, 16
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4
ULP = 2.0 ** -23          # XLA's reciprocal of 127 and of the scales


def _np(x):
    return np.asarray(x, dtype=np.float32)


def test_fake_quant_and_scales_match_jax():
    """Per-channel scales of a conv (OIHW, channel axis 0) and a dense
    kernel, per-tensor scales, the fake-quant values and the
    straight-through gradient (ones)."""
    from iif_tpu import quant as jq

    from iif_torch import quant

    rng = np.random.RandomState(0)
    conv = rng.randn(3, 3, 4, 8).astype(np.float32)      # flax HWIO
    dense = rng.randn(6, 5).astype(np.float32)           # flax (in, out)
    want = [jq.weight_scale(jnp.asarray(conv)),
            jq.weight_scale(jnp.asarray(dense)),
            jq.weight_scale(jnp.asarray(dense), per_channel=False)]
    tconv = torch.from_numpy(conv.transpose(3, 2, 0, 1).copy())
    tdense = torch.from_numpy(dense.T.copy())
    got = [quant.weight_scale(tconv, 0), quant.weight_scale(tdense, 0),
           quant.weight_scale(tdense, 0, per_channel=False)]
    np.testing.assert_array_equal(got[0].flatten().numpy(),
                                  _np(want[0]).flatten())
    np.testing.assert_array_equal(got[1].flatten().numpy(),
                                  _np(want[1]).flatten())
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    fq = jq.fake_quant(jnp.asarray(conv), want[0])
    x = tconv.clone().requires_grad_(True)
    out = quant.fake_quant(x, got[0])
    np.testing.assert_array_equal(out.detach().numpy(),
                                  _np(fq).transpose(3, 2, 0, 1))
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_cosine_head_is_quantized_along_jax_s_axis():
    """``CosNormClassifier``'s flax kernel is (out, in), as the port's
    weight: JAX's channel, the kernel's last axis, is the port's axis 1;
    its learned scale is not quantized."""
    from iif_tpu import quant as jq

    from iif_torch import quant
    from iif_torch.models.layers import CosNormClassifier

    head = CosNormClassifier(6, 4, lr_scale=True)
    w = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(w))
    specs = quant.quant_specs(head)
    assert specs == {"weight": quant.QuantSpec(1, 0.0)}
    want = jq.weight_scale(jnp.asarray(w))
    got = quant.observe_scales(head)["weight"]
    assert tuple(got.shape) == (1, 6)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    fq = quant.fake_quant_params(head)
    np.testing.assert_array_equal(fq["weight"].detach().numpy(),
                                  _np(jq.fake_quant(jnp.asarray(w), want)))
    assert fq["scale"] is head.scale


def _random_tree(module, x, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                train=False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        v = rng.randn(*s.shape).astype(np.float32)
        if path[-1].key == "var":
            v = np.abs(v) + 0.5
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_quant_trees_match_jax():
    """``observe_scales``, ``fake_quant_params`` (live and frozen scales),
    ``quantize_tree`` and ``dequantize_tree`` over ``ResNetS((1, 1, 1))``
    with SE (convs, the SE block's dense layers) and the normed head, on
    JAX's variables carried over by ``classifier_state_from_jax``: every
    quantized weight and no other, int8 weights equal, scales and
    fake-quantized weights within one ulp."""
    head = "norm"
    from iif_tpu import quant as jq
    from iif_tpu.models.resnet_cifar import ResNetS as JaxResNetS

    from iif_torch import quant
    from iif_torch.models.convert import classifier_state_from_jax
    from iif_torch.models.resnet_cifar import ResNetS

    jm = JaxResNetS((1, 1, 1), C, head, use_se=True)
    v = _random_tree(jm, jnp.zeros((1, SIZE, SIZE, 3)), seed=1)
    params = v["params"]
    model = ResNetS((1, 1, 1), C, head, use_se=True)
    model.load_state_dict(classifier_state_from_jax(params,
                                                    v["batch_stats"]))

    def trees(p):
        scales = jq.observe_scales(p)
        q, s = jq.quantize_tree(p, scales)
        return (scales, jq.fake_quant_params(p), jq.fake_quant_params(
            p, scales), q, jq.dequantize_tree(q, s))

    scales, live, frozen, q, deq = jax.jit(trees).lower(params).compile(
        compiler_options=FAST)(params)
    specs = quant.quant_specs(model)
    n_kernels = sum(1 for path, leaf in jax.tree_util.tree_flatten_with_path(
        params)[0] if path[-1].key == "kernel" and leaf.ndim >= 2)
    assert len(specs) == n_kernels
    got_scales = quant.observe_scales(model)
    got_q, got_s = quant.quantize_tree(model)
    with torch.no_grad():
        got_live = quant.fake_quant_params(model)
        got_frozen = quant.fake_quant_params(model, scales=got_scales)
        got_deq = quant.dequantize_tree(model, got_q, got_s)
    want = {k: classifier_state_from_jax(t, v["batch_stats"])
            for k, t in (("live", live), ("frozen", frozen), ("deq", deq))}
    # int8 kernels and scales in the port's layout: flax's last axis is
    # the port's channel axis
    jq_int = classifier_state_from_jax(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), q), v["batch_stats"])
    for name, spec in specs.items():
        normed = spec.offset != 0
        q_int = jq_int[name] + (1.0 if normed else 0.0)
        assert got_q[name].dtype == torch.int8
        np.testing.assert_array_equal(got_q[name].float().numpy(),
                                      q_int.numpy(), err_msg=name)
        for key, got in (("live", got_live), ("frozen", got_frozen),
                         ("deq", got_deq)):
            ref = want[key][name].numpy()
            tol = ULP * np.abs(ref).max()
            np.testing.assert_allclose(got[name].numpy(), ref, rtol=0,
                                       atol=tol, err_msg=(key, name))
    for name, p in model.named_parameters():
        if name not in specs:
            assert torch.equal(got_live[name], p), name
            assert got_q[name].dtype == torch.float32, name
    # the scales, flattened in the tree's order against the specs' order
    want_scales = {}
    for path, s in jax.tree_util.tree_flatten_with_path(scales)[0]:
        if s.ndim:
            want_scales["/".join(str(getattr(k, "key", k)) for k in path)] \
                = _np(s).flatten()
    got_all = np.sort(np.concatenate([s.flatten().numpy()
                                      for s in got_scales.values()]))
    want_all = np.sort(np.concatenate(list(want_scales.values())))
    np.testing.assert_allclose(got_all, want_all, rtol=ULP, atol=0)


class _TinyJax(linen.Module):
    """conv, BatchNorm, ReLU, mean, dense: each piece the QAT hooks act
    on (a quantized conv and dense kernel, a BatchNorm to freeze)."""

    @linen.compact
    def __call__(self, x, train=False):
        x = linen.Conv(8, (3, 3), padding=1, use_bias=False,
                       name="conv1")(x)
        x = linen.BatchNorm(use_running_average=not train, momentum=0.9,
                            epsilon=1e-5, name="bn1")(x)
        return linen.Dense(C, name="linear")(linen.relu(x).mean((1, 2)))


class _Tiny(torch.nn.Module):
    """``_TinyJax`` with the port's BatchNorm and head."""

    def __init__(self):
        from iif_torch.models.layers import Linear
        from iif_torch.models.resnet import BatchNorm2d

        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(8)
        self.linear = Linear(8, C)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        return self.linear(x.mean((2, 3)))


def _tiny_state(params, stats):
    """The port's state_dict of ``_TinyJax``'s variables."""
    t = lambda v: torch.from_numpy(_np(v).copy())  # noqa: E731
    return {"conv1.weight": t(_np(params["conv1"]["kernel"])
                              .transpose(3, 2, 0, 1)),
            "bn1.weight": t(params["bn1"]["scale"]),
            "bn1.bias": t(params["bn1"]["bias"]),
            "bn1.running_mean": t(stats["bn1"]["mean"]),
            "bn1.running_var": t(stats["bn1"]["var"]),
            "bn1.num_batches_tracked": torch.tensor(0),
            "linear.weight": t(_np(params["linear"]["kernel"]).T),
            "linear.bias": t(params["linear"]["bias"])}


def _qat_trainers(single_mesh):
    from iif_tpu.data.augment import cifar_eval_transform as jax_eval
    from iif_tpu.data.cifar_lt import CIFAR10_MEAN, CIFAR10_STD
    from iif_tpu.engine import ClassificationTrainer as JaxTrainer
    from iif_tpu.engine import build_optimizer as jax_build
    from iif_tpu.engine.classification import TrainState
    from iif_tpu.losses import get_criterion as jax_criterion
    from iif_tpu.quant import QatConfig as JaxQat

    from iif_torch.data.augment import cifar_eval_transform
    from iif_torch.engine.classification import ClassificationTrainer
    from iif_torch.losses import get_criterion
    from iif_torch.quant import QatConfig

    counts = [40, 25, 16, 10, 7, 5, 3, 2, 2, 1]
    jtrainer = JaxTrainer(
        model=_TinyJax(), criterion=jax_criterion("ce", counts),
        tx=jax_build("sgd", lambda s: LR, momentum=MOMENTUM,
                     weight_decay=WD),
        mesh=single_mesh,
        train_augment=lambda k, x: jax_eval(x, CIFAR10_MEAN, CIFAR10_STD),
        eval_transform=lambda x: jax_eval(x, CIFAR10_MEAN, CIFAR10_STD),
        num_classes=C, compute_dtype=jnp.float32, seed=3,
        qat=JaxQat(True, 1, 1))
    v = _random_tree(_TinyJax(), jnp.zeros((1, SIZE, SIZE, 3)), seed=4)
    params = jax.tree_util.tree_map(lambda a: a * 0.3, v["params"])
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=v["batch_stats"],
                        opt_state=jtrainer.tx.init(params))
    model = _Tiny()
    model.load_state_dict(_tiny_state(params, v["batch_stats"]))
    trainer = ClassificationTrainer(
        model, get_criterion("ce", counts), lambda s: LR,
        lambda g, x: cifar_eval_transform(x, CIFAR10_MEAN, CIFAR10_STD),
        lambda x: cifar_eval_transform(x, CIFAR10_MEAN, CIFAR10_STD), C,
        compute_dtype=torch.float32, seed=3, momentum=MOMENTUM,
        weight_decay=WD, device="cpu", qat=QatConfig(True, 1, 1))
    return jtrainer, jstate, trainer


def test_qat_steps_match_jax(single_mesh):
    """A step with fake-quantized weights (live scales; the gradient
    straight through to the float weights), then, from JAX's weights
    after it, a step with frozen scales and BatchNorm on its running
    statistics, which stay as they were: loss, metrics, update and
    statistics against JAX's ``_train_step_impl`` (``quant_on``, then
    ``freeze_bn``), one program for both, on a conv-BN-dense model."""
    from iif_tpu.quant import observe_scales as jax_observe

    from iif_torch.quant import observe_scales

    jtrainer, jstate, trainer = _qat_trainers(single_mesh)
    rng = np.random.RandomState(5)
    batch = {"image": rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(
        np.uint8), "label": rng.randint(0, C, B).astype(np.int64)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def two_steps(state, b):
        one, m1 = jtrainer._train_step_impl(state, b, None, quant_on=True)
        scales = jax_observe(one.params)
        two, m2 = jtrainer._train_step_impl(one, b, scales, quant_on=True,
                                            freeze_bn=True)
        return one, m1, scales, two, m2

    one, m1, jscales, two, m2 = jax.jit(two_steps).lower(
        jstate, jbatch).compile(compiler_options=FAST)(jstate, jbatch)

    def check_step(before, metrics, jnew, jm):
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for key in ("acc1", "acc5"):
            assert float(metrics[key]) == float(jm[key])
        want = _tiny_state(jnew.params, jnew.batch_stats)
        got = trainer.model.state_dict()
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            scale = float(w.abs().max())
            if "running" in k:
                assert float((got[k] - w).abs().max()) <= 1e-5 * scale, k
            else:
                upd = before[k] - w
                err = float(((before[k] - got[k]) - upd).abs().max())
                assert err <= 1e-4 * float(upd.abs().max()), k

    model = trainer.model
    state = trainer.init_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = trainer.train_step(state, batch, quant_on=True)
    check_step(before, metrics, one, m1)
    assert not torch.equal(model.bn1.running_var, before["bn1.running_var"])
    # step 2 from JAX's weights after step 1, so that a rounding of
    # x / s to the other int8 neighbour cannot follow from step 1's ulps
    model.load_state_dict(_tiny_state(one.params, one.batch_stats))
    trainer.frozen_scales = observe_scales(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = trainer.train_step(state, batch, quant_on=True,
                                        freeze_bn=True)
    check_step(before, metrics, two, m2)
    after = model.state_dict()
    for k in before:
        if "running" in k or "num_batches" in k:
            assert torch.equal(after[k], before[k]), k
    np.testing.assert_allclose(
        trainer.frozen_scales["conv1.weight"].flatten().numpy(),
        _np(jscales["conv1"]["kernel"]).flatten(), rtol=ULP, atol=0)
    np.testing.assert_allclose(
        trainer.frozen_scales["linear.weight"].flatten().numpy(),
        _np(jscales["linear"]["kernel"]).flatten(), rtol=ULP, atol=0)


def test_evaluate_quantized_is_the_dequantized_model():
    """``evaluate_quantized`` with frozen scales equals ``evaluate`` of a
    model holding ``dequantize_tree(quantize_tree(p))``: accuracies and
    every prediction."""
    import copy

    from iif_torch.data.loader import eval_batches
    from iif_torch.quant import (dequantize_tree, observe_scales,
                                 quantize_tree)

    model = _port_model(None, seed=6)
    trainer = _port(model, ("ce", False), torch.float32, None, LR,
                    MOMENTUM, WD, None)
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (20, SIZE, SIZE, 3)).astype(np.uint8)
    labels = rng.randint(0, C, 20).astype(np.int64)
    trainer.frozen_scales = observe_scales(model)
    res_q = trainer.evaluate_quantized(eval_batches(images, labels, B),
                                       print_fn=lambda *a: None)
    q, s = quantize_tree(model, scales=trainer.frozen_scales)
    deq = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in deq.named_parameters():
            p.copy_(dequantize_tree(model, q, s)[k])
    trainer.model = deq
    res_d = trainer.evaluate(eval_batches(images, labels, B),
                             print_fn=lambda *a: None)
    assert res_q["acc1"] == res_d["acc1"]
    np.testing.assert_array_equal(res_q["preds"], res_d["preds"])


def test_calibration_matches_jax():
    """ECE, MCE, the bins' accuracies, confidences and counts (a
    confidence of 0 in no bin, 1 in the last)."""
    from iif_tpu.engine.calibration import compute_calibration as jax_cal

    from iif_torch.engine.calibration import compute_calibration

    rng = np.random.RandomState(8)
    labels = rng.randint(0, 5, 200)
    preds = np.where(rng.rand(200) < 0.6, labels, rng.randint(0, 5, 200))
    conf = rng.rand(200)
    conf[:3] = [0.0, 1.0, 0.3]
    for bins in (10, 15):
        got = compute_calibration(labels, preds, conf, bins)
        want = jax_cal(labels, preds, conf, bins)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_train_quantization_cli_runs_qat_and_ptq(tmp_path, monkeypatch,
                                                 capsys):
    """``python -m iif_torch.cli.train_quantization`` on the CPU, small
    (the synthetic stand-in at 8 images a class, 16x16, ResNet-20), with
    the recipe flags the port took up (``--auto-augment cifar
    --random-erase 0.25 --opt rmsprop``): 3 epochs, BN frozen from epoch
    1 (the running statistics of ``epoch_1.pth`` and ``epoch_3.pth``
    equal, the weights moved), then ``--post-training-quantize
    --load_from`` prints its Acc@1 and writes no checkpoint."""
    import os

    from iif_torch.cli import train
    from iif_torch.cli import train_quantization as tq
    from iif_torch.data import cifar_lt

    monkeypatch.setattr(train, "make_synthetic_cifar",
                        lambda n, c, seed=0: cifar_lt.make_synthetic_cifar(
                            8 if n == 500 else 2, c, seed=seed, size=16))
    base = ["--dset_name", "synthetic", "--model", "resnet20", "-b", "64",
            "--device", "cpu", "--print-freq", "0", "-j", "1"]
    out = str(tmp_path / "qat")
    tq.main(tq.get_args_parser().parse_args(base + [
        "--epochs", "3", "--qat-freeze-bn", "1", "--qat-freeze-observer",
        "2", "--auto-augment", "cifar", "--random-erase", "0.25", "--opt",
        "rmsprop", "--lr", "0.01", "--output-dir", out]))
    ckpt = lambda n: torch.load(os.path.join(  # noqa: E731
        out, "checkpoints", f"epoch_{n}.pth"),
        weights_only=True)["state_dict"]
    one, three = ckpt(1), ckpt(3)
    for k in one:
        if "running" in k:
            assert torch.equal(one[k], three[k]), k
    assert not torch.equal(one["layer2.0.conv1.weight"],
                           three["layer2.0.conv1.weight"])
    capsys.readouterr()
    acc = tq.main(tq.get_args_parser().parse_args(base + [
        "--post-training-quantize", "--load_from",
        os.path.join(out, "checkpoints"), "--output-dir",
        str(tmp_path / "ptq")]))
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if "Acc@1" in ln]
    assert len(printed) == 1 and f"{acc:.3f}" in printed[0]
    assert not os.path.exists(tmp_path / "ptq" / "checkpoints")
