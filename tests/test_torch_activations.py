"""The paper's activations study (``configs/activations/``: sigmoid,
softmax and IIF across trunks and detector families) on the port, against
the JAX package on the CPU:

- ``DetCrossEntropyLoss(use_sigmoid=True)``: the loss and its gradient in
  the logits (f32 and bf16 logits, weighted or not, both reductions)
  within 1e-6 relative of JAX's, ``per_class_sums`` likewise, and a
  softmax at inference. JAX's loss is closed over, never passed through
  a JAX transform as an argument: its pytree keeps ``num_classes`` and
  ``loss_weight`` only, so a round trip turns it into softmax CE (shown
  below, a JAX-side hazard no JAX path reaches);
- the ResNeXt-101 32x4d detection trunk (``backbone_type="resnext32x4d"``:
  groups 32, width 4) at depth (1, 1, 1, 1) against JAX's
  ``build_backbone``: the four stage outputs within 1e-5 of their largest
  magnitude, its grouped kernels carried by the converter;
- every config under ``configs/activations/`` (17 files) through
  ``build_detector``, ``build_loss_cls``, ``trainer_from_config`` and both
  CLIs' ``refuse_unported``, on the ``meta`` device;
- the full-width HTC R101, MaskRCNN X101 and sigmoid cascade R50 (1203
  classes): the port's parameter names and shapes against
  ``jax.eval_shape`` of JAX's ``init`` through the converters."""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection import detector as td
from iif_torch.detection.cascade import CascadeMaskRCNN
from iif_torch.detection.convert import (
    _resnet,
    cascade_state_from_jax,
    htc_state_from_jax,
    maskrcnn_state_from_jax,
)
from iif_torch.detection.htc import HTC
from iif_torch.detection.losses import DetCrossEntropyLoss, DetIIFLoss
from iif_torch.models.resnet import ResNet
from tests.test_torch_c4 import _randomise

torch.set_num_threads(1)

CONFIGS = sorted(glob.glob("configs/activations/**/*.py", recursive=True))
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("weighted", [True, False])
def test_sigmoid_ce_matches_jax(reduction, weighted):
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE

    rng = np.random.RandomState(5 + weighted)
    logits = (rng.randn(40, 9) * 3 - 4).astype(np.float32)
    labels = rng.randint(0, 9, 40)
    w = (rng.rand(40) < 0.8).astype(np.float32) if weighted else None
    kw = {} if w is None else {"avg_factor": float(w.sum()) + 3.0}
    jloss = JaxCE(8, loss_weight=0.5, use_sigmoid=True)
    loss = DetCrossEntropyLoss(8, loss_weight=0.5, use_sigmoid=True)
    assert not loss.custom_activation
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        x = torch.from_numpy(logits).to(dt).requires_grad_(True)
        got = loss(x, torch.from_numpy(labels),
                   None if w is None else torch.from_numpy(w),
                   reduction=reduction, **kw)
        got.sum().backward()

        def f(z):
            out = jloss(z, jnp.asarray(labels),
                        None if w is None else jnp.asarray(w),
                        reduction=reduction, **kw)
            return out.sum(), out

        (_, want), grad = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(logits).astype(jdt))
        assert got.dtype == torch.float32 and x.grad.dtype == dt
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(
            grad.astype(jnp.float32)), rtol=1e-6, atol=1e-7)
    per_class = loss.per_class_sums(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(per_class.numpy(), np.asarray(
        jloss.per_class_sums(jnp.asarray(logits), jnp.asarray(labels),
                             None if w is None else jnp.asarray(w))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        loss.get_activation(torch.from_numpy(logits)).numpy(),
        np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), rtol=1e-6,
        atol=1e-7)


def test_sigmoid_is_not_softmax_and_jax_pytree_drops_it():
    """The two losses differ on the same logits; JAX's pytree round trip
    of the sigmoid loss gives a softmax one, which is why every JAX call
    above and in ``tests/test_torch_htc.py`` closes over its loss."""
    from iif_tpu.detection.losses import DetCrossEntropyLoss as JaxCE

    logits = torch.tensor([[2.0, -1.0, 0.5], [-3.0, 1.5, 0.0]])
    labels = torch.tensor([0, 2])
    sig = DetCrossEntropyLoss(2, use_sigmoid=True)(logits, labels)
    soft = DetCrossEntropyLoss(2)(logits, labels)
    assert abs(sig.item() - soft.item()) > 0.1
    leaves, tree = jax.tree_util.tree_flatten(JaxCE(2, use_sigmoid=True))
    assert not jax.tree_util.tree_unflatten(tree, leaves).use_sigmoid


def test_resnext_trunk_matches_jax():
    """``resnext32x4d`` at depth (1, 1, 1, 1), f32, eval mode, every
    leaf randomised: the port's ResNet (groups 32, width 4) through
    ``_resnet`` against ``iif_tpu``'s ``build_backbone``."""
    from iif_tpu.detection.detector import build_backbone

    assert td.resnet_groups("resnext32x4d") == (32, 4)
    assert td.resnet_groups("resnet") == (1, 64)
    with pytest.raises(NotImplementedError, match="'regnetx_400mf'"):
        td.resnet_groups("regnetx_400mf")
    jnet = build_backbone("resnext32x4d", depth=50)
    jnet = jnet.clone(layers=(1, 1, 1, 1))
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(x), return_features=True))
    variables = _randomise(shapes, np.random.RandomState(2))
    fn = jax.jit(lambda v, z: jnet.apply(v, z, train=False,
                                         return_features=True))
    want = fn.lower(variables, jnp.asarray(x)).compile(
        compiler_options=FAST)(variables, jnp.asarray(x))
    sd = {}
    _resnet(sd, "b", variables["params"], variables["batch_stats"])
    net = ResNet((1, 1, 1, 1), groups=32, width_per_group=4).eval()
    net.load_state_dict({k[2:]: v for k, v in sd.items()})
    assert net.layer1[0].conv2.weight.shape == (128, 4, 3, 3)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   rtol=0)


class _Counts:
    """The dataset side of ``build_loss_cls``: LVIS-like counts."""
    num_images_total = 100170
    CLASSES = [str(i) for i in range(1203)]

    def class_image_counts(self):
        return np.arange(1, 1204)

    def __len__(self):
        return self.num_images_total


@pytest.mark.parametrize("config", CONFIGS)
def test_every_activations_config_builds(config, monkeypatch):
    """The model, the loss and the trainer of each config as it stands
    (on ``meta``: shapes, no storage, no fresh draws), and both CLIs'
    refusals let it through."""
    from iif_torch.cli import test_det, train_det
    from iif_torch.detection.inference import build_loss_cls
    from iif_torch.engine import detection as engine

    assert len(CONFIGS) == 17
    cfg = Config.fromfile(config)
    train_det.refuse_unported(cfg, train_det.parse_args([config]), 0)
    test_det.refuse_unported(test_det.parse_args([config, "ckpt.pth"]))
    loss = build_loss_cls(cfg.loss_cls, _Counts(), 1203)
    sigmoid = cfg.loss_cls.get("use_sigmoid", False)
    assert isinstance(loss, DetIIFLoss if "iif" in config
                      else DetCrossEntropyLoss)
    assert getattr(loss, "use_sigmoid", False) == sigmoid
    monkeypatch.setattr(engine, "fresh_init_", lambda m, g: m)
    monkeypatch.setattr(engine, "resolve_device",
                        lambda d: torch.device("meta"))
    with torch.device("meta"):
        trainer = engine.trainer_from_config(cfg, loss, 1000, device="cpu")
    m = trainer.model
    kind = {"HTC": HTC, "CascadeMaskRCNN": CascadeMaskRCNN}.get(
        cfg.model.get("type"), td.MaskRCNN)
    assert type(m) is kind and m.num_classes == 1203
    assert m.backbone.layer2[0].conv2.groups == (
        32 if "x101" in config else 1)
    assert len(m.backbone.layer3) == (23 if "101" in config else 6)
    assert trainer.grad_clip == (35 if kind is not td.MaskRCNN else None)
    heads = m.roi_head.bbox_head
    head = heads[0] if isinstance(heads, torch.nn.ModuleList) else heads
    assert head.cls_init == tuple(cfg.model["cls_init"])


@pytest.mark.parametrize("name", ["htc_r101", "maskrcnn_x101",
                                  "cascade_r50"])
def test_full_width_names_and_shapes_match_jax(name):
    """At 1203 classes and full depth: the port's state_dict has exactly
    the names and shapes the converter makes of JAX's ``init`` shapes
    (stage 0's ``conv_res`` dropped for HTC, grouped kernels for X101)."""
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection.cascade import CascadeMaskRCNN as JaxCascade
    from iif_tpu.detection.htc import HTC as JaxHTC

    jax_cls, port_cls, convert, kw = {
        "htc_r101": (JaxHTC, HTC, htc_state_from_jax, dict(depth=101)),
        "maskrcnn_x101": (jd.MaskRCNN, td.MaskRCNN, maskrcnn_state_from_jax,
                          dict(depth=101, backbone_type="resnext32x4d")),
        "cascade_r50": (JaxCascade, CascadeMaskRCNN, cascade_state_from_jax,
                        dict(depth=50))}[name]
    kw = dict(kw, num_classes=1203)
    shapes = jax.eval_shape(lambda: jax_cls(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = convert(zeros["params"], zeros["batch_stats"])
    with torch.device("meta"):
        port = {k: tuple(v.shape) for k, v in
                port_cls(**kw).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == port
    if name == "htc_r101":
        assert "roi_head.mask_head.0.conv_res.conv.weight" not in port
        assert port["roi_head.mask_head.2.conv_res.conv.weight"] == (
            256, 256, 1, 1)
    if name == "maskrcnn_x101":
        assert port["backbone.layer4.2.conv2.weight"] == (1024, 32, 3, 3)
