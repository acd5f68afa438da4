"""``fresh_init_`` against the JAX package's ``model.init``, one module
family at a time at small widths (no whole-detector JAX compile): every
port tensor pairs with one JAX variable of as many elements, a constant
one (BN statistics, zeros, ``cls_init``'s constant) must be equal
exactly, a random one must have a mean within 10% of JAX's standard
deviation of JAX's mean and a standard deviation within 10% of JAX's. The
two draw from different generators, so distributions are compared, not
bits. Then ``trainer_from_config`` starts from ``fresh_init_``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection.bbox_head import Shared2FCBBoxHead
from iif_torch.detection.c4 import C4BBoxHead
from iif_torch.detection.init import fresh_init_
from iif_torch.detection.losses import DetCrossEntropyLoss
from iif_torch.detection.mask_head import FCNMaskHead
from iif_torch.detection.necks import FPN
from iif_torch.detection.rpn import RPNHead
from iif_torch.engine.detection import trainer_from_config
from iif_torch.models.resnet import ResLayer, ResNet

torch.set_num_threads(1)

REL = 0.1
LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
        "mean": "running_mean", "var": "running_var"}
C4_CONFIG = "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py"
IIF_CONFIG = "configs/iif/iif_r50_1x.py"


def _trunk_name(mods):
    """flax ResNet / ResLayer module path -> mmdet's."""
    out = []
    for m in mods:
        if m.startswith("layer") and "_" in m:
            stage, block = m[len("layer"):].split("_")
            out += [f"layer{stage}", block]
        elif m == "downsample_conv":
            out.append("downsample.0")
        elif m == "downsample_bn":
            out.append("downsample.1")
        else:
            out.append(m)
    return out


def _neck_name(mods):
    kind, i = mods[0].rsplit("_", 1)
    return [f"{'lateral_convs' if kind == 'lateral' else 'fpn_convs'}.{i}",
            "conv"]


def _bbox_name(mods):
    return [{"shared_fc1": "shared_fcs.0",
             "shared_fc2": "shared_fcs.1"}.get(mods[0], mods[0])]


def _mask_name(mods):
    m = mods[0]
    if m.startswith("conv") and m[4:].isdigit():
        return [f"convs.{m[4:]}", "conv"]
    return [m]


def _jax_tensors(variables, rename):
    """{port name: numpy array} of a flax variables dict."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [p.key for p in path]
        mods, leaf = keys[1:-1], keys[-1]
        out[".".join(rename(mods) + [LEAF[leaf]])] = np.asarray(v)
    return out


def _port_tensors(module):
    fresh_init_(module, torch.Generator().manual_seed(0))
    return {n: t.detach().numpy() for n, t in
            list(module.named_parameters()) + list(module.named_buffers())
            if t.is_floating_point()}


def _compare(port, want):
    """Every tensor as the module docstring says; returns the largest
    relative deviation seen, for the report."""
    assert set(port) == set(want)
    worst = 0.0
    for name, j in want.items():
        p = port[name]
        assert p.size == j.size, name
        if np.all(j == j.flat[0]):
            np.testing.assert_array_equal(p, np.full(p.shape, j.flat[0]),
                                          err_msg=name)
            continue
        std_j = j.std()
        dev = max(abs(p.mean() - j.mean()) / std_j,
                  abs(p.std() - std_j) / std_j)
        assert dev <= REL, (name, p.mean(), p.std(), j.mean(), std_j)
        worst = max(worst, dev)
    return worst


def _init(module, *args, **kw):
    """``module.init`` from a key of XLA's own generator ("rbg"): the
    distributions are flax's, and each new shape compiles in a fraction
    of threefry's time."""
    return module.init(jax.random.key(0, impl="rbg"), *args, **kw)


def test_resnet_trunk_init():
    """The MaskRCNN and C4 trunk cut to its stem and one block of stage 1
    (each new shape costs JAX a compile of its random draw):
    ``variance_scaling(2, fan_out, normal)`` convolutions, BN scale 1 and
    ``bn3`` 0, bias 0, statistics 0 and 1. The res5 test below takes a
    block at full width."""
    from iif_tpu.models.resnet import ResNet as JaxResNet

    want = _jax_tensors(_init(JaxResNet((1, 1, 1, 1), "bottleneck",
                                        frozen_stages=1, norm_eval=True,
                                        num_stages=1),
                              jnp.zeros((1, 16, 16, 3)),
                              return_features=True), _trunk_name)
    port = _port_tensors(ResNet((1, 1, 1, 1), 1, True, num_stages=1))
    _compare(port, want)
    assert np.all(port["layer1.0.bn3.weight"] == 0)
    assert np.all(port["layer1.0.downsample.1.weight"] == 1)


def test_res5_shared_head_init():
    """C4's res5 per RoI (``ResLayer``, one block at full width)."""
    from iif_tpu.models.resnet import ResLayer as JaxResLayer

    want = _jax_tensors(_init(JaxResLayer(n_blocks=1),
                              jnp.zeros((1, 2, 2, 1024))), _trunk_name)
    _compare(_port_tensors(ResLayer(1, True)), want)


def test_fpn_init():
    """``xavier_uniform`` lateral and output convolutions, bias 0, on two
    levels."""
    from iif_tpu.detection.necks import FPN as JaxFPN

    chans = (64, 128)
    inputs = [jnp.zeros((1, 8 // 2 ** i, 8 // 2 ** i, c))
              for i, c in enumerate(chans)]
    want = _jax_tensors(_init(JaxFPN(out_channels=64, num_outs=2), inputs),
                        _neck_name)
    _compare(_port_tensors(FPN(chans, 64, num_outs=2)), want)


@pytest.mark.parametrize("channels,anchors", [(256, 3), (64, 15)])
def test_rpn_head_init(channels, anchors):
    """``normal(0.01)``, bias 0: MaskRCNN's head, and C4's anchor count
    at a narrow width."""
    from iif_tpu.detection.rpn import RPNHead as JaxRPN

    want = _jax_tensors(_init(JaxRPN(feat_channels=channels,
                                     num_anchors=anchors),
                              [jnp.zeros((1, 4, 4, channels))]),
                        lambda mods: mods)
    _compare(_port_tensors(RPNHead(channels, channels, anchors)), want)


@pytest.mark.parametrize("cls_init", [("constant", 0.001), ("normal", 0.01),
                                      ("constant", 0.001, -6.5)])
def test_bbox_head_init(cls_init):
    """Shared FCs ``lecun_normal`` (truncated), ``fc_cls`` from
    ``cls_init`` (the headline config's constant 0.001; normal; a bias
    value third), ``fc_reg`` ``normal(0.001)``."""
    from iif_tpu.detection.bbox_head import Shared2FCBBoxHead as JaxHead

    want = _jax_tensors(_init(JaxHead(80, cls_init=cls_init),
                              jnp.zeros((2, 7, 7, 16))), _bbox_name)
    port = _port_tensors(Shared2FCBBoxHead(80, 16, cls_init=cls_init))
    _compare(port, want)
    bias = cls_init[2] if len(cls_init) > 2 else 0.0
    assert np.all(port["fc_cls.bias"] == np.float32(bias))


def test_mask_head_init():
    """Convolutions ``variance_scaling(2, fan_out, normal)``, the
    transposed convolution ``lecun_normal``, ``conv_logits``
    ``normal(0.001)``, biases 0."""
    from iif_tpu.detection.mask_head import FCNMaskHead as JaxMask

    want = _jax_tensors(_init(JaxMask(80, conv_out_channels=64),
                              jnp.zeros((2, 14, 14, 64))), _mask_name)
    _compare(_port_tensors(FCNMaskHead(80, 64, conv_out_channels=64)), want)


def test_c4_bbox_head_init():
    """``fc_cls`` ``normal(0.01)``, ``fc_reg`` ``normal(0.001)``."""
    from iif_tpu.detection.c4 import C4BBoxHead as JaxC4Head

    want = _jax_tensors(_init(JaxC4Head(80), jnp.zeros((2, 7, 7, 2048))),
                        lambda mods: mods)
    _compare(_port_tensors(C4BBoxHead(80)), want)


def test_module_of_no_family_raises():
    """A tensor that no family covers raises; the trainer test below
    covers every tensor of both detectors."""
    with pytest.raises(NotImplementedError, match="no fresh init"):
        fresh_init_(torch.nn.Sequential(torch.nn.Linear(2, 2)),
                    torch.Generator())


@pytest.mark.parametrize("config", [IIF_CONFIG, C4_CONFIG])
def test_trainer_starts_from_fresh_init(config):
    """``trainer_from_config`` draws JAX's families for every tensor of
    the detector (``fresh_init_`` raises otherwise): BN statistics 0 and
    1, ``bn3`` 0, the headline config's ``fc_cls`` 0.001 (its
    ``cls_init``, which ``MaskRCNN`` passes on), C4's ``normal(0.01)``."""
    cfg = Config.fromfile(config)
    trainer = trainer_from_config(cfg, DetCrossEntropyLoss(3), 100,
                                  device="cpu")
    sd = trainer.model.state_dict()
    assert torch.all(sd["backbone.layer1.0.bn3.weight"] == 0)
    assert torch.all(sd["backbone.layer3.0.bn1.running_var"] == 1)
    assert torch.all(sd["backbone.bn1.running_mean"] == 0)
    cls = sd["roi_head.bbox_head.fc_cls.weight"]
    if config == IIF_CONFIG:
        assert torch.all(cls == 0.001)
    else:
        assert abs(cls.std().item() - 0.01) < 0.001
