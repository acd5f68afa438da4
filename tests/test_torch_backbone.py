"""Trunk parity against the JAX package: a few-layer bottleneck ResNet and
the full 256-wide FPN, on the same seeded weights (every parameter
randomised, the residual ``bn3`` scale included) and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iif_torch.detection.necks import FPN
from iif_torch.models.resnet import ResNet
from tests.test_torch_convert import random_mmdet_state

torch.set_num_threads(1)


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_resnet_matches_jax(dtype):
    """f32: rel 1e-4 per stage output. bf16 trunk (f32 parameters, BN in
    f32): rel 3e-2, since each of the 13 convolutions and BNs rounds to
    bf16 (2^-8 relative) and the two frameworks round at other places."""
    from iif_tpu.models.pretrained import convert_torch_resnet
    from iif_tpu.models.resnet import ResNet as JaxResNet

    tdt = None if dtype is None else torch.bfloat16
    model = ResNet(layers=(1, 1, 1, 1), compute_dtype=tdt).eval()
    state = random_mmdet_state(model, np.random.RandomState(0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params, stats = convert_torch_resnet(state)
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)

    jm = JaxResNet(layers=(1, 1, 1, 1), block="bottleneck",
                   dtype=None if dtype is None else jnp.bfloat16)
    want = jax.jit(lambda v, x: jm.apply(v, x, False, return_features=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.inference_mode():
        got = model(_nchw(x))
    tol = 1e-4 if dtype is None else 3e-2
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        assert _rel_err(_nhwc(g), w) < tol


def test_fpn_matches_jax_on_odd_sizes():
    """Full 256-wide FPN on C2..C5 maps of odd sizes, so the repeat-x2-
    then-crop of the top-down path is exercised. rel 1e-4."""
    from iif_tpu.detection.necks import FPN as JaxFPN

    rng = np.random.RandomState(2)
    model = FPN().eval()
    state = random_mmdet_state(model, rng)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = {}
    for k, v in state.items():
        kind, i, _, leaf = k.split(".")
        name = f"lateral_{i}" if kind == "lateral_convs" else f"fpn_conv_{i}"
        params.setdefault(name, {})[
            "kernel" if leaf == "weight" else "bias"] = (
            v.transpose(2, 3, 1, 0) if leaf == "weight" else v)
    sizes = [(25, 37), (13, 19), (7, 10), (4, 5)]
    xs = [rng.randn(1, h, w, c).astype(np.float32)
          for (h, w), c in zip(sizes, (256, 512, 1024, 2048))]
    want = JaxFPN(out_channels=256, num_outs=5).apply(
        {"params": params}, [jnp.asarray(x) for x in xs])
    with torch.inference_mode():
        got = model([_nchw(x) for x in xs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape
        assert _rel_err(_nhwc(g), w) < 1e-4
