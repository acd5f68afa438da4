"""The classification data path of the port against ``iif_tpu`` on the
CPU: long-tailed CIFAR (counts, the imbalanced selection, the pickle
loader, the synthetic stand-in), the txt-list datasets with PNG images,
the epoch samplers, ``Loader`` and ``eval_batches`` (all equal), the
augmentations on JAX's own draws, the LR schedules (within 1 f32 ulp) and
the decoupled head's mask and re-initialisation."""
import os
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


# ------------------------------------------------------------- datasets
@pytest.mark.parametrize("imb_type,factor", [("exp", 0.01), ("exp", 0.1),
                                             ("step", 0.1), ("none", 1.0)])
def test_img_num_per_cls_and_imbalanced_arrays_equal(imb_type, factor):
    from iif_tpu.data import cifar_lt as jax_cifar

    from iif_torch.data import cifar_lt

    assert cifar_lt.img_num_per_cls(5000, 10, imb_type, factor) == \
        jax_cifar.img_num_per_cls(5000, 10, imb_type, factor)
    data, targets = cifar_lt.make_synthetic_cifar(20, 10, seed=4, size=4)
    jdata, jtargets = jax_cifar.make_synthetic_cifar(20, 10, seed=4, size=4)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(targets, jtargets)
    got = cifar_lt.ImbalancedArrays(data, targets, 10, imb_type, factor, 7)
    want = jax_cifar.ImbalancedArrays(data, targets, 10, imb_type, factor, 7)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.targets == want.targets
    assert got.get_cls_num_list() == want.get_cls_num_list()


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_load_cifar_equal(tmp_path, name):
    """The pickle layout of both CIFARs, written small."""
    from iif_tpu.data.cifar_lt import load_cifar as jax_load

    from iif_torch.data.cifar_lt import load_cifar

    rng = np.random.RandomState(0)

    def dump(path, n, key):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072)).astype(
                np.uint8), key: rng.randint(0, 10, n).tolist()}, f)

    if name == "cifar100":
        for split in ("train", "test"):
            dump(str(tmp_path / "cifar-100-python" / split), 6, "fine_labels")
    else:
        for i in range(1, 6):
            dump(str(tmp_path / "cifar-10-batches-py" / f"data_batch_{i}"),
                 3, "labels")
        dump(str(tmp_path / "cifar-10-batches-py" / "test_batch"), 4,
             "labels")
    for train in (True, False):
        got = load_cifar(str(tmp_path), name, train)
        want = jax_load(str(tmp_path), name, train)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _write_lt(root, n_classes=7):
    """A train list with tied class counts and an eval list, over PNGs."""
    from iif_torch.detection.image_io import write_png

    rng = np.random.RandomState(1)
    counts = [3, 5, 1, 5, 2, 0, 3]
    lines, paths = [], []
    for i in range(6):
        name = f"img/{i}.png"
        os.makedirs(os.path.join(root, "img"), exist_ok=True)
        write_png(os.path.join(root, name),
                  rng.randint(0, 256, (5, 6, 3)).astype(np.uint8))
        paths.append(name)
    for c, n in enumerate(counts):
        lines += [f"{paths[(c + k) % 6]} {c}" for k in range(n)]
    rng.shuffle(lines)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
    with open(os.path.join(root, "eval.txt"), "w") as f:
        f.write("\n".join(f"{paths[c % 6]} {c}" for c in range(n_classes)))


def test_lt_datasets_equal(tmp_path):
    """Class map (ties by ascending id), targets, counts, the eval split's
    map and the decoded images (the port's PNG decoder against PIL)."""
    from iif_tpu.data import lt_dataset as jax_lt

    from iif_torch.data import lt_dataset

    _write_lt(str(tmp_path))
    root, tr, ev = str(tmp_path), str(tmp_path / "train.txt"), \
        str(tmp_path / "eval.txt")
    got, want = lt_dataset.LTDataset(root, tr, 7), jax_lt.LTDataset(root, tr,
                                                                     7)
    assert got.class_map == want.class_map
    assert got.targets == want.targets
    assert got.get_cls_num_list() == want.get_cls_num_list()
    gev = lt_dataset.LTDatasetEval(root, ev, got.class_map, 7)
    wev = jax_lt.LTDatasetEval(root, ev, want.class_map, 7)
    assert gev.targets == wev.targets and len(gev) == len(wev) == 7
    for i in range(len(got)):
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
    targets = np.random.RandomState(2).randint(0, 9, 200).tolist()
    assert lt_dataset.frequency_class_map(targets, 9) == \
        jax_lt.frequency_class_map(targets, 9)


def test_lt_dataset_refuses_jpeg(tmp_path):
    from iif_torch.data.lt_dataset import LTDataset

    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 16)
    (tmp_path / "t.txt").write_text("a.jpg 0\n")
    ds = LTDataset(str(tmp_path), str(tmp_path / "t.txt"), 1)
    with pytest.raises(NotImplementedError, match="a.jpg"):
        ds.load_image(0)


# ----------------------------------------------------- samplers, loader
@pytest.mark.parametrize("mode", ["random", "upsampling", "downsampling"])
def test_samplers_equal(mode):
    from iif_tpu.data import samplers as jax_samplers

    from iif_torch.data import samplers

    targets = np.repeat(np.arange(5), [9, 4, 2, 7, 1])
    for epoch in (0, 3):
        if mode == "random":
            got = samplers.random_epoch_order(len(targets), epoch, 5)
            want = jax_samplers.random_epoch_order(len(targets), epoch, 5)
        else:
            got = samplers.balanced_epoch_order(targets, epoch, mode, 5)
            want = jax_samplers.balanced_epoch_order(targets, epoch, mode, 5)
        np.testing.assert_array_equal(got, want)


class _Lazy:
    def __init__(self, data):
        self.data = data

    def load_image(self, i):
        return self.data[i]


class _Broken(_Lazy):
    def load_image(self, i):
        if i == 7:
            raise OSError("unreadable image 7")
        return self.data[i]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_reraises_errors_and_leaves_no_thread(prefetch):
    """An image that fails to load raises from the loop, also when the
    prefetch thread read it, and no thread outlives the loop."""
    import threading

    from iif_torch.data.loader import Loader

    data = np.zeros((12, 2, 2, 3), np.uint8)
    before = set(threading.enumerate())
    loader = Loader(_Broken(data), np.arange(12) % 3, 2, prefetch=prefetch)
    with pytest.raises(OSError, match="image 7"):
        list(loader)
    batches = iter(Loader(_Lazy(data), np.arange(12) % 3, 2,
                          prefetch=prefetch))
    next(batches)
    batches.close()
    assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("sampler,drop_last,prefetch,lazy", [
    ("random", True, 0, False), ("random", False, 2, True),
    ("upsampling", True, 2, False), ("downsampling", False, 0, True)])
def test_loader_and_eval_batches_equal(sampler, drop_last, prefetch, lazy):
    from iif_tpu.data.loader import Loader as JaxLoader
    from iif_tpu.data.loader import eval_batches as jax_eval_batches

    from iif_torch.data.loader import Loader, eval_batches

    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, (23, 4, 4, 3)).astype(np.uint8)
    targets = np.repeat(np.arange(4), [10, 6, 4, 3])
    src = _Lazy(data) if lazy else data
    got = Loader(src, targets, 5, sampler, seed=2, drop_last=drop_last,
                 prefetch=prefetch)
    want = JaxLoader(src, targets, 5, sampler, seed=2, drop_last=drop_last,
                     prefetch=prefetch)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert len(got) == len(want)
        gb, wb = list(got), list(want)
        assert len(gb) == len(wb) == len(got)
        for g, w in zip(gb, wb):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    gb = list(eval_batches(src, targets, 6))
    wb = list(jax_eval_batches(src, targets, 6))
    assert len(gb) == len(wb) == 4
    for g, w in zip(gb, wb):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert gb[-1]["valid"].sum() == 5


# ------------------------------------------------------------- augment
def _images(b=3, h=12, w=10, seed=0):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_crop_flip_normalize_on_jax_draws():
    """CIFAR's crop (padding 4) and flip on JAX's draws, equal; to_float
    and normalize within 1 f32 ulp (XLA multiplies by 1/255)."""
    from iif_tpu.data import augment as ja

    from iif_torch.data import augment

    x = _images()
    key = jax.random.PRNGKey(5)
    ky, kx = jax.random.split(key)
    oy = jax.random.randint(ky, (3,), 0, 9)
    ox = jax.random.randint(kx, (3,), 0, 9)
    want = jax.jit(ja.random_crop)(key, jnp.asarray(x))
    got = augment.random_crop(_t(x), _t(oy), _t(ox), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flip = jax.random.bernoulli(key, 0.5, (3,))
    want = jax.jit(ja.random_hflip)(key, jnp.asarray(x))
    got = augment.random_hflip(_t(x), _t(flip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u8 = np.random.RandomState(1).randint(0, 256, (2, 5, 5, 3)).astype(
        np.uint8)
    mean, std = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
    want = jax.jit(partial(ja.cifar_eval_transform, mean=mean, std=std))(
        jnp.asarray(u8))
    got = augment.cifar_eval_transform(_t(u8), mean, std)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=3e-7)


def _jax_rrc_box(key, b, h, w, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """``random_resized_crop``'s box from its key, as it draws it."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = h * w * jax.random.uniform(k1, (b,), minval=scale[0],
                                      maxval=scale[1])
    log_r = jax.random.uniform(k2, (b,), minval=jnp.log(ratio[0]),
                               maxval=jnp.log(ratio[1]))
    r = jnp.exp(log_r)
    cw = jnp.clip(jnp.sqrt(area * r), 8.0, w)
    ch = jnp.clip(jnp.sqrt(area / r), 8.0, h)
    y0 = jax.random.uniform(k3, (b,)) * (h - ch)
    x0 = jax.random.uniform(k4, (b,)) * (w - cw)
    return {"y0": _t(y0), "x0": _t(x0), "ch": _t(ch), "cw": _t(cw)}


@pytest.mark.parametrize("size", [6, 20])
def test_random_resized_crop_on_jax_box(size):
    """``jax.image.scale_and_translate`` bilinear, antialiased: boxes
    larger than ``size`` (downscaling) at 6, smaller (upscaling) at 20.
    XLA on the CPU contracts ``compute_weight_mat``'s sample positions
    ``(i + 0.5) * inv_scale - t * inv_scale`` into a fused multiply-add;
    the port rounds the product as the source reads, so weights differ
    by up to 2 ulps (1.9e-6) and pixels by up to 3.9e-6 (measured)."""
    from iif_tpu.data import augment as ja

    from iif_torch.data import augment

    x = _images(4, 24, 18, seed=2)
    key = jax.random.PRNGKey(7)
    want = jax.jit(partial(ja.random_resized_crop, size=size))(
        key, jnp.asarray(x))
    box = _jax_rrc_box(key, 4, 24, 18)
    got = augment.random_resized_crop(_t(x), box, size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=6e-6)
    down = (box["ch"] > size).any() if size == 6 else (box["ch"] < size).all()
    assert bool(down)


def test_color_jitter_with_hue_on_jax_draws():
    """Brightness, contrast, saturation and the YIQ hue rotation (iNat18's
    hue 0.25) on JAX's factors; within 2e-6."""
    from iif_tpu.data import augment as ja

    from iif_torch.data import augment

    x = _images(3, 6, 5, seed=4)
    key = jax.random.PRNGKey(11)
    want = jax.jit(partial(ja.color_jitter, brightness=0.4, contrast=0.4,
                           saturation=0.4, hue=0.25))(key, jnp.asarray(x))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draw = {name: _t(jax.random.uniform(k, (3, 1, 1, 1), minval=0.6,
                                        maxval=1.4))
            for name, k in (("brightness", k1), ("contrast", k2),
                            ("saturation", k3))}
    draw["hue"] = _t(jax.random.uniform(k4, (3, 1, 1), minval=-0.25,
                                        maxval=0.25))
    got = augment.color_jitter(_t(x), draw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_imagenet_eval_transform_and_draws():
    """The eval center crop and normalization; the port's own draws:
    shapes, ranges, and the same draws from the same seed."""
    from iif_tpu.data import augment as ja

    from iif_torch.data import augment

    u8 = np.random.RandomState(3).randint(0, 256, (2, 9, 11, 3)).astype(
        np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = jax.jit(partial(ja.imagenet_eval_transform, mean=mean, std=std,
                           size=6))(jnp.asarray(u8))
    got = augment.imagenet_eval_transform(_t(u8), mean, std, size=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=3e-7)
    draws = [augment.draw_imagenet(torch.Generator().manual_seed(1), 5, 30,
                                   20, "cpu", hue=0.25) for _ in range(2)]
    for a, b in zip(torch.utils._pytree.tree_leaves(draws[0]),
                    torch.utils._pytree.tree_leaves(draws[1])):
        assert torch.equal(a, b)
    crop = draws[0]["crop"]
    assert ((crop["ch"] >= 8) & (crop["ch"] <= 30)).all()
    assert ((crop["y0"] >= 0) & (crop["y0"] + crop["ch"] <= 30)).all()
    assert ((draws[0]["jitter"]["hue"].abs() <= 0.25)).all()
    x = torch.randint(0, 256, (5, 30, 20, 3), dtype=torch.uint8)
    out = augment.imagenet_train_augment(x, draws[0], mean, std, size=16)
    assert out.shape == (5, 16, 16, 3) and torch.isfinite(out).all()


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("kind", ["cosine", "step", "cosine_no_warmup"])
def test_schedules_within_one_ulp(kind):
    """Every step's rate within 1 f32 ulp of the base rate (the cosine
    factor's ``1 + cos`` near -1 turns XLA's and NumPy's f32 ``cos``, an
    ulp apart, into 3 ulps of a rate of 0.019: 0.37 ulp of 0.2)."""
    from iif_tpu.engine.schedules import build_lr_schedule as jax_schedule

    from iif_torch.engine.schedules import build_lr_schedule

    kw = {"cosine": dict(cosine=True), "step": dict(milestones=[2, 4]),
          "cosine_no_warmup": dict(cosine=True, warmup=False)}[kind]
    want = jax.jit(jax.vmap(jax_schedule(0.2, 7, 5, **kw)))(
        jnp.arange(40))
    got = build_lr_schedule(0.2, 7, epochs=5, **kw)
    got = np.asarray([got(s) for s in range(40)], np.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=np.spacing(np.float32(0.2)))


def test_classifier_mask_and_head_reinit():
    """``--decoup``: the head's parameters are the trainable ones, its
    weight re-drawn ``xavier_uniform`` and its bias 0.01."""
    from iif_torch.engine.schedules import (
        classifier_mask,
        freeze_all_but_head,
        reinit_classifier_head,
    )
    from iif_torch.models.factory import build_classifier

    model = build_classifier("resnet20", 10)
    mask = classifier_mask(model)
    assert [k for k, v in mask.items() if v] == ["linear.weight",
                                                 "linear.bias"]
    freeze_all_but_head(model)
    assert [n for n, p in model.named_parameters() if p.requires_grad] == \
        ["linear.weight", "linear.bias"]
    reinit_classifier_head(model, seed=1)
    w = model.linear.weight
    limit = (6.0 / (64 + 10)) ** 0.5
    assert w.abs().max() <= limit and w.abs().max() > 0.8 * limit
    assert torch.equal(model.linear.bias, torch.full((10,), 0.01))
    cos = build_classifier("resnet50", 5, "lr_cosine")
    assert [k for k, v in classifier_mask(cos).items() if v] == [
        "fc.weight", "fc.scale"]
