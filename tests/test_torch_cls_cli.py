"""``python -m iif_torch.cli.train`` on the CPU (``--device cpu``), small:
a one-epoch synthetic CIFAR-100-LT run with IIF that ``--test-only
--load_from`` reproduces exactly, a ``--decoup`` run that leaves the trunk
as it loaded it, and the north-star recipe's three calls (stage 1 cosine
head + mixup with ``--bn-groups 2``, stage 2 ``--classif iif --iif smooth
--decoup``, the post-hoc ``--test-only``) on ``imagenet_lt`` lists over a
few 224x224 PNGs at depth (1, 1, 1, 1); a JPEG in the train list raises
through the prefetch thread; the unported flags (``--world-size``,
``--dist-url``, ``--pretrained``) raise."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _run(argv, workers=1):
    from iif_torch.cli import train

    return train.main(train.get_args_parser().parse_args(
        argv + ["--device", "cpu", "--print-freq", "0", "-j", str(workers)]))


def _state(path):
    return torch.load(os.path.join(path, "checkpoints", "latest.pth"),
                      weights_only=True)["state_dict"]


@pytest.fixture
def small_data(monkeypatch):
    """The synthetic stand-in at 20 images a class (5 to evaluate), 16x16;
    the ImageNet ResNets at depth (1, 1, 1, 1)."""
    from iif_torch.cli import train
    from iif_torch.data import cifar_lt
    from iif_torch.models import factory
    from iif_torch.models.resnet import ResNet

    def synthetic(n, cls_num, seed=0):
        return cifar_lt.make_synthetic_cifar(20 if n == 500 else 5, cls_num,
                                             seed=seed, size=16)

    monkeypatch.setattr(train, "make_synthetic_cifar", synthetic)
    monkeypatch.setitem(factory._CLASSIFIER_MODELS, "se_resnet50",
                        lambda **kw: ResNet((1, 1, 1, 1), use_se=True, **kw))


def _write_lists(root):
    from iif_torch.detection.image_io import write_png

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    for i in range(6):
        write_png(os.path.join(root, "train", f"{i}.png"),
                  rng.randint(0, 256, (224, 224, 3)).astype(np.uint8))
    labels = [3, 3, 3, 7, 7, 9]
    with open(os.path.join(root, "lt_train.txt"), "w") as f:
        f.writelines(f"train/{i}.png {c}\n" for i, c in enumerate(labels))
    with open(os.path.join(root, "lt_eval.txt"), "w") as f:
        f.writelines(f"train/{i}.png {c}\n" for i, c in
                     ((0, 3), (3, 7), (5, 9)))


def test_cli_trains_tests_decouples_and_runs_the_recipe(tmp_path,
                                                       small_data):
    base = ["--dset_name", "synthetic", "--model", "resnet20", "--classif",
            "iif", "--iif", "raw", "--imb_factor", "0.1", "-b", "64"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    best = _run(base + ["--epochs", "1", "--cosine_scheduler",
                        "--output-dir", a, "--record-result"])
    assert os.path.exists(os.path.join(a, "results.csv"))
    ckpt = torch.load(os.path.join(a, "checkpoints", "epoch_1.pth"),
                      weights_only=True)
    assert ckpt["meta"]["epoch"] == 1 and ckpt["meta"]["args"]["epochs"] == 1
    assert _run(base + ["--test-only", "--load_from",
                        os.path.join(a, "checkpoints"), "--output-dir",
                        str(tmp_path / "t")]) == best
    _run(base + ["--epochs", "1", "--decoup", "--lr", "0.05", "--load_from",
                 os.path.join(a, "checkpoints"), "--output-dir", b])
    before, after = _state(a), _state(b)
    for k, v in before.items():
        if k.startswith("linear."):
            assert not torch.equal(after[k], v), k
        elif "running" in k:
            assert not torch.equal(after[k], v), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(after[k], v), k

    root = str(tmp_path / "lt")
    _write_lists(root)
    lt = ["--dset_name", "imagenet_lt", "--data-path", root, "--train-txt",
          os.path.join(root, "lt_train.txt"), "--eval-txt",
          os.path.join(root, "lt_eval.txt"), "--model", "se_resnet50", "-b",
          "4", "--classif_norm", "cosine"]
    s1, s2 = os.path.join(root, "s1"), os.path.join(root, "s2")
    _run(lt + ["--bn-groups", "2", "--lr", "0.2", "--epochs", "1",
               "--cosine_scheduler", "--mixup", "0.2", "--output-dir", s1])
    _run(lt + ["--bn-groups", "2", "--lr", "0.00002", "--epochs", "1",
               "--mixup", "0.2", "--load_from", os.path.join(s1,
                                                             "checkpoints"),
               "--classif", "iif", "--decoup", "--iif", "smooth",
               "--output-dir", s2])
    before, after = _state(s1), _state(s2)
    assert torch.equal(after["layer3.0.conv2.weight"],
                       before["layer3.0.conv2.weight"])
    assert not torch.equal(after["fc.weight"], before["fc.weight"])
    acc = _run(lt + ["--load_from", os.path.join(s1, "checkpoints"),
                     "--classif", "iif", "--iif", "smooth", "--test-only",
                     "--output-dir", os.path.join(root, "post")])
    assert 0.0 <= acc <= 100.0


def test_cli_raises_on_a_jpeg_through_the_prefetch_thread(tmp_path,
                                                          small_data):
    root = str(tmp_path)
    _write_lists(root)
    with open(os.path.join(root, "train", "0.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    with open(os.path.join(root, "lt_train.txt"), "w") as f:
        f.writelines(f"train/0.jpg {c}\n" for c in (3, 3, 7, 9))
    with pytest.raises(NotImplementedError, match="only PNG"):
        _run(["--dset_name", "imagenet_lt", "--data-path", root,
              "--train-txt", os.path.join(root, "lt_train.txt"),
              "--eval-txt", os.path.join(root, "lt_eval.txt"), "--model",
              "se_resnet50", "-b", "2", "--epochs", "1", "--output-dir",
              str(tmp_path / "out")], workers=2)


@pytest.mark.parametrize("flag", [
    ["--world-size", "2"], ["--dist-url", "tcp://localhost:1"],
    ["--pretrained", "x.pth"]])
def test_cli_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match=flag[0]):
        _run(["--dset_name", "synthetic"] + flag)
