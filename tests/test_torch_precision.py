"""One float32 precision for every entry point of the port: a CUDA device
resolved by ``iif_torch.device.resolve_device`` turns TF32 off for cuDNN
convolutions and cuBLAS matmuls (full IEEE f32, what the CPU parity tests
compare against and ``chip_smoke.py`` measures under). Each CLI's
``main`` (``train``, ``train_quantization``, ``train_det``, ``test_det``,
``serve``) and both trainers reach it: with ``torch.cuda.is_available``
made true, the flags set to TF32 before each call are off after it (the
call then fails further on, without a card)."""
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CFG = str(REPO / "configs/iif/iif_r50_1x.py")


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda.is_available`` true; the TF32 flags restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _full_f32():
    return not (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)


def test_resolve_device_sets_full_f32_only_for_cuda(fake_card):
    from iif_torch.device import resolve_device

    _tf32_on()
    assert resolve_device("cpu").type == "cpu"
    assert not _full_f32()
    assert resolve_device().type == "cuda"
    assert _full_f32()


def _entry_points(tmp_path):
    from iif_torch.cli import serve, test_det, train, train_det
    from iif_torch.cli import train_quantization as tq
    from iif_torch.engine.classification import ClassificationTrainer
    from iif_torch.engine.detection import DetectionTrainer
    from iif_torch.detection.detector import MaskRCNN
    from iif_torch.losses import get_criterion
    from iif_torch.models.factory import build_classifier

    missing = str(tmp_path / "missing")
    return {
        "train": lambda: train.main(train.get_args_parser().parse_args(
            ["--data-path", missing])),
        "train_quantization": lambda: tq.main(tq.get_args_parser()
                                              .parse_args(["--data-path",
                                                           missing])),
        "train_det": lambda: train_det.main(
            [CFG, "--work-dir", str(tmp_path / "work")]),
        "test_det": lambda: test_det.main([CFG, missing + ".pth"]),
        "serve": lambda: serve.main([CFG]),
        "ClassificationTrainer": lambda: ClassificationTrainer(
            build_classifier("resnet20", 10), get_criterion("ce", [1] * 10),
            lambda s: 0.1, None, None, 10),
        "DetectionTrainer": lambda: DetectionTrainer(
            MaskRCNN(num_classes=3), None, lambda s: 0.0),
    }


@pytest.mark.parametrize("name", ["train", "train_quantization",
                                  "train_det", "test_det", "serve",
                                  "ClassificationTrainer",
                                  "DetectionTrainer"])
def test_entry_point_sets_full_f32(fake_card, tmp_path, name):
    run = _entry_points(tmp_path)[name]
    _tf32_on()
    with pytest.raises(Exception):
        run()
    assert _full_f32(), name
