"""The port's ground rules: ``iif_torch`` and ``chip_smoke.py`` import no
JAX, flax or ``iif_tpu`` (nor pandas, torchvision or scikit-learn, which
the card's machine lacks, not even lazily; cv2 only lazily inside a
function), and the entry points
run on CUDA unless given ``device="cpu"``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "iif_tpu", "pandas", "torchvision",
             "sklearn"}


def _port_files():
    return sorted((REPO / "iif_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imports(tree):
    """(top-level module, lineno, at module level?) of every import."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name.split(".")[0], node.lineno, id(node) in top


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod, line, module_level in _imports(tree):
        assert mod not in FORBIDDEN, f"{path.name}:{line} imports {mod}"
        if mod == "cv2":
            assert not module_level, f"{path.name}:{line} imports cv2 at " \
                "module level"


def test_port_package_has_every_module():
    names = {str(p.relative_to(REPO / "iif_torch")) for p in _port_files()
             if "iif_torch" in p.parts}
    for mod in ("device.py", "config.py", "ops/roi_align_ml.py",
                "ops/nms.py", "ops/boxes.py", "ops/anchors.py",
                "models/resnet.py", "detection/necks.py",
                "detection/rpn.py", "detection/roi_extractor.py",
                "detection/bbox_head.py", "detection/mask_head.py",
                "detection/detector.py", "detection/convert.py",
                "detection/losses.py", "detection/pipeline.py",
                "detection/inference.py", "cli/serve.py",
                "ops/assigner.py", "ops/sampler.py", "engine/schedules.py",
                "engine/detection.py", "ops/roi_align.py", "detection/c4.py",
                "detection/simple_test.py", "detection/init.py",
                "detection/evaluation.py", "detection/voc_eval.py",
                "cli/test_det.py", "native/rle_native.py",
                "native/eval_native.py", "native/build.py",
                "losses/ce.py", "losses/iif.py", "losses/focal.py",
                "losses/mixup.py", "losses/factory.py", "models/norm.py",
                "models/layers.py", "models/resnet_cifar.py",
                "models/factory.py", "models/init.py", "models/convert.py",
                "data/cifar_lt.py", "data/lt_dataset.py",
                "data/samplers.py", "data/loader.py", "data/augment.py",
                "engine/classification.py", "engine/per_shot.py",
                "cli/train.py", "utils/init.py", "utils/prefetch.py",
                "data/autoaugment.py", "data/branch_augment.py",
                "quant.py", "engine/calibration.py",
                "cli/train_quantization.py", "detection/cascade.py",
                "detection/fasa.py", "detection/htc.py",
                "detection/losses_extra.py", "detection/tta.py"):
        assert mod in names, mod
    for src in ("roi_align_ml.cu", "roi_align.cu", "roi_align_common.cuh"):
        assert (REPO / "iif_torch" / "csrc" / src).is_file(), src
    for src in ("rle.cpp", "evalmatch.cpp"):
        assert (REPO / "iif_torch" / "native" / src).is_file(), src


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_entry_points_raise_without_cuda():
    _needs_no_card()
    from iif_torch.cli import serve
    from iif_torch.config import Config
    from iif_torch.detection.detector import MaskRCNN
    from iif_torch.device import resolve_device
    from iif_torch.detection.inference import init_detector
    from iif_torch.engine.detection import (
        DetectionTrainer,
        trainer_from_config,
    )

    cfg = str(REPO / "configs/iif/iif_r50_1x.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([cfg])
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionTrainer(MaskRCNN(num_classes=3), None, lambda s: 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer_from_config(Config.fromfile(cfg), None, 100)
    assert resolve_device("cpu").type == "cpu"


def test_test_det_raises_without_cuda():
    """``test_det`` checks the device before it reads anything; with
    ``--device cpu`` it goes on (here to the headline config's missing
    annotation file)."""
    _needs_no_card()
    from iif_torch.cli import test_det

    cfg = str(REPO / "configs/iif/iif_r50_1x.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        test_det.main([cfg, "missing.pth"])
    with pytest.raises(FileNotFoundError, match="lvis_v1_val"):
        test_det.main([cfg, "missing.pth", "--device", "cpu"])


def test_classification_cli_raises_without_cuda():
    """``cli.train`` and its trainer check the device first; with
    ``--device cpu`` the CLI goes on (here to the missing CIFAR files)."""
    _needs_no_card()
    from iif_torch.cli import train
    from iif_torch.engine.classification import ClassificationTrainer
    from iif_torch.losses import get_criterion
    from iif_torch.models.factory import build_classifier

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(train.get_args_parser().parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassificationTrainer(build_classifier("resnet20", 10),
                              get_criterion("ce", [1] * 10), lambda s: 0.1,
                              None, None, 10)
    with pytest.raises(FileNotFoundError, match="cifar-100-python"):
        train.main(train.get_args_parser().parse_args(
            ["--device", "cpu", "--data-path", str(REPO / "missing")]))


def test_c4_entry_points_raise_without_cuda():
    _needs_no_card()
    from iif_torch.cli import serve
    from iif_torch.detection.inference import init_detector

    from iif_torch.config import Config
    from iif_torch.engine.detection import trainer_from_config

    cfg = str(REPO / "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([cfg])
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer_from_config(Config.fromfile(cfg), None, 100)


def test_single_level_roi_align_pairs_k3_with_k4():
    """K4 is ported: ``roi_align`` on a CUDA tensor goes through the
    autograd ``RoIAlign`` (K3 forward, K4 backward), with K4's plain
    version and its launch counter beside K3's; the C4 path has its
    training loss."""
    from iif_torch.detection.c4 import C4FasterRCNN, c4_loss
    from iif_torch.ops import roi_align as mod

    assert issubclass(mod.RoIAlign, torch.autograd.Function)
    assert callable(mod.roi_align_grad_reference)
    mod.grad_launches_by_size[(14, 14)] = 1
    mod.roi_align.launches_by_size[(14, 14)] = 1
    mod.roi_align.launches_by_path["vec8"] = 1
    mod.reset_launches()
    assert mod.grad_launches_by_size == {}
    assert mod.roi_align.launches_by_size == {}
    assert mod.roi_align.launches_by_path == {}
    assert callable(c4_loss) and hasattr(C4FasterRCNN, "train_anchors")
    src = (REPO / "iif_torch" / "csrc" / "roi_align.cu").read_text()
    assert 'extern "C" int iif_roi_align_bwd(' in src


def test_kernel_wrapper_raises_on_non_cpu_non_cuda():
    from iif_torch.ops.roi_align import roi_align
    from iif_torch.ops.roi_align_ml import roi_align_ml

    feats = [torch.zeros(1, 4, 4, 2, device="meta")] * 4
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_ml(feats, torch.zeros(1, 5, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align(feats[0], torch.zeros(1, 5, device="meta"))


def test_chip_smoke_fails_without_cuda():
    """No card: exit code other than 0 and no result line."""
    _needs_no_card()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(REPO))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
