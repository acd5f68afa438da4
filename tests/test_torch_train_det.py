"""``python -m iif_torch.cli.train_det`` on the CPU, in the process, from
files: a synthetic LVIS v1-style set of 4 PNGs on disk (two aspect
groups), the headline config at depth 50 and f32 with 7 classes, a 64x96
canvas of two buckets (32 and 64 x 96), batch 2, few proposals (as
``tests/test_torch_train_step.py`` sizes the step).

``test_cli_trains_resumes_and_serves`` makes the training runs and holds
everything they give (one test, so that one worker of a parallel run
makes them):

- 3 epochs of one step (``--max-steps 1``) from a torchvision-named
  ``pretrained_backbone`` (its ``fc`` dropped) write, at
  ``checkpoint_config.interval=2`` and at the end, ``epoch_2.pth`` (2
  steps), ``epoch_3.pth`` and ``latest.pth`` under mmdet names, the
  ``.log.json`` and the config dump, over both buckets; the frozen
  stages keep the pretrained weights; the step cap leaves no thread;
- ``--resume-from epoch_2.pth`` plus 1 step gives the parameters, the
  momentum buffers and the scheduler of the 3 straight steps, exactly;
- ``init_detector(..., device="cpu")`` serves ``latest.pth`` on one of
  the PNG files with cv2 blocked.

The other tests need only the files, or nothing: every unported knob
raises ``NotImplementedError`` before training and a class-count mismatch
``ValueError``; an evaluation with a metric the hook does not compute
(``PQ``) is refused only where the run reaches it;
the RFS config's repeat factors reach the loader; a non-finite loss
raises ``FloatingPointError`` at read-back; one step of the C4 config
runs (no masks), and ``--load-from`` its checkpoint loads every weight."""
import glob
import json
import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from iif_torch.cli import train_det
from iif_torch.config import Config, parse_cfg_options
from iif_torch.detection.c4 import C4FasterRCNN
from iif_torch.detection.detector import build_detector
from iif_torch.detection.inference import inference_detector, init_detector
from iif_torch.detection.losses import DetCrossEntropyLoss
from iif_torch.detection.pretrained import load_pretrained_backbone
from iif_torch.engine.detection import DetectionTrainer
from iif_torch.models.resnet import ResNet
from iif_torch.tools.synthetic_lvis import write_synthetic_lvis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/iif/iif_r50_1x.py")
RFS_CONFIG = os.path.join(REPO, "configs/iif/iif_r50_rfs_1x.py")
C4_CONFIG = os.path.join(
    REPO, "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py")
SIZES = [(48, 64), (40, 56), (64, 48), (56, 40)]


def _options(paths, **extra):
    opts = {"data.train.ann_file": paths["ann_file"],
            "data.train.img_prefix": paths["img_prefix"],
            "data.test.ann_file": paths["ann_file"],
            "model.num_classes": 7, "model.compute_dtype": None,
            "pipeline.canvas": (64, 96),
            "pipeline.scales": [(96, 32), (96, 64)],
            "train_cfg.rpn_nms_pre": 200, "train_cfg.rpn_max_per_img": 50,
            "train_cfg.rcnn_num_samples": 16, "train_cfg.num_mask_rois": 2,
            "test_cfg.rpn_nms_pre": 200, "test_cfg.rpn_max_per_img": 50,
            "test_cfg.max_per_img": 20,
            "data.samples_per_gpu": 2, "evaluation.interval": 0,
            "checkpoint_config.interval": 2,
            "log_config.tensorboard": False, "log_config.interval": 1}
    opts.update(extra)
    return [f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}"
            for k, v in opts.items()]


def _run(config, work_dir, paths, *args, **extra):
    return train_det.main([config, "--work-dir", str(work_dir), "--device",
                           "cpu", *args, "--cfg-options",
                           *_options(paths, **extra)])


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    return write_synthetic_lvis(str(root), SIZES, num_classes=7, seed=2,
                                instances=(2, 5))


def test_cli_trains_resumes_and_serves(data, tmp_path, monkeypatch):
    # a torchvision-named ResNet-50 file: PyTorch's default init, not the
    # fresh init's draw, and an ImageNet classifier
    torch.manual_seed(0)
    tv = ResNet((3, 4, 6, 3)).state_dict()
    tv.update({"fc.weight": torch.randn(1000, 2048),
               "fc.bias": torch.zeros(1000)})
    torch.save(tv, tmp_path / "resnet50.pth")
    canvases = []
    step = DetectionTrainer.train_step

    def recording(self, state, batch):
        canvases.append(tuple(batch["image"].shape[1:3]))
        return step(self, state, batch)

    pretrained = {"runner.max_epochs": 3,
                  "model.pretrained_backbone": str(tmp_path / "resnet50.pth")}
    with monkeypatch.context() as mp:
        mp.setattr(DetectionTrainer, "train_step", recording)
        trainer, state = _run(CONFIG, tmp_path / "straight", data,
                              "--max-steps", "1", **pretrained)

    # checkpoints under mmdet names, the log, the buckets, no thread left
    assert state.step == 3
    ckpts = tmp_path / "straight" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["epoch_2.pth", "epoch_3.pth",
                                         "latest.pth"]
    assert os.path.realpath(ckpts / "latest.pth") == str(
        ckpts / "epoch_3.pth")
    final = trainer.model.state_dict()
    assert "roi_head.bbox_head.fc_cls.weight" in final
    assert "backbone.layer1.0.conv1.weight" in final
    for n in (2, 3):
        ckpt = _load(ckpts / f"epoch_{n}.pth")
        assert set(ckpt) == {"meta", "state_dict", "optimizer", "scheduler"}
        assert ckpt["meta"]["epoch"] == n and ckpt["meta"]["iter"] == n
        assert set(ckpt["state_dict"]) == set(final)
    latest = _load(ckpts / "latest.pth")["state_dict"]
    for k, v in final.items():
        assert torch.equal(latest[k], v), k
    assert set(canvases) == {(32, 96), (64, 96)}
    assert not [t for t in threading.enumerate()
                if "produce" in t.name or "ThreadPoolExecutor" in t.name]
    assert (tmp_path / "straight" / "config_dump.py").is_file()
    (log,) = glob.glob(str(tmp_path / "straight" / "*.log.json"))
    lines = [json.loads(x) for x in open(log)]
    assert "env_info" in lines[0] and "PyTorch" in lines[0]["env_info"]
    assert [(r["epoch"], r["iter"]) for r in lines[1:]] == [(1, 0), (2, 0),
                                                            (3, 0)]
    assert all(math.isfinite(r["loss"]) and r["lr"] > 0 for r in lines[1:])

    # the pretrained trunk: the frozen stem and stage 1 keep the file's
    # weights, every other trunk conv started from it and moved
    for k, v in tv.items():
        if k.startswith("fc."):
            assert "backbone." + k not in final
        elif k.startswith(("conv1", "bn1", "layer1.")) or "running" in k:
            assert torch.equal(final["backbone." + k], v), k
        elif k.endswith("conv2.weight"):
            assert not torch.equal(final["backbone." + k], v), k

    # resume from epoch 2 plus one step: the straight run, bit for bit
    resumed, rstate = _run(CONFIG, tmp_path / "resumed", data,
                           "--max-steps", "1", "--resume-from",
                           str(ckpts / "epoch_2.pth"), **pretrained)
    assert rstate.step == 3
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, final[k]), k
    o1, o2 = state.optimizer.state_dict(), rstate.optimizer.state_dict()
    assert o1["param_groups"] == o2["param_groups"]
    assert o1["state"].keys() == o2["state"].keys()
    for i, st in o1["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           o2["state"][i]["momentum_buffer"]), i
    assert state.scheduler.state_dict() == rstate.scheduler.state_dict()

    # a name the file lacks keeps the model's value; one the trunk lacks
    # raises
    model = resumed.model
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    one = {"layer2.0.conv1.weight": torch.ones(128, 256, 1, 1)}
    torch.save(one, tmp_path / "one.pth")
    load_pretrained_backbone(model, str(tmp_path / "one.pth"))
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, one.get(k, before[k])), k
    torch.save({"layer9.weight": torch.zeros(1)}, tmp_path / "x.pth")
    with pytest.raises(KeyError, match="layer9"):
        load_pretrained_backbone(model, str(tmp_path / "x.pth"))
    del resumed, model

    # init_detector serves latest.pth, on a PNG path with cv2 blocked
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(parse_cfg_options(_options(data)))
    det = init_detector(cfg, str(ckpts / "latest.pth"), device="cpu")
    for k, v in final.items():
        assert torch.equal(det.model.state_dict()[k], v), k
    assert det.CLASSES == [f"class_{i}" for i in range(7)]
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        res = inference_detector(det, os.path.join(
            data["img_prefix"], "train2017/000000000001.png"))
    assert res["masks"].shape[1:] == SIZES[0]
    for k, v in res.items():
        assert np.isfinite(v.astype(np.float64)).all(), k


@pytest.mark.parametrize("args,extra,error,match", [
    ([], {"evaluation.interval": 1, "evaluation.metric": ["PQ"]},
     NotImplementedError, "evaluation"),
    (["--tp", "2"], {}, NotImplementedError, "--tp"),
    (["--selectp", "1"], {}, NotImplementedError, "--selectp"),
    ([], {"data.grad_accum": 3}, ValueError, "grad_accum"),
    ([], {"optimizer.paramwise_cfg": {"bias_decay_mult": 0.0}},
     NotImplementedError, "paramwise_cfg"),
    ([], {"custom_hooks": [{"type": "EMAHook"}]}, NotImplementedError,
     "EMAHook"),
    ([], {"custom_hooks": [{"type": "YOLOXModeSwitchHook"}]},
     NotImplementedError, "YOLOXModeSwitchHook"),
    ([], {"pipeline.uint8": False}, NotImplementedError, "uint8"),
    ([], {"pipeline.keep_ratio": False}, NotImplementedError, "keep_ratio"),
    ([], {"pipeline.with_seg": True}, NotImplementedError, "with_seg"),
    ([], {"pipeline.extras": [{"type": "CutOut"}]}, NotImplementedError,
     "extra_transforms"),
    ([], {"loss_cls.type": "SeesawLoss", "model.type": "CascadeMaskRCNN"},
     NotImplementedError, "Seesaw"),
    ([], {"model.type": "LD"}, NotImplementedError, "LD"),
    ([], {"model.num_classes": 9}, ValueError, "num_classes"),
])
def test_unported_knobs_raise(data, tmp_path, args, extra, error, match):
    with pytest.raises(error, match=match):
        _run(CONFIG, tmp_path, data, *args,
             **{"runner.max_epochs": 3, **extra})


@pytest.mark.parametrize("interval,max_epochs,start,refused", [
    (12, 12, 0, True), (12, 11, 0, False), (5, 12, 9, True),
    (5, 12, 10, False), (0, 12, 0, False)])
def test_evaluation_refused_only_where_reached(interval, max_epochs, start,
                                               refused):
    """An evaluation of a metric the hook does not compute (``PQ``; it
    computes ``bbox`` and ``segm``) at the headline config's
    ``evaluation.interval=12`` with its 12 epochs is refused; at an
    interval the run (from ``start`` finished epochs) never reaches it is
    not. The config as it stands (``bbox``, ``segm``) is never refused."""
    cfg = Config.fromfile(CONFIG)
    args = train_det.parse_args([CONFIG])
    train_det.refuse_unported(cfg, args, start)
    cfg.merge_from_options({"evaluation.interval": interval,
                            "evaluation.metric": ["bbox", "PQ"],
                            "runner.max_epochs": max_epochs})
    if refused:
        with pytest.raises(NotImplementedError, match="evaluation"):
            train_det.refuse_unported(cfg, args, start)
    else:
        train_det.refuse_unported(cfg, args, start)


@pytest.mark.parametrize("thr", [None, 0.9])
def test_rfs_config_feeds_repeat_factors(data, tmp_path, monkeypatch, thr):
    """``iif_r50_rfs_1x.py`` (``oversample_thr=1e-3``, and 0.9 where this
    small set's categories fall under it): the loader the CLI builds
    repeats images by their rarest category; the trainer's steps per
    epoch come from the expanded indices."""
    from iif_torch.detection.datasets import (
        build_dataset,
        expand_indices_by_repeat,
        repeat_factors,
    )

    class Stop(Exception):
        pass

    def stop(cfg, loss_cls, steps_per_epoch, seed, device):
        assert cfg.data["train"]["oversample_thr"] == (thr or 1e-3)
        raise Stop(steps_per_epoch)

    monkeypatch.setattr(train_det.engine, "trainer_from_config", stop)
    extra = {} if thr is None else {"data.train.oversample_thr": thr}
    with pytest.raises(Stop) as got:
        _run(RFS_CONFIG, tmp_path, data, **{"runner.max_epochs": 1, **extra})
    ds = build_dataset({"type": "LVISV1Dataset", **data})
    n = len(expand_indices_by_repeat(repeat_factors(ds, thr or 1e-3)))
    assert got.value.args[0] == n // 2
    assert (n > len(ds)) == (thr is not None)


def test_non_finite_loss_raises_at_read_back(monkeypatch):
    """Metrics wait in the read-back window; the NaN of the second step
    raises when the epoch drains them, and the loader's iterator is
    closed; finite ones reach the meters."""
    model = build_detector({"type": "MaskRCNN", "num_classes": 3})
    trainer = DetectionTrainer(model, DetCrossEntropyLoss(num_classes=3),
                               lambda step: 0.01, device="cpu")
    closed = []

    class Loader:
        def __len__(self):
            return 3

        def set_epoch(self, epoch):
            self.epoch = epoch

        def __iter__(self):
            try:
                for _ in range(3):
                    yield {"image": None, "image_ids": None}
            finally:
                closed.append(True)

    losses = iter([1.0, float("nan"), 2.0])
    monkeypatch.setattr(trainer, "train_step", lambda s, b: (
        s, {"loss": torch.tensor(next(losses))}))
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train_one_epoch(None, Loader(), 0, print_freq=0)
    assert closed == [True]
    monkeypatch.setattr(trainer, "train_step", lambda s, b: (
        s, {"loss": torch.tensor(1.5)}))
    _, logger = trainer.train_one_epoch(None, Loader(), 0, print_freq=0)
    assert logger.loss.count == 3 and logger.loss.global_avg == 1.5


def test_c4_config_trains_one_step_and_loads_from(data, tmp_path):
    """One step of the C4 config; then ``--load-from`` its checkpoint,
    zero epochs from seed 1: every weight is the file's."""
    c4 = {"pipeline.scales": [(96, 64)], "train_cfg.rcnn_num_samples": 4}
    trainer, state = _run(C4_CONFIG, tmp_path / "c4", data, "--max-steps",
                          "1", **{"runner.max_epochs": 1, **c4})
    assert isinstance(trainer.model, C4FasterRCNN) and state.step == 1
    path = tmp_path / "c4" / "checkpoints" / "epoch_1.pth"
    ckpt = _load(path)["state_dict"]
    assert "roi_head.shared_head.layer4.0.conv1.weight" in ckpt
    loaded, lstate = _run(C4_CONFIG, tmp_path / "loaded", data, "--seed",
                          "1", "--load-from", str(path),
                          **{"runner.max_epochs": 0, **c4})
    assert lstate.step == 0
    got = loaded.model.state_dict()
    assert got.keys() == ckpt.keys()
    for k, v in ckpt.items():
        assert torch.equal(got[k], v), k
