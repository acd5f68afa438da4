"""The LVIS baselines' configs through the port's CLIs, on the CPU, in the
process: each config as it stands but for depth 14 ((1, 1, 1, 1)
bottlenecks), 7 classes, f32, a 64x96 canvas, batch 2 and few proposals,
over a seeded LVIS-style set of 4 PNGs (``iif_torch/tools/
synthetic_lvis.py``). Each test is one unit of work for one worker of a
parallel run.

- ``test_det --tta`` on the headline IIF MaskRCNN and on the flagship FASA
  cascade (two views: the config's last scale, with and without a flip)
  from seeded checkpoints, over two images: COCO records for each, bbox
  and segm AP; ``--tta`` with ``--exported`` or ``--eval PQ`` exits with
  JAX's messages.
- ``train_det`` on ``fasa_iof_base10_r50_rfs_cos_norm_1x_rsb.py`` from an
  mmcls-layout backbone ``.pth`` (``backbone.*`` and a ``head.fc``), with
  ``data.grad_accum`` 2 and 1: the backbone loaded from the file (the
  frozen stem as written, ``head.*`` left out), AdamW with the norm layers
  in the group without decay, the FASA val pass run.
- the Seesaw config: ``train_det`` a step (the counts in the checkpoint
  under mmdet's name, ``--resume-from`` restoring them), ``init_detector``
  serving the checkpoint with the C+2 classifier; JAX's ``init_detector``
  builds a C+1 classifier for the same config, which Seesaw's activation
  splits into C - 1 classes (``ROADMAP.md`` Queue 3: the port follows
  ``test_det``)."""
import json
import os

import numpy as np
import pytest
import torch

from iif_torch.cli import test_det, train_det
from iif_torch.config import Config, parse_cfg_options
from iif_torch.detection import detector as td
from iif_torch.detection.inference import inference_detector, init_detector
from iif_torch.detection.losses_extra import SEESAW_CUM_KEY, SeesawLoss
from iif_torch.tools.synthetic_lvis import write_synthetic_lvis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = os.path.join(REPO, "configs/iif/iif_r50_1x.py")
CASCADE = os.path.join(
    REPO, "configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py")
RSB = os.path.join(
    REPO, "configs/fasa/fasa_iof_base10_r50_rfs_cos_norm_1x_rsb.py")
SEESAW = os.path.join(
    REPO, "configs/seesaw_loss/mask_rcnn_r50_fpn_seesaw_mstrain_2x_lvis_v1.py")
SIZES = [(48, 64), (40, 56), (64, 48), (56, 40)]
NUM_CLASSES = 7


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("lvis_files")
    return write_synthetic_lvis(str(root), SIZES, num_classes=NUM_CLASSES,
                                seed=5, instances=(2, 5))


@pytest.fixture
def shallow(monkeypatch):
    """Depth 14; the trainer's weights from ``random_init_`` (the
    truncated normals of ``fresh_init_`` are covered elsewhere)."""
    monkeypatch.setitem(td._DEPTH_LAYERS, 14, (1, 1, 1, 1))
    monkeypatch.setattr(train_det.engine, "fresh_init_", td.random_init_)


def _options(data, **extra):
    opts = {"data.train.ann_file": data["ann_file"],
            "data.train.img_prefix": data["img_prefix"],
            "data.val.ann_file": data["ann_file"],
            "data.val.img_prefix": data["img_prefix"],
            "data.test.ann_file": data["ann_file"],
            "data.test.img_prefix": data["img_prefix"],
            "model.depth": 14, "model.num_classes": NUM_CLASSES,
            "model.compute_dtype": None, "runner.max_epochs": 1,
            "pipeline.canvas": (64, 96), "pipeline.scales": [(96, 64)],
            "train_cfg.rpn_nms_pre": 200, "train_cfg.rpn_max_per_img": 50,
            "train_cfg.rcnn_num_samples": 16, "train_cfg.num_mask_rois": 2,
            "test_cfg.rpn_nms_pre": 200, "test_cfg.rpn_max_per_img": 50,
            "test_cfg.max_per_img": 20, "data.samples_per_gpu": 2,
            "evaluation.interval": 0, "log_config.tensorboard": False,
            "log_config.interval": 1}
    opts.update(extra)
    return [f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}"
            for k, v in opts.items()]


def _cfg(config, data, **extra):
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(_options(data, **extra)))
    return cfg


def _seeded_checkpoint(config, data, path):
    det = init_detector(_cfg(config, data), device="cpu")
    torch.save({"state_dict": det.model.state_dict()}, path)
    return str(path)


def test_cli_tta_runs_maskrcnn_and_cascade(data, shallow, tmp_path):
    """Two images each (``--max-images``), 10 detections an image; AP
    within [0, 1]."""
    for config in (HEADLINE, CASCADE):
        ckpt = _seeded_checkpoint(config, data, tmp_path / "seeded.pth")
        out = tmp_path / "tta.json"
        tta = test_det.main([config, ckpt, "--tta", "--max-images", "2",
                             "--eval", "bbox", "segm", "--out", str(out),
                             "--device", "cpu", "--cfg-options",
                             *_options(data, **{"test_cfg.max_per_img":
                                                10})])
        records = json.loads(out.read_text())
        assert {r["image_id"] for r in records} == {1, 2}
        assert {"bbox", "score", "category_id", "segmentation"} <= set(
            records[0])
        for metric in ("bbox", "segm"):
            assert 0.0 <= tta[metric]["AP"] <= 1.0
    assert test_det.tta_views(_cfg(CASCADE, data)) == [
        {"scale": (96, 64), "flip": False}, {"scale": (96, 64), "flip": True}]
    for bad in (["--exported", "x"], ["--eval", "PQ"]):
        with pytest.raises(SystemExit, match="--tta"):
            test_det.refuse_unported(test_det.parse_args(
                [CASCADE, ckpt, "--tta", *bad]))


def _mmcls_backbone(path):
    """A random mmcls-layout ResNet checkpoint: ``backbone.*`` in the
    trunk's names, the classifier ``head.fc.*``, a ``meta``."""
    backbone = td.random_init_(td.MaskRCNN(num_classes=NUM_CLASSES,
                                           depth=14),
                               torch.Generator().manual_seed(9)).backbone
    sd = {f"backbone.{k}": v for k, v in backbone.state_dict().items()}
    sd["head.fc.weight"] = torch.randn(1000, 2048)
    sd["head.fc.bias"] = torch.randn(1000)
    torch.save({"meta": {"mmcls_version": "0.x"}, "state_dict": sd}, path)
    return sd


def test_cli_trains_rsb_from_mmcls_backbone_with_grad_accum(data, shallow,
                                                            tmp_path):
    pth = tmp_path / "resnet_rsb.pth"
    sd = _mmcls_backbone(pth)
    for accum in (2, 1):
        trainer, state = train_det.main([
            RSB, "--work-dir", str(tmp_path / f"rsb{accum}"), "--device",
            "cpu", "--max-steps", "1", "--cfg-options",
            *_options(data, **{"model.pretrained_backbone": str(pth),
                               "data.grad_accum": accum})])
        assert trainer.grad_accum == accum and state.step == 1
        model = trainer.model
        # the frozen stem and stage 1 as the file wrote them
        for name in ("conv1.weight", "bn1.weight", "layer1.0.conv2.weight"):
            assert torch.equal(model.backbone.state_dict()[name],
                               sd[f"backbone.{name}"]), name
        assert not torch.equal(model.backbone.layer4[0].conv2.weight,
                               sd["backbone.layer4.0.conv2.weight"])
        groups = state.optimizer.param_groups
        assert [(g["weight_decay"], g["decay_offset"]) for g in groups] == [
            (0.05, 0.0), (0.0, 0.0), (0.05, 1.0)]
        no_decay = {id(p) for p in groups[1]["params"]}
        assert id(model.backbone.layer4[0].bn2.weight) in no_decay
        assert id(model.backbone.layer4[0].conv2.weight) not in no_decay
        assert state.fasa is not None and state.fasa.cum_loss_t0.any()
    with pytest.raises(NotImplementedError, match="paramwise_cfg"):
        train_det.engine.trainer_from_config(
            _cfg(RSB, data, **{"optimizer.paramwise_cfg.bias_decay_mult":
                               0.0}), SeesawLoss(np.zeros(8)), 10,
            device="cpu")


def test_seesaw_config_trains_and_serves(data, shallow, tmp_path,
                                         monkeypatch):
    from iif_tpu.config import Config as JaxConfig
    from iif_tpu.config import parse_cfg_options as jax_parse
    from iif_tpu.detection import detector as jd
    from iif_tpu.detection import inference as jinference
    from iif_tpu.detection import simple_test as jsimple

    import jax
    import jax.numpy as jnp

    work = tmp_path / "seesaw"
    base = [SEESAW, "--work-dir", str(work), "--device", "cpu",
            "--max-steps", "1"]
    opts = ["--cfg-options", *_options(data)]
    trainer, state = train_det.main(base + opts)
    assert isinstance(trainer.loss_cls, SeesawLoss)
    assert trainer.model.roi_head.bbox_head.fc_cls.weight.shape == (
        1024, NUM_CLASSES + 2)
    assert state.seesaw_cum.shape == (NUM_CLASSES + 1,)
    assert state.seesaw_cum.sum() > 0 and state.seesaw_cum[-1] > 0
    ckpt = work / "checkpoints" / "epoch_1.pth"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert torch.equal(saved["state_dict"][SEESAW_CUM_KEY], state.seesaw_cum)
    _, resumed = train_det.main(base + ["--resume-from", str(ckpt)] + opts)
    assert torch.equal(resumed.seesaw_cum, state.seesaw_cum)

    det = init_detector(_cfg(SEESAW, data), str(work / "checkpoints" /
                                                "latest.pth"), device="cpu")
    assert isinstance(det.loss_cls, SeesawLoss)
    assert det.model.roi_head.bbox_head.fc_cls.weight.shape[1] == \
        NUM_CLASSES + 2
    res = inference_detector(det, os.path.join(
        data["img_prefix"], "train2017/000000000001.png"))
    assert res["boxes"].shape == (20, 4) and res["valid"].any()
    assert res["labels"][res["valid"]].max() < NUM_CLASSES

    # JAX's init_detector (behind its serve CLI) builds cfg.model as it
    # stands: a C+1 classifier, whose C+1 logits Seesaw's activation
    # takes for C - 1 classes and the objectness pair
    monkeypatch.setitem(jd._DEPTH_LAYERS, 14, ((1, 1, 1, 1), "bottleneck"))
    monkeypatch.setattr(jsimple, "init_detector_variables", lambda m, c: (
        jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1,) + tuple(c) + (3,)),
                                      False))))
    jcfg = JaxConfig.fromfile(SEESAW)
    jcfg.merge_from_options(jax_parse(_options(data)))
    jdet = jinference.init_detector(jcfg)
    assert jdet.model.cls_channels == 0
    assert jdet.variables["params"]["bbox_head"]["fc_cls"]["kernel"].shape \
        == (1024, NUM_CLASSES + 1)
    assert jdet.loss_cls.get_activation(
        jnp.zeros((1, NUM_CLASSES + 1))).shape == (1, NUM_CLASSES)
    assert det.loss_cls.get_activation(
        torch.zeros(1, NUM_CLASSES + 2)).shape == (1, NUM_CLASSES + 1)
