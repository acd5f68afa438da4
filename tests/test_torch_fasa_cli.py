"""``python -m iif_torch.cli.train_det`` on the FASA cascade config, on
the CPU, in the process: the flagship config as it stands but for depth
14 ((1, 1, 1, 1) bottlenecks), 7 classes, f32, a 64x96 canvas, batch 2
and few proposals, over a seeded LVIS-style set of 4 PNGs with a
``data.val`` of 4 more (``iif_torch/tools/synthetic_lvis.py``).

``test_cli_runs_the_dynamic_runner_and_resumes`` (one test, so that one
worker of a parallel run makes its runs): 2 epochs of one step under the
dynamic runner, each followed by the FASA val pass and dynamic sampling
(``prob_list`` still as built after epoch 0, where the previous losses
start equal to this epoch's; moved after epoch 1); both checkpoints hold
every FASA field of the three stages; ``--resume-from epoch_1.pth``
restores every field bit for bit, and one more epoch from there gives
the straight run's final state, weights and FASA fields alike;
``init_detector`` serves ``latest.pth`` and ignores the FASA fields.
The MaskRCNN FASA config without ``data.val`` falls back to the train
loader with JAX's warning."""
import os

import numpy as np
import pytest
import torch

from iif_torch.cli import train_det
from iif_torch.config import Config, parse_cfg_options
from iif_torch.detection import detector as td
from iif_torch.detection.cascade import CascadeMaskRCNN
from iif_torch.detection.fasa import FasaState
from iif_torch.detection.inference import inference_detector, init_detector
from iif_torch.tools.synthetic_lvis import write_synthetic_lvis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASCADE = os.path.join(
    REPO, "configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py")
MASKRCNN = os.path.join(REPO, "configs/fasa/fasa_iif_r50_rfs_cos_norm_2x.py")
SIZES = [(48, 64), (40, 56), (64, 48), (56, 40)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fasa_files")
    return {"train": write_synthetic_lvis(str(root / "train"), SIZES,
                                          num_classes=7, seed=3,
                                          instances=(2, 5)),
            "val": write_synthetic_lvis(str(root / "val"), SIZES,
                                        num_classes=7, seed=4,
                                        instances=(2, 5))}


@pytest.fixture
def shallow(monkeypatch):
    """Depth 14; the trainer's weights from ``random_init_``: the
    truncated normals of ``fresh_init_`` take 4.5 s a cascade on one core
    (``tests/test_torch_cascade_train.py`` covers them)."""
    monkeypatch.setitem(td._DEPTH_LAYERS, 14, (1, 1, 1, 1))
    monkeypatch.setattr(train_det.engine, "fresh_init_", td.random_init_)


def _options(data, with_val=True, **extra):
    opts = {"data.train.ann_file": data["train"]["ann_file"],
            "data.train.img_prefix": data["train"]["img_prefix"],
            "data.test.ann_file": data["val"]["ann_file"],
            "data.test.img_prefix": data["val"]["img_prefix"],
            "model.depth": 14, "model.num_classes": 7,
            "model.compute_dtype": None, "runner.max_epochs": 2,
            "pipeline.canvas": (64, 96), "pipeline.scales": [(96, 64)],
            "train_cfg.rpn_nms_pre": 200, "train_cfg.rpn_max_per_img": 50,
            "train_cfg.rcnn_num_samples": 16, "train_cfg.num_mask_rois": 2,
            "test_cfg.rpn_nms_pre": 200, "test_cfg.rpn_max_per_img": 50,
            "test_cfg.max_per_img": 20, "data.samples_per_gpu": 2,
            "evaluation.interval": 0, "log_config.tensorboard": False,
            "log_config.interval": 1}
    if with_val:
        opts.update({"data.val.ann_file": data["val"]["ann_file"],
                     "data.val.img_prefix": data["val"]["img_prefix"]})
    opts.update(extra)
    return [f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}"
            for k, v in opts.items()]


def _run(config, work_dir, data, *args, **kw):
    return train_det.main([config, "--work-dir", str(work_dir), "--device",
                           "cpu", "--max-steps", "1", *args,
                           "--cfg-options", *_options(data, **kw)])


def _same_fasa(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for name in FasaState._fields:
            assert torch.equal(getattr(x, name), getattr(y, name)), name


def test_cli_runs_the_dynamic_runner_and_resumes(data, shallow, tmp_path,
                                                 capsys):
    from iif_torch.engine.detection import DetectionTrainer

    snapshots = []
    val_epoch = DetectionTrainer.fasa_val_epoch

    def recording(self, state, loader, print_fn=print):
        state = val_epoch(self, state, loader, print_fn)
        snapshots.append(tuple(s.prob_list.clone() for s in state.fasa))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionTrainer, "fasa_val_epoch", recording)
        trainer, state = _run(CASCADE, tmp_path / "straight", data)
    out = capsys.readouterr().out
    assert "dynamic=True" in out
    assert out.count("FASA dynamic sampling stage") == 6
    assert isinstance(trainer.model, CascadeMaskRCNN)
    assert trainer.grad_clip is None and state.step == 2
    initial = train_det.engine.init_fasa_states(
        trainer.model, trainer_counts(data), {})
    for s0, s1, init in zip(snapshots[0], snapshots[1], initial):
        assert torch.equal(s0, init.prob_list)      # epoch 0: t0 = t1
    assert any(not torch.equal(s1, s0) for s0, s1 in zip(*snapshots))
    assert all(s.cum_loss_t0.any() and not s.cum_losses.any()
               and s.feature_used.any() for s in state.fasa)

    ckpts = tmp_path / "straight" / "checkpoints"
    for n in (1, 2):
        ckpt = torch.load(ckpts / f"epoch_{n}.pth", weights_only=True)
        assert len(ckpt["fasa"]) == 3
        assert set(ckpt["fasa"][0]) == set(FasaState._fields)
    final = torch.load(ckpts / "epoch_2.pth", weights_only=True)["fasa"]
    _same_fasa(state.fasa, [FasaState(**f) for f in final])

    # --resume-from epoch_1.pth: every field as saved, then one more
    # epoch gives the straight run's state
    saved = torch.load(ckpts / "epoch_1.pth", weights_only=True)["fasa"]
    _, restored = _run(CASCADE, tmp_path / "restored", data,
                       "--resume-from", str(ckpts / "epoch_1.pth"),
                       **{"runner.max_epochs": 1})
    _same_fasa(restored.fasa, [FasaState(**f) for f in saved])
    resumed, rstate = _run(CASCADE, tmp_path / "resumed", data,
                           "--resume-from", str(ckpts / "epoch_1.pth"))
    assert rstate.step == 2
    _same_fasa(rstate.fasa, state.fasa)
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k

    # init_detector serves the FASA checkpoint by name
    cfg = Config.fromfile(CASCADE)
    cfg.merge_from_options(parse_cfg_options(_options(data)))
    det = init_detector(cfg, str(ckpts / "latest.pth"), device="cpu")
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k
    res = inference_detector(det, os.path.join(
        data["val"]["img_prefix"], "train2017/000000000001.png"))
    assert res["masks"].shape[1:] == SIZES[0]
    assert np.isfinite(res["scores"]).all()


def trainer_counts(data):
    from iif_torch.detection.datasets import build_dataset

    return build_dataset({"type": "LVISV1Dataset",
                          "ann_file": data["train"]["ann_file"],
                          "img_prefix": data["train"]["img_prefix"]}
                         ).class_instance_counts()


def test_maskrcnn_fasa_config_without_val_falls_back(data, shallow,
                                                     tmp_path):
    """``fasa_iif_r50_rfs_cos_norm_2x.py`` (normed heads, grad clip 35)
    with no ``data.val``: the val pass takes the train loader, with JAX's
    warning; one FASA state; the clipped norm is a metric."""
    config = tmp_path / "no_val.py"
    config.write_text(
        f"_base_ = [{MASKRCNN!r}]\n"
        "data = dict(_delete_=True, train=dict(type='LVISV1Dataset', "
        "oversample_thr=1e-3), test=dict(type='LVISV1Dataset'))\n")
    with pytest.warns(UserWarning, match="no data.val split"):
        trainer, state = _run(str(config), tmp_path / "fallback", data,
                              with_val=False, **{"runner.max_epochs": 1})
    assert trainer.grad_clip == 35
    assert isinstance(state.fasa, FasaState)
    assert state.fasa.cum_loss_t0.any()
