"""The port's inference API, pipeline and server on the CPU: the eval
pipeline against the JAX package's, the IIF loss that ``init_detector``
builds against ``iif_tpu``'s ``build_loss_cls``, batched against single
requests, checkpoint loading, and the HTTP server."""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from iif_torch.config import Config
from iif_torch.detection.datasets import CocoStyleDataset
from iif_torch.detection.inference import (
    build_loss_cls,
    inference_detector,
    inference_detector_batch,
    init_detector,
)
from iif_torch.detection.losses import DetCrossEntropyLoss, DetIIFLoss
from iif_torch.detection.pipeline import DetectionPipeline

torch.set_num_threads(1)

CFG_PATH = "configs/iif/iif_r50_1x.py"
NUM_CLASSES = 5


def _annotations(path, rng):
    """A tiny LVIS-style file: 5 categories with ``image_count``, 30
    images of which 20 carry annotations."""
    cats = [{"id": i + 3, "name": f"c{i}",
             "image_count": int(rng.randint(1, 20))}
            for i in range(NUM_CLASSES)]
    images = [{"id": i, "width": 64, "height": 48} for i in range(30)]
    anns = [{"id": j, "image_id": int(rng.randint(0, 20)),
             "category_id": int(rng.randint(3, 8)),
             "bbox": [1.0, 2.0, 10.0, 12.0], "area": 120.0}
            for j in range(60)]
    path.write_text(json.dumps({"categories": cats, "images": images,
                                "annotations": anns}))


def _config(ann_file=None):
    cfg = Config.fromfile(CFG_PATH)
    cfg.model["num_classes"] = NUM_CLASSES
    cfg.model["compute_dtype"] = "float32"
    cfg.pipeline = dict(canvas=(64, 96), scales=[(96, 64)])
    cfg.test_cfg = dict(score_thr=0.01, max_per_img=20, rpn_nms_pre=50,
                        rpn_max_per_img=30)
    if ann_file is not None:
        cfg.data["test"]["ann_file"] = str(ann_file)
    return cfg


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    path = tmp_path_factory.mktemp("ann") / "lvis.json"
    _annotations(path, np.random.RandomState(0))
    return init_detector(_config(path), device="cpu"), path


@pytest.mark.parametrize("variant", ["raw", "smooth_obj"])
def test_init_builds_the_iif_loss_like_jax(detector, variant):
    """IIF weights from the annotation counts, rtol 1e-6 against
    ``iif_tpu.cli.train_det.build_loss_cls`` on the JAX dataset."""
    from iif_tpu.cli.train_det import build_loss_cls as jax_build
    from iif_tpu.detection.datasets import CocoStyleDataset as JaxDataset

    det, path = detector
    assert isinstance(det.loss_cls, DetIIFLoss)
    assert det.CLASSES == [f"c{i}" for i in range(NUM_CLASSES)]
    cfg_loss = {"type": "DetIIFLoss", "variant": variant}
    got = build_loss_cls(cfg_loss, CocoStyleDataset(str(path)), NUM_CLASSES)
    want = jax_build(cfg_loss, JaxDataset(str(path), lvis_style=True),
                     NUM_CLASSES)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-6)


def test_init_falls_back_to_ce_without_annotations():
    det = init_detector(_config(), device="cpu")    # data/lvis_v1 absent
    assert isinstance(det.loss_cls, DetCrossEntropyLoss)
    assert det.CLASSES == [str(i) for i in range(NUM_CLASSES)]


@pytest.mark.parametrize("hw", [(64, 96), (48, 64), (50, 70), (120, 90)])
def test_pipeline_matches_jax(hw):
    """img_shape and scale_factor exact. Pixels exact where no resize
    happens; through a resize, within 1 grey level (cv2's fixed-point
    INTER_LINEAR against PyTorch's f32 bilinear)."""
    from iif_tpu.detection.pipeline import DetectionPipeline as JaxPipe

    img = np.random.RandomState(hw[0]).randint(
        0, 256, hw + (3,)).astype(np.uint8)
    ann = {"boxes": np.zeros((0, 4), np.float32),
           "labels": np.zeros(0, np.int64), "segms": [],
           "width": hw[1], "height": hw[0]}
    want = JaxPipe(canvas=(64, 96), scales=[(96, 64)], flip_prob=0.0,
                   max_gt=1, emit_uint8=True)(img, ann,
                                              np.random.RandomState(0),
                                              train=False)
    got = DetectionPipeline(canvas=(64, 96), scales=[(96, 64)])(
        img, torch.device("cpu"))
    np.testing.assert_array_equal(got["img_shape"], want["img_shape"])
    assert got["scale_factor"] == want["scale_factor"]
    diff = np.abs(got["image"].numpy().astype(int)
                  - want["image"].astype(int))
    assert diff.max() <= (0 if hw == (64, 96) else 1)


def test_inference_single_and_batch(detector):
    """Original-frame outputs; a padded batch gives the single-request
    detections (same keep sets, boxes atol 1e-3 px)."""
    det, _ = detector
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (48, 80, 3)).astype(np.uint8),
            rng.randint(0, 256, (64, 60, 3)).astype(np.uint8)]
    singles = [inference_detector(det, im) for im in imgs]
    batch = inference_detector_batch(det, imgs, pad_to=3, masks=False)
    assert len(batch) == 2
    for s, b, im in zip(singles, batch, imgs):
        assert s["masks"].shape == (20,) + im.shape[:2]
        assert s["masks"].dtype == np.bool_ and "masks" not in b
        assert s["boxes"].shape == (20, 4) and s["valid"].any()
        assert s["boxes"][:, 2].max() <= im.shape[1] + 1e-3
        np.testing.assert_array_equal(b["valid"], s["valid"])
        np.testing.assert_array_equal(b["labels"], s["labels"])
        np.testing.assert_allclose(b["boxes"], s["boxes"], atol=1e-3)
    assert inference_detector_batch(det, []) == []


def test_checkpoint_loads_by_mmdet_names(detector, tmp_path):
    det, path = detector
    state = det.model.state_dict()
    ckpt = tmp_path / "model.pth"
    torch.save({"state_dict": {"module." + k: v * 2 if v.is_floating_point()
                               else v for k, v in state.items()}}, ckpt)
    loaded = init_detector(_config(path), checkpoint=str(ckpt), device="cpu")
    for k, v in loaded.model.state_dict().items():
        want = state[k] * 2 if v.is_floating_point() else state[k]
        assert torch.equal(v, want), k


@pytest.mark.parametrize("max_batch", [1, 2])
def test_server_ping_and_predictions(detector, max_batch):
    """TorchServe-shaped endpoints on localhost, single and micro-batched."""
    import cv2

    from iif_torch.cli.serve import make_server

    det, _ = detector
    server = make_server(det, score_thr=0.0, port=0, max_batch=max_batch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/ping", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "Healthy"}
        img = np.random.RandomState(4).randint(0, 256, (40, 56, 3))
        ok, png = cv2.imencode(".png", img.astype(np.uint8))
        assert ok
        req = urllib.request.Request(base + "/predictions/model",
                                     data=png.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            preds = json.loads(r.read())
        assert preds and {"class_name", "bbox", "score"} <= set(preds[0])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
