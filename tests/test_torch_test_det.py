"""``iif_torch/cli/test_det.py`` and the training CLI's evaluation hook on
the CPU, against the JAX package where both run:

- ``run_inference`` of both packages on the same 6 PNGs at b4 (the last
  batch padded), the detector's forward replaced in each by one seeded
  fixed output (``make_simple_test`` monkeypatched; no model is built):
  every record equal, image and category ids, boxes and scores bit for
  bit, and the RLE strings (the two pastes, JAX's scale_and_translate and
  the port's separable einsum, threshold every pixel alike here: 0
  pixels apart over 323 masks of 4 seeds of these outputs);
- ``_EvalLoader``'s batches (ids, original shapes, scale factors, padding)
  equal to JAX's, the canvases within one grey level (PyTorch's bilinear
  against cv2's);
- ``test_cli_trains_evaluates_and_tests`` makes the CLI runs (one test,
  so that one worker of a parallel run makes them): ``train_det`` with
  ``evaluation.interval=1`` runs the hook once after its one epoch on
  ``bbox``, ``segm``, ``proposal_fast`` and ``mAP``, then
  ``test_det.main`` on the checkpoint writes ``--out`` and gives the
  hook's four results and its records;
- every unported flag raises ``NotImplementedError`` naming it;
- the synthetic sets: ``neg_ids`` adds only the per-image ids, and the
  squares set has the JAX harness's (``scripts/overfit_cascade.py``)
  draws and annotations.

The ``cuda`` tests (skipped without a card): the rescaled boxes equal
NumPy's true division on the card, and ``test_det`` runs through K1 on
its eight-channel path."""
import json
import os

import numpy as np
import pytest
import torch

from iif_torch.cli import test_det, train_det
from iif_torch.config import Config, parse_cfg_options
from iif_torch.detection import simple_test
from iif_torch.detection.datasets import build_dataset
from iif_torch.detection.detector import DetTestCfg
from iif_torch.detection.inference import (
    Detector,
    eval_pipeline,
    init_detector,
    rescale_boxes,
)
from iif_torch.tools.synthetic_lvis import write_synthetic_lvis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/iif/iif_r50_1x.py")
SIZES = [(48, 64), (40, 56)] * 3
CANVAS, SCALE = (64, 96), (96, 64)
B, K = 4, 20
MAX_DETS = 10


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    return write_synthetic_lvis(str(root), SIZES, num_classes=5, seed=4,
                                instances=(2, 5), neg_ids=True)


@pytest.fixture(scope="module")
def batch_set(tmp_path_factory):
    """One b4 batch of PNGs, for the CLI runs."""
    root = tmp_path_factory.mktemp("batch")
    return write_synthetic_lvis(str(root), SIZES[:B], num_classes=5, seed=5,
                                instances=(2, 5), neg_ids=True)


def _fixed_output(seed=0):
    """One detector output on the (64, 96) canvas: boxes from sub-pixel
    to half the canvas, about 70% valid, half the masks noise and half
    smooth blobs."""
    rng = np.random.RandomState(seed)
    wh = np.exp(rng.uniform(np.log(0.5), np.log(48), (B, K, 2)))
    xy = rng.uniform(-4, 1, (B, K, 2)) * [[CANVAS[1] / 2, CANVAS[0] / 2]]
    xy = np.abs(xy)
    yy, xx = np.mgrid[:28, :28] / 27.0
    c = rng.uniform(0.2, 0.8, (B, K, 2, 1, 1))
    blob = 1 / (1 + np.exp(-(0.3 - (xx - c[:, :, 0]) ** 2
                             - (yy - c[:, :, 1]) ** 2) * 20))
    masks = np.where((np.arange(K) % 2 == 0)[None, :, None, None],
                     rng.rand(B, K, 28, 28), blob)
    return {"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "scores": rng.rand(B, K).astype(np.float32),
            "labels": rng.randint(0, 5, (B, K)).astype(np.int64),
            "valid": rng.rand(B, K) < 0.7,
            "masks": masks.astype(np.float32)}


def _jax_loader(data):
    from iif_tpu.cli.test_det import _EvalLoader
    from iif_tpu.detection.datasets import DATASETS
    from iif_tpu.detection.pipeline import DetectionPipeline

    ds = DATASETS.build({"type": "LVISV1Dataset", **data})
    pipe = DetectionPipeline(canvas=CANVAS, scales=[SCALE], flip_prob=0.0,
                             max_gt=1, emit_uint8=True, with_mask=True)
    return ds, _EvalLoader(ds, pipe, B)


def _port_loader(data):
    ds = build_dataset({"type": "LVISV1Dataset", **data})
    cfg = Config.fromdict({"pipeline": {"canvas": CANVAS,
                                        "scales": [SCALE]}})
    det = Detector(None, None, DetTestCfg(), eval_pipeline(cfg),
                   ds.CLASSES, torch.device("cpu"))
    return ds, det, test_det._EvalLoader(ds, det, B)


def test_eval_loader_equals_jax(data):
    _, jax_loader = _jax_loader(data)
    _, _, loader = _port_loader(data)
    ours, theirs = list(loader), list(jax_loader)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        for k in ("image_ids", "orig_shape", "img_shape", "scale_factor"):
            assert np.array_equal(a[k], b[k]), k
            assert a[k].dtype == b[k].dtype, k
        diff = np.abs(a["image"].numpy().astype(int) - b["image"])
        assert diff.max() <= 1
    assert list(ours[1]["image_ids"][2:]) == [-1, -1]
    assert torch.equal(ours[1]["image"][3], ours[1]["image"][1])


def test_run_inference_equals_jax(data, monkeypatch):
    import jax.numpy as jnp

    import iif_tpu.cli.test_det as jax_test_det
    import iif_tpu.detection.simple_test as jax_simple_test

    out = _fixed_output()
    monkeypatch.setattr(jax_simple_test, "make_simple_test", lambda *a: (
        lambda v, img: {k: jnp.asarray(x) for k, x in out.items()}, False))
    monkeypatch.setattr(simple_test, "make_simple_test", lambda *a: (
        lambda images: {k: torch.from_numpy(x) for k, x in out.items()}))
    jax_ds, jax_loader = _jax_loader(data)
    ds, det, loader = _port_loader(data)
    want = jax_test_det.run_inference(None, None, jax_loader, None, None,
                                      jax_ds.cat_ids, True)
    got = test_det.run_inference(det, loader, ds.cat_ids, True)
    # all 4 rows of the first batch, the 2 real ones of the second
    assert len(got) == len(want) == out["valid"].sum() \
        + out["valid"][:2].sum()
    for a, b in zip(got, want):
        assert a == b
    assert sorted({r["image_id"] for r in got}) == sorted(
        ds.img_infos[i]["id"] for i in range(len(ds)))


def _options(data, **extra):
    opts = {"data.train.ann_file": data["ann_file"],
            "data.train.img_prefix": data["img_prefix"],
            "data.val.ann_file": data["ann_file"],
            "data.val.img_prefix": data["img_prefix"],
            "data.test.ann_file": data["ann_file"],
            "data.test.img_prefix": data["img_prefix"],
            "model.num_classes": 5, "model.compute_dtype": None,
            "pipeline.canvas": CANVAS, "pipeline.scales": [SCALE],
            "train_cfg.rpn_nms_pre": 200, "train_cfg.rpn_max_per_img": 20,
            "train_cfg.rcnn_num_samples": 8, "train_cfg.num_mask_rois": 2,
            "test_cfg.rpn_nms_pre": 200, "test_cfg.rpn_max_per_img": 20,
            "test_cfg.max_per_img": MAX_DETS, "data.samples_per_gpu": B,
            "log_config.tensorboard": False, "log_config.interval": 1}
    opts.update(extra)
    return [f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}"
            for k, v in opts.items()]


def test_cli_trains_evaluates_and_tests(batch_set, tmp_path, monkeypatch):
    data = batch_set
    hooks, runs = [], []
    run_eval, run_inference = train_det._run_eval, test_det.run_inference

    def recording(*args, **kw):
        hooks.append(run_eval(*args, **kw))
        return hooks[-1]

    def inferring(*args, **kw):
        runs.append(run_inference(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(train_det, "_run_eval", recording)
    monkeypatch.setattr(test_det, "run_inference", inferring)
    work = tmp_path / "work"
    _, state = train_det.main([
        CONFIG, "--work-dir", str(work), "--device", "cpu", "--max-steps",
        "1", "--cfg-options", *_options(data, **{
            "runner.max_epochs": 1, "evaluation.interval": 1,
            "evaluation.metric": ["bbox", "segm", "proposal_fast",
                                  "mAP"]})])
    assert state.step == 1 and len(hooks) == 1
    assert set(hooks[0]) == {"bbox", "segm", "proposal_fast", "mAP"}
    assert {"APr", "APc", "APf"} <= hooks[0]["bbox"].keys()

    out = tmp_path / "results.json"
    metrics = test_det.main([
        CONFIG, str(work), "--eval", "bbox", "segm", "proposal_fast", "mAP",
        "--out", str(out), "--device", "cpu", "--cfg-options",
        *_options(data)])
    assert set(metrics) == {"bbox", "segm", "proposal_fast", "mAP"}
    assert list(metrics["proposal_fast"]) == ["AR@100", "AR@300", "AR@1000"]
    assert all(0.0 <= v <= 1.0 for v in metrics["proposal_fast"].values())
    assert 0.0 <= metrics["mAP"]["mAP"] <= 1.0
    assert len(metrics["mAP"]["per_class"]) == 5
    assert metrics["proposal_fast"] == hooks[0]["proposal_fast"]
    assert metrics["mAP"] == hooks[0]["mAP"]
    for m in ("bbox", "segm"):
        res = metrics[m]
        assert res.keys() == hooks[0][m].keys()
        for k, v in res.items():
            assert v == hooks[0][m][k] or (np.isnan(v) and np.isnan(
                hooks[0][m][k])), (m, k)
    records = json.loads(out.read_text())
    assert len(runs) == 2 and runs[0] == runs[1] == records
    ids = {r["id"] for r in build_dataset(
        {"type": "LVISV1Dataset", **data}).img_infos}
    assert records and {r["image_id"] for r in records} <= ids
    for r in records:
        assert {"image_id", "category_id", "bbox", "score", "segmentation",
                "area"} <= r.keys()
    per_img = np.bincount([r["image_id"] for r in records])
    assert per_img.max() <= MAX_DETS

    assert test_det.resolve_checkpoint(str(work)) == str(
        work / "checkpoints" / "latest.pth")
    ckpts = work / "checkpoints"
    assert test_det.resolve_checkpoint(str(ckpts)) == str(
        ckpts / "latest.pth")
    assert test_det.resolve_checkpoint(str(ckpts / "epoch_1.pth")) == str(
        ckpts / "epoch_1.pth")
    with pytest.raises(FileNotFoundError):
        test_det.resolve_checkpoint(str(tmp_path / "nothing"))


@pytest.mark.parametrize("flags,name", [
    (["--tta", "--eval", "bbox", "PQ"], "--tta"),
    (["--exported", "model.pt"], "--exported"),
    (["--fuse-conv-bn"], "--fuse-conv-bn"),
    (["--eval", "bbox", "PQ"], "--eval PQ"),
    (["--show-dir", "shown"], "--show-dir")])
def test_unported_flags_raise(flags, name):
    """The flags of unported modules raise ``NotImplementedError``;
    ``--tta`` (ported) exits with JAX's message beside ``--eval PQ``."""
    error = SystemExit if "--tta" in flags else NotImplementedError
    with pytest.raises(error, match=name):
        test_det.main([CONFIG, "missing.pth", *flags, "--device", "cpu"])


def test_synthetic_sets(tmp_path):
    import importlib.util

    from iif_torch.detection.image_io import read_image
    from iif_torch.tools.synthetic_lvis import write_synthetic_squares

    plain = write_synthetic_lvis(str(tmp_path / "a"), SIZES[:3], 9, seed=3)
    ids = write_synthetic_lvis(str(tmp_path / "b"), SIZES[:3], 9, seed=3,
                               neg_ids=True)
    a, b = (json.load(open(d["ann_file"])) for d in (plain, ids))
    assert a["annotations"] == b["annotations"]
    assert a["categories"] == b["categories"]
    assert any(y["neg_category_ids"] for y in b["images"])
    for x, y in zip(a["images"], b["images"]):
        assert x["neg_category_ids"] == x["not_exhaustive_category_ids"] \
            == []
        own = {n["category_id"] for n in b["annotations"]
               if n["image_id"] == y["id"]}
        absent = {n["category_id"] for n in b["annotations"]} - own
        assert set(y["neg_category_ids"]) <= absent
        assert len(y["neg_category_ids"]) == min(3, len(absent))
        assert set(y["not_exhaustive_category_ids"]) <= own
        name = x["coco_url"].split("/", 3)[-1]
        assert (open(os.path.join(plain["img_prefix"], name), "rb").read()
                == open(os.path.join(ids["img_prefix"], name), "rb").read())

    spec = importlib.util.spec_from_file_location(
        "overfit_cascade", os.path.join(REPO, "scripts/overfit_cascade.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    jax_ann = json.load(open(harness.make_dataset(str(tmp_path / "jax"))))
    squares = write_synthetic_squares(str(tmp_path / "port"))
    ours = json.load(open(squares["ann_file"]))
    assert ours["categories"] == jax_ann["categories"]
    assert ours["annotations"] == jax_ann["annotations"]
    for x, y in zip(ours["images"], jax_ann["images"]):
        assert x == dict(y, file_name=y["file_name"].replace(".jpg", ".png"))
    for x, n in zip(ours["images"], ours["annotations"]):
        img = read_image(os.path.join(squares["img_prefix"], x["file_name"]))
        bx, by, bw, bh = n["bbox"]
        assert (img[by:by + bh, bx:bx + bw] == 230).all()
        assert img.shape == (96, 128, 3) and img[0, 0].max() < 100


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_rescaled_boxes_are_a_true_division_on_card():
    _card()
    rng = np.random.RandomState(0)
    boxes = (rng.rand(4, 300, 4) * 1333).astype(np.float32)
    sf = rng.uniform(0.4, 2.5, 4).astype(np.float32)
    got = rescale_boxes(torch.from_numpy(boxes).cuda(), sf[:, None, None])
    assert np.array_equal(got.cpu().numpy(), boxes / sf[:, None, None])
    for i in range(4):
        one = rescale_boxes(torch.from_numpy(boxes[i]).cuda(), sf[i])
        assert np.array_equal(one.cpu().numpy(), boxes[i] / sf[i])


@pytest.mark.cuda
def test_test_det_through_k1_on_card(batch_set, tmp_path):
    """4 PNGs at b4 on the card: one batch, K1 launched once a size, on
    its eight-channel path; finite records."""
    _card()
    from iif_torch.ops.roi_align_ml import reset_launches, roi_align_ml

    data = batch_set
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(parse_cfg_options(_options(data)))
    det = init_detector(cfg, device="cuda")
    ckpt = tmp_path / "random.pth"
    torch.save({"state_dict": det.model.state_dict()}, ckpt)
    reset_launches()
    metrics = test_det.main([
        CONFIG, str(ckpt), "--eval", "bbox", "segm", "--out", str(tmp_path / "r.json"), "--cfg-options",
        *_options(data)])
    assert roi_align_ml.launches_by_size == {7: 1, 14: 1}
    assert roi_align_ml.launches_by_path == {"vec8": 2}
    assert set(metrics) == {"bbox", "segm"}
    records = json.loads((tmp_path / "r.json").read_text())
    assert records and all(np.isfinite(r["bbox"]).all() for r in records)
