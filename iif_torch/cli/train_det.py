"""Detection training CLI: port of ``iif_tpu/cli/train_det.py`` (the
reference's ``instance_segmentation/tools/train.py``) for one process on
one card::

    python -m iif_torch.cli.train_det configs/iif/iif_r50_1x.py \\
        --work-dir runs/iif_r50 [--cfg-options data.samples_per_gpu=8] \\
        [--resume-from CKPT] [--load-from CKPT] [--max-steps N] \\
        [--device cuda]

It writes ``config_dump.py`` and a ``.log.json`` under the work
directory; builds the train dataset (``oversample_thr`` feeds the
loader's repeat factors), the train pipeline (uint8 canvas, bit-packed
masks) and the loader at ``samples_per_gpu``; checks the dataset's class
count against the model's (mmdet's ``NumClassCheckHook``); builds the
classification loss and ``trainer_from_config``'s trainer; overlays
``model.pretrained_backbone``, then ``--resume-from`` (model, optimizer
momentum, scheduler, step, epoch), then ``--load-from`` (weights); runs
the epochs (``--max-steps`` caps each) and writes a checkpoint at
``checkpoint_config.interval`` and after the last epoch
(``iif_torch/utils/checkpoint.py``, FASA's state included); after each
epoch that ``evaluation.interval`` divides, it evaluates the model on
``data.val`` as ``cli/test_det.py`` does and prints ``eval <metric>
{...}`` for each of ``evaluation.metric`` (the JAX CLI's ``_run_eval``).

With ``fasa_cfg`` it trains with FASA, its state built from the train
set's instance counts (one copy a cascade stage). Under
``runner.type=EpochBasedDynamicRunner`` (the dynamic runner) each epoch
is followed by the FASA val pass over ``data.val`` through the train
pipeline (``--max-steps`` caps it too; without ``data.val``, 50 batches
of the train loader, with JAX's warning) and dynamic sampling, before the
checkpoint.

What it cannot run it refuses with ``NotImplementedError`` before
training: EMA and other custom hooks (the YOLOX mode switch among them),
``--tp``, ``--selectp``, ``pipeline.uint8=False``,
``pipeline.pack_masks=False``, and an evaluation the run would reach
with the metric ``PQ``; the loss, the detector, the pipeline and the
trainer refuse their own unported knobs (Seesaw beside a family other
than MaskRCNN, other families, ``paramwise_cfg`` keys beyond
``norm_decay_mult=0``, extras, ...). ``data.grad_accum`` splits each
batch of ``data.samples_per_gpu`` into that many micro-batches.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

from iif_torch.cli import test_det
from iif_torch.config import Config, parse_cfg_options
from iif_torch.detection.datasets import build_dataset
from iif_torch.detection.detector import DetTestCfg
from iif_torch.detection.inference import (
    Detector,
    build_loss_cls,
    eval_pipeline,
)
from iif_torch.detection.pipeline import DetectionLoader, DetectionPipeline
from iif_torch.detection.pretrained import load_pretrained_backbone
from iif_torch.device import resolve_device
from iif_torch.engine import detection as engine
from iif_torch.utils.checkpoint import (
    load_weights,
    read_meta,
    restore,
    save_checkpoint,
)
from iif_torch.utils.logging import TrainLogWriter


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--selectp", default=0, type=int,
                   help="decoupled fine-tuning (not ported)")
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--max-steps", default=None, type=int,
                   help="cap train steps per epoch (smoke runs)")
    p.add_argument("--tp", default=None, type=int,
                   help="tensor-parallel degree (not ported)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def refuse_unported(cfg: Config, args: argparse.Namespace,
                    start_epoch: int) -> None:
    """``NotImplementedError`` for what this CLI cannot run."""
    hooks = [h.get("type") for h in cfg.get("custom_hooks", []) or []]
    interval = cfg.get("evaluation", {}).get("interval", 0)
    epochs = range(start_epoch, cfg.runner["max_epochs"])
    metrics = cfg.get("evaluation", {}).get("metric", ["bbox"])
    unported = {
        "--tp (tensor parallelism)":
            (args.tp or cfg.get("parallel", {}).get("tp", 1)) > 1,
        "--selectp (decoupled fine-tuning)": bool(args.selectp),
        f"custom_hooks {hooks} (EMA, YOLOX mode switch)": bool(hooks),
        "pipeline uint8=False": not cfg.get("pipeline", {}).get("uint8",
                                                                True),
        "pipeline pack_masks=False": not cfg.get("pipeline", {}).get(
            "pack_masks", True),
        "evaluation metric PQ (panoptic evaluation)": "PQ" in metrics
            and bool(interval)
            and any((e + 1) % interval == 0 for e in epochs),
    }
    for knob, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{knob} is not ported")


def build_pipeline(cfg: Config) -> DetectionPipeline:
    """The train pipeline as the JAX CLI builds it by default (uint8
    canvas, bit-packed masks)."""
    pcfg = cfg.get("pipeline", {})
    return DetectionPipeline(
        canvas=tuple(pcfg.get("canvas", (800, 1344))),
        scales=[tuple(s) for s in pcfg.get("scales", [(1333, 800)])],
        flip_prob=pcfg.get("flip_prob", 0.5),
        max_gt=pcfg.get("max_gt", 100),
        with_mask=cfg.model.get("with_mask", True),
        mask_stride=pcfg.get("mask_stride", 1),
        canvas_buckets=pcfg.get("canvas_buckets", False),
        keep_ratio=pcfg.get("keep_ratio", True),
        extra_transforms=pcfg.get("extras", []),
        with_seg=pcfg.get("with_seg", False),
        max_proposals=pcfg.get(
            "max_proposals",
            512 if not cfg.model.get("with_rpn", True) else 0))


def _run_eval(cfg: Config, trainer: engine.DetectionTrainer,
              metrics: List[str]) -> Dict[str, Dict[str, Any]]:
    """The evaluation hook (``iif_tpu/cli/train_det.py::_run_eval``, the
    reference's ``EvalHook``): the trainer's model in eval mode over
    ``data.val`` through ``test_det.run_inference``, each metric printed
    as ``eval <metric> {...}`` (``test_det.evaluate_metrics``); the
    results by metric."""
    val_ds = build_dataset({k: v for k, v in cfg.data["val"].items()
                            if k != "oversample_thr"})
    detector = Detector(trainer.model.eval(), trainer.loss_cls,
                        DetTestCfg(**cfg.get("test_cfg", {})),
                        eval_pipeline(cfg), val_ds.CLASSES, trainer.device)
    loader = test_det._EvalLoader(val_ds, detector,
                                  cfg.data.get("samples_per_gpu", 4))
    results = test_det.run_inference(detector, loader, val_ds.cat_ids,
                                     cfg.model.get("with_mask", True))
    return test_det.evaluate_metrics(val_ds, cfg, results, metrics,
                                     prefix=("eval",))


def fasa_train_fallback(loader: DetectionLoader, n_batches: int = 50
                        ) -> "_Capped":
    """The dynamic runner's val pass without a ``data.val`` split
    (``iif_tpu/cli/train_det.py:80-97``): ``n_batches`` of the train
    loader, with JAX's warning."""
    import warnings

    warnings.warn(
        "FASA DynamicRunner: no data.val split configured — falling "
        "back to a 50-batch slice of the TRAIN loader for the "
        "dynamic-sampling pass. This changes the algorithm: the "
        "adaptive signal comes from train loss instead of val loss "
        "(reference workflow [('train',1),('val',1)] uses the val "
        "split). Configure data.val to match the reference.",
        UserWarning, stacklevel=2)
    return _Capped(loader, n_batches)


class _Capped:
    """The first ``n`` batches of ``loader`` an epoch; closes the
    loader's iterator when done."""

    def __init__(self, loader: DetectionLoader, n: int):
        self.loader = loader
        self.n = n

    def __len__(self) -> int:
        return min(len(self.loader), self.n)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator:
        batches = iter(self.loader)
        try:
            for _ in range(len(self)):
                yield next(batches)
        finally:
            batches.close()


def main(argv: Optional[List[str]] = None
         ) -> Tuple[engine.DetectionTrainer, engine.DetTrainState]:
    """Runs the training; returns the trainer and its final state."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(parse_cfg_options(args.cfg_options))
    device = resolve_device(args.device)
    resume = args.resume_from or cfg.get("resume_from")
    start_epoch = int(read_meta(resume)["epoch"]) if resume else 0
    refuse_unported(cfg, args, start_epoch)
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(os.path.join(work_dir, "config_dump.py"))
    seed = args.seed if args.seed is not None else cfg.get("seed", 0)

    dcfg = cfg.data
    train_ds = build_dataset({k: v for k, v in dcfg["train"].items()
                              if k != "oversample_thr"})
    loader = DetectionLoader(
        train_ds, build_pipeline(cfg),
        batch_size=dcfg.get("samples_per_gpu", 4),
        oversample_thr=dcfg["train"].get("oversample_thr", 0.0), seed=seed)
    num_classes = cfg.model["num_classes"]
    if len(train_ds.CLASSES) != num_classes:
        raise ValueError(
            f"model.num_classes={num_classes} != dataset classes "
            f"{len(train_ds.CLASSES)} ({dcfg['train'].get('ann_file')})")
    loss_cls = build_loss_cls(cfg.loss_cls, train_ds, num_classes)

    trainer = engine.trainer_from_config(
        cfg, loss_cls, steps_per_epoch=max(len(loader), 1), seed=seed,
        device=device)
    fasa_cfg = cfg.get("fasa_cfg")
    state = trainer.init_state(None if fasa_cfg is None else
                               engine.init_fasa_states(
                                   trainer.model,
                                   train_ds.class_instance_counts(),
                                   fasa_cfg, trainer.device))
    if cfg.model.get("pretrained_backbone"):
        load_pretrained_backbone(trainer.model,
                                 cfg.model["pretrained_backbone"])
    if resume:
        restore(resume, trainer.model, state)
    load_from = args.load_from or cfg.get("load_from")
    if load_from:
        load_weights(load_from, trainer.model)

    log_writer = TrainLogWriter(
        work_dir, tensorboard=cfg.get("log_config", {}).get("tensorboard",
                                                            True))
    log_writer.write_env_header(exp_name=os.path.basename(args.config),
                                seed=cfg.get("seed"))
    max_epochs = cfg.runner["max_epochs"]
    interval = cfg.get("checkpoint_config", {}).get("interval", 1)
    eval_cfg = cfg.get("evaluation", {})
    eval_interval = eval_cfg.get("interval", 0)
    dynamic = cfg.runner.get("type") == "EpochBasedDynamicRunner"
    fasa_val_loader = None
    if dynamic and state.fasa is not None:
        # the val set through the TRAIN pipeline, as the reference's
        # workflow [('train', 1), ('val', 1)] builds it
        if "val" in dcfg:
            fasa_val_loader = DetectionLoader(
                build_dataset({k: v for k, v in dcfg["val"].items()
                               if k != "oversample_thr"}),
                loader.pipeline, batch_size=loader.batch_size,
                oversample_thr=0.0, seed=seed)
        else:
            fasa_val_loader = fasa_train_fallback(loader)
    print(f"Start training: {max_epochs} epochs, {len(loader)} "
          f"steps/epoch on {device}, dynamic={dynamic}")
    try:
        for epoch in range(start_epoch, max_epochs):
            state, _ = trainer.train_one_epoch(
                state, _Capped(loader, args.max_steps) if args.max_steps
                else loader, epoch,
                print_freq=cfg.get("log_config", {}).get("interval", 50),
                log_writer=log_writer)
            if fasa_val_loader is not None:
                state = trainer.fasa_val_epoch(
                    state, _Capped(fasa_val_loader, args.max_steps)
                    if args.max_steps else fasa_val_loader)
            if (epoch + 1) % interval == 0 or epoch == max_epochs - 1:
                save_checkpoint(work_dir, epoch + 1, trainer.model, state,
                                cfg.pretty_text())
            if eval_interval and (epoch + 1) % eval_interval == 0:
                _run_eval(cfg, trainer, eval_cfg.get("metric", ["bbox"]))
    finally:
        log_writer.close()
    print("done")
    return trainer, state


if __name__ == "__main__":
    main()
