"""Classification training CLI: port of ``iif_tpu/cli/train.py`` (the
reference's ``classification/train.py`` flags) for one process on one
card::

    python -m iif_torch.cli.train --dset_name cifar100 --data-path DATA \\
        --model resnet32 --classif iif --iif raw --imb_factor 0.01 \\
        --epochs 200 --cosine_scheduler --output-dir runs/c100 \\
        [--device cuda]
    python -m iif_torch.cli.train ... --test-only \\
        --load_from runs/c100/checkpoints

The same flags as the JAX CLI, and ``--device`` (default ``cuda``; it
raises without CUDA unless given ``cpu``). Datasets: cifar10, cifar100
(the python-pickle files under ``--data-path``), synthetic (the JAX
package's separable stand-in: 500 images a class, 100 a class to
evaluate), imagenet_lt, places_lt and inat18 (``<path> <label>`` lists,
PNG images). ``--bn-groups`` / ``--sync-bn`` resolve as in JAX with one
data-parallel device. ``--decoup`` freezes all but the head (BatchNorm
still takes batch statistics and updates its running ones) and
re-initialises the head; ``--resume`` restores the newest checkpoint of
``<output-dir>/checkpoints``; ``--load_from`` (a checkpoint or a
directory of them) then loads its model weights over everything.
``--test-only`` evaluates and prints Many / Median / Low;
``--record-result`` appends the best Acc@1 to ``results.csv``.

``--auto-augment`` takes the policy as JAX's CLI does (``cifar`` or
``oneof`` on the CIFAR datasets, ``imagenet``, ``randaugment`` or
``oneof`` on the others; a value that does not fit the dataset leaves the
plain pipeline, as in JAX); ``--random-erase P`` adds random erasing
with probability P; ``--opt`` is ``sgd``, ``nesterov``, ``rmsprop`` or
``adamw``. ``main(args, qat=...)`` trains with QAT
(``iif_torch/cli/train_quantization.py``).

Checkpoints are ``<output-dir>/checkpoints/epoch_{n}.pth`` (``n`` the
epochs finished, ``latest.pth`` the newest) holding the model, the
optimizer, the scheduler, the epoch and the args; the JAX package writes
orbax directories instead. Unported flags raise ``NotImplementedError``
naming the flag: ``--world-size`` other than 1, ``--dist-url`` other than
``env://`` and ``--pretrained`` (which the JAX CLI defines and never
reads).
"""
from __future__ import annotations

import argparse
import csv
import datetime
import os
import time

import torch

from iif_torch.data.cifar_lt import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    ImbalancedArrays,
    load_cifar,
    make_synthetic_cifar,
)
from iif_torch.data import augment
from iif_torch.data.loader import Loader, eval_batches
from iif_torch.data.lt_dataset import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    INAT18_MEAN,
    INAT18_STD,
    LTDataset,
    LTDatasetEval,
)
from iif_torch.device import resolve_device
from iif_torch.engine.classification import ClassificationTrainer
from iif_torch.engine.per_shot import shot_acc
from iif_torch.engine.schedules import (
    build_lr_schedule,
    freeze_all_but_head,
    reinit_classifier_head,
)
from iif_torch.losses import get_criterion
from iif_torch.models.factory import build_classifier
from iif_torch.models.init import classifier_fresh_init_
from iif_torch.utils.checkpoint import (
    latest_step,
    load_weights,
    restore,
    save_checkpoint,
)
from iif_torch.utils.logging import TrainLogWriter


def get_args_parser(add_help: bool = True) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="IIF classification training (PyTorch)",
        add_help=add_help)
    parser.add_argument("--data-path", default="./datasets")
    parser.add_argument("--dset_name", default="cifar100",
                        help="imagenet_lt|inat18|places_lt|cifar10|"
                        "cifar100|synthetic")
    parser.add_argument("--rand_number", default=0, type=int)
    parser.add_argument("--imb_type", default="exp", type=str)
    parser.add_argument("--imb_factor", default=0.01, type=float)
    parser.add_argument("--sampler", default="random", type=str,
                        help="random|upsampling|downsampling")
    parser.add_argument("--cache-dataset", dest="cache_dataset",
                        action="store_true")
    parser.add_argument("--train-txt", default=None)
    parser.add_argument("--eval-txt", default=None)
    parser.add_argument("--model", default="resnet32")
    parser.add_argument("--classif_norm", default=None, type=str,
                        help="{None,norm,cosine,lr_cosine}")
    parser.add_argument("--pretrained", default=None, type=str,
                        help="not ported")
    parser.add_argument("--classif", default="ce", type=str,
                        help="iif|bce|focal_loss|ce")
    parser.add_argument("--iif", default="raw", type=str,
                        help="raw|smooth|rel|normit|gombit|base2|base10")
    parser.add_argument("--iif_norm", default=0, type=int)
    parser.add_argument("--gamma", default=0.0, type=float)
    parser.add_argument("--alpha", default=None, type=float)
    parser.add_argument("--reduction", default="mean", type=str)
    parser.add_argument("--deffered", action="store_true",
                        help="deferred re-weighting (N/n_c class weights)")
    parser.add_argument("--mixup", default=None, type=float)
    parser.add_argument("-b", "--batch-size", default=32, type=int)
    parser.add_argument("--epochs", default=400, type=int)
    parser.add_argument("-j", "--workers", default=4, type=int,
                        help="batches prefetched by the loader's thread")
    parser.add_argument("--opt", default="sgd", type=str,
                        help="sgd|nesterov|rmsprop|adamw")
    parser.add_argument("--lr", default=0.1, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--wd", "--weight-decay", default=1e-4, type=float,
                        dest="weight_decay")
    parser.add_argument("--milestones", nargs="+", default=[360, 380],
                        type=int)
    parser.add_argument("--lr-gamma", default=0.1, type=float)
    parser.add_argument("--cosine_scheduler", action="store_true")
    parser.add_argument("--decoup", action="store_true",
                        help="freeze all but the classifier head")
    parser.add_argument("--auto-augment", default=None,
                        help="cifar|imagenet|randaugment|oneof")
    parser.add_argument("--random-erase", default=0.0, type=float,
                        help="random erasing probability")
    parser.add_argument("--print-freq", default=100, type=int)
    parser.add_argument("--output-dir", default=".", type=str)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--load_from", default="", type=str)
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("--test-only", dest="test_only",
                        action="store_true")
    parser.add_argument("--record-result", dest="record_result",
                        action="store_true")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--fp32", dest="bf16", action="store_false")
    parser.add_argument("--world-size", default=1, type=int)
    parser.add_argument("--dist-url", default="env://")
    parser.add_argument("--sync-bn", dest="sync_bn", action="store_true")
    parser.add_argument("--bn-groups", default=0, type=int,
                        help="BN statistics groups along the batch axis; "
                        "0 = one a data-parallel device (here 1)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def refuse_unported(args) -> None:
    unported = {
        "--world-size other than 1": args.world_size != 1,
        "--dist-url other than env://": args.dist_url != "env://",
        "--pretrained": bool(args.pretrained),
    }
    for flag, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{flag} is not ported")


def build_data(args):
    """The datasets of ``--dset_name``, as the JAX CLI builds them."""
    name = args.dset_name
    if name in ("cifar10", "cifar100", "synthetic"):
        cls_num = 10 if name == "cifar10" else 100
        if name == "synthetic":
            data, targets = make_synthetic_cifar(500, cls_num,
                                                 seed=args.rand_number)
            eval_data, eval_targets = make_synthetic_cifar(100, cls_num,
                                                           seed=999)
        else:
            data, targets = load_cifar(args.data_path, name, train=True)
            eval_data, eval_targets = load_cifar(args.data_path, name,
                                                 train=False)
        train_ds = ImbalancedArrays(data, targets, cls_num, args.imb_type,
                                    args.imb_factor, args.rand_number)
        return dict(train=train_ds, train_data=train_ds.data,
                    train_targets=train_ds.targets, eval_data=eval_data,
                    eval_targets=eval_targets, num_classes=cls_num,
                    kind="cifar")
    if name in ("imagenet_lt", "places_lt", "inat18"):
        defaults = {
            "imagenet_lt": ("ImageNet_LT_train.txt", "ImageNet_LT_test.txt",
                            1000),
            "places_lt": ("Places_LT_train.txt", "Places_LT_test.txt", 365),
            "inat18": ("iNaturalist18_train.txt", "iNaturalist18_val.txt",
                       8142),
        }[name]
        train_txt = args.train_txt or os.path.join(args.data_path,
                                                   defaults[0])
        eval_txt = args.eval_txt or os.path.join(args.data_path, defaults[1])
        train_ds = LTDataset(args.data_path, train_txt, defaults[2])
        eval_ds = LTDatasetEval(args.data_path, eval_txt, train_ds.class_map,
                                defaults[2])
        return dict(train=train_ds, train_data=train_ds,
                    train_targets=train_ds.targets, eval_data=eval_ds,
                    eval_targets=eval_ds.targets, num_classes=defaults[2],
                    kind="imagenet")
    raise ValueError(f"unknown dataset {name!r}")


def record_result(result: float, args, path: str) -> None:
    """Append the run's args and its best Acc@1 to ``path``."""
    row = dict(vars(args))
    row["acc"] = result
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            w.writeheader()
        w.writerow({k: str(v) for k, v in row.items()})


def transforms(args, kind: str):
    """(train_augment(generator, images_u8), eval_transform(images_u8))
    of the dataset's kind, with ``--auto-augment`` and
    ``--random-erase``."""
    policy, erase = args.auto_augment, args.random_erase
    if kind == "cifar":
        mean, std = CIFAR10_MEAN, CIFAR10_STD

        def train_aug(gen, x):
            b, h, w, _ = x.shape
            return augment.cifar_train_augment(
                x, augment.draw_cifar(gen, b, x.device, policy, erase, h, w),
                mean, std)

        return train_aug, lambda x: augment.cifar_eval_transform(x, mean,
                                                                 std)
    if args.dset_name == "inat18":
        mean, std, hue = INAT18_MEAN, INAT18_STD, 0.25
    else:
        mean, std, hue = IMAGENET_MEAN, IMAGENET_STD, 0.0

    def train_aug(gen, x):
        b, h, w, _ = x.shape
        return augment.imagenet_train_augment(
            x, augment.draw_imagenet(gen, b, h, w, x.device, hue, policy,
                                     erase), mean, std)

    return train_aug, lambda x: augment.imagenet_eval_transform(x, mean, std)


def checkpoint_path(path: str) -> str:
    """A checkpoint file, or the newest ``epoch_{n}.pth`` of a
    directory."""
    if os.path.isdir(path):
        n = latest_step(path)
        if n is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        return os.path.join(path, f"epoch_{n}.pth")
    return path


def main(args, qat=None):
    """Train (or with ``--test-only`` evaluate) as ``args`` say; ``qat``
    (an ``iif_torch.quant.QatConfig``) trains with fake-quantized
    weights and evaluates ``--test-only`` on them."""
    refuse_unported(args)
    device = resolve_device(args.device)
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    print(args)

    d = build_data(args)
    num_classes = d["num_classes"]
    loader = Loader(d["train_data"], d["train_targets"], args.batch_size,
                    sampler=args.sampler, seed=args.seed,
                    prefetch=args.workers)
    criterion = get_criterion(
        args.classif, d["train"].get_cls_num_list(), iif_variant=args.iif,
        iif_norm=args.iif_norm, gamma=args.gamma, alpha=args.alpha,
        reduction=args.reduction, deferred=args.deffered)

    print("Creating model")
    dp = 1                                  # one process, one card
    bn_groups = args.bn_groups if args.bn_groups > 0 else (
        1 if args.sync_bn else dp)
    if args.sync_bn and args.bn_groups > 1:
        print(f"--bn-groups {args.bn_groups} overrides --sync-bn")
    if bn_groups > 1 and args.batch_size % bn_groups:
        raise SystemExit(
            f"batch_size {args.batch_size} not divisible by bn_groups "
            f"{bn_groups}; pass --bn-groups explicitly")
    if bn_groups > 1:
        print(f"BatchNorm: local stats over {bn_groups} batch groups "
              "(per-device-BN semantics); --sync-bn forces global")
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_classifier(args.model, num_classes, args.classif_norm,
                             bn_groups=bn_groups if bn_groups > 1 else 0,
                             compute_dtype=torch.bfloat16 if args.bf16
                             else None)
    classifier_fresh_init_(model, torch.Generator().manual_seed(args.seed))
    train_aug, eval_tf = transforms(args, d["kind"])
    schedule = build_lr_schedule(
        args.lr, len(loader), milestones=args.milestones,
        lr_gamma=args.lr_gamma, epochs=args.epochs,
        cosine=args.cosine_scheduler)
    trainer = ClassificationTrainer(
        model, criterion, schedule, train_aug, eval_tf, num_classes,
        mixup_alpha=args.mixup, compute_dtype=compute_dtype, seed=args.seed,
        opt=args.opt, momentum=args.momentum,
        weight_decay=args.weight_decay, device=device, qat=qat)
    if args.decoup:
        freeze_all_but_head(trainer.model)
        reinit_classifier_head(trainer.model, seed=args.seed)
    state = trainer.init_state()

    ckpt_dir = (os.path.join(args.output_dir, "checkpoints")
                if args.output_dir else None)
    start_epoch = args.start_epoch
    if args.resume and ckpt_dir is not None:
        start_epoch = restore(checkpoint_path(ckpt_dir), trainer.model,
                              state)
    if args.load_from:
        load_weights(checkpoint_path(args.load_from), trainer.model)

    def _eval():
        batches = eval_batches(d["eval_data"], d["eval_targets"],
                               args.batch_size)
        if qat is not None and qat.enabled:
            return trainer.evaluate_quantized(batches)
        return trainer.evaluate(batches)

    if args.test_only:
        res = _eval()
        many, med, low = shot_acc(res["preds"], res["labels"],
                                  d["train_targets"])
        print(f"Many {many:.3f}  Median {med:.3f}  Low {low:.3f}")
        return res["acc1"]

    print("Start training")
    log_writer = None
    if args.output_dir:
        log_writer = TrainLogWriter(args.output_dir)
        log_writer.write_env_header(
            exp_name=f"{args.model}_{args.classif}", seed=args.seed)
    start_time = time.time()
    best_acc = 0.0
    for epoch in range(start_epoch, args.epochs):
        state, _ = trainer.train_one_epoch(state, loader, epoch,
                                           print_freq=args.print_freq,
                                           log_writer=log_writer)
        res = trainer.evaluate(eval_batches(
            d["eval_data"], d["eval_targets"], args.batch_size))
        if log_writer is not None:
            log_writer.write({"mode": "val", "epoch": epoch + 1,
                              "acc1": res["acc1"], "acc5": res["acc5"]},
                             step=(epoch + 1) * len(loader))
        best_acc = max(best_acc, res["acc1"])
        if ckpt_dir is not None:
            save_checkpoint(args.output_dir, epoch + 1, trainer.model, state,
                            meta={"args": vars(args)})
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training time {total}")
    print("best acc is:", best_acc)
    if args.record_result and args.output_dir:
        record_result(best_acc, args,
                      os.path.join(args.output_dir, "results.csv"))
    return best_acc


if __name__ == "__main__":
    main(get_args_parser().parse_args())
