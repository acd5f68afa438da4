"""Overfit check of the port's training, end to end through its CLIs: the
JAX package's round-2 MaskRCNN harness (``scripts/overfit_cascade.py``,
``scripts/overfit_twostage.py``) at depth 50.

It writes the 8 seeded bright-squares PNGs (``synthetic_lvis.
write_synthetic_squares``, two categories, one square an image) and a
smoke-scale MaskRCNN R50-FPN config (``write_config``: 2 classes, no
frozen stage, IIF ``raw`` loss, 96x128 canvas, SGD lr 0.01 stepped down
at epoch N-5 after 5 warm-up steps, no gradient clipping, the evaluation
hook once after the last of N epochs), trains with
``iif_torch.cli.train_det`` and evaluates the checkpoint with
``iif_torch.cli.test_det`` (bbox and segm AP)::

    python -m iif_torch.tools.overfit ROOT [--epochs N] [--device cuda]

The config reads in the JAX package too, so its CLIs can train and test
the same config on the same PNGs for a reference number.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from iif_torch.tools.synthetic_lvis import write_synthetic_squares

EPOCHS = 40

CONFIG = '''\
model = dict(type="MaskRCNN", depth=50, num_classes=2, with_mask=True,
             frozen_stages=-1)
loss_cls = dict(type="DetIIFLoss", variant="raw", path=None)
train_cfg = dict(rpn_nms_pre=256, rpn_max_per_img=128,
                 rcnn_num_samples=64, num_mask_rois=16)
test_cfg = dict(rpn_nms_pre=256, rpn_max_per_img=128, score_thr=0.0,
                max_per_img=5)
data = dict(
    samples_per_gpu=4,
    train=dict(type="CocoDataset", ann_file="{ann_file}",
               img_prefix="{img_prefix}", oversample_thr=0.0),
    val=dict(type="CocoDataset", ann_file="{ann_file}",
             img_prefix="{img_prefix}"),
    test=dict(type="CocoDataset", ann_file="{ann_file}",
              img_prefix="{img_prefix}"),
)
pipeline = dict(canvas=(96, 128), scales=[(128, 96)], max_gt=4)
optimizer = dict(type="sgd", lr=0.01, momentum=0.9, weight_decay=1e-4)
lr_config = dict(milestones=[{step}], gamma=0.1, warmup_iters=5)
runner = dict(type="EpochBasedRunner", max_epochs={epochs})
checkpoint_config = dict(interval={epochs})
evaluation = dict(interval={epochs}, metric=["bbox", "segm"])
log_config = dict(interval=5, tensorboard=False)
seed = 0
'''


def write_config(root: str, data: Dict[str, str], epochs: int = EPOCHS
                 ) -> str:
    """The overfit config for the set ``data`` (``{"ann_file",
    "img_prefix"}``) under ``root``; its path."""
    path = os.path.join(root, "overfit_cfg.py")
    with open(path, "w") as f:
        f.write(CONFIG.format(epochs=epochs, step=epochs - 5,
                              **data))
    return path


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    """Writes the set and the config under ROOT, trains, tests; returns
    ``test_det``'s AP dicts."""
    from iif_torch.cli import test_det, train_det

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    data = write_synthetic_squares(args.root)
    cfg = write_config(args.root, data, args.epochs)
    work = os.path.join(args.root, "work")
    train_det.main([cfg, "--work-dir", work, "--device", args.device])
    return test_det.main([cfg, work, "--eval", "bbox", "segm",
                          "--device", args.device])


if __name__ == "__main__":
    main()
