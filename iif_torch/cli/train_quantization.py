"""QAT / PTQ training CLI: port of ``iif_tpu/cli/train_quantization.py``
(the torchvision QAT recipe: int8 fake-quant weights, the observers
frozen from epoch ``--qat-freeze-observer`` and BatchNorm's statistics
from epoch ``--qat-freeze-bn``; ``--post-training-quantize`` evaluates
the int8 quantization of ``--load_from``'s weights)::

    python -m iif_torch.cli.train_quantization --dset_name synthetic \\
        --model resnet18 --epochs 6 --qat-freeze-observer 4 \\
        --qat-freeze-bn 2 [--device cuda]
    python -m iif_torch.cli.train_quantization ... \\
        --post-training-quantize --load_from RUN/checkpoints

The flags of ``iif_torch.cli.train`` and these four; it runs on the card
unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse

from iif_torch.cli import train as train_cli
from iif_torch.quant import QatConfig


def get_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        parents=[train_cli.get_args_parser(add_help=False)],
        description="QAT training (PyTorch)")
    parser.add_argument("--qat-freeze-observer", default=4, type=int,
                        help="freeze weight-scale observers from this epoch")
    parser.add_argument("--qat-freeze-bn", default=2, type=int,
                        help="freeze BN statistics from this epoch")
    parser.add_argument("--post-training-quantize", action="store_true",
                        help="no QAT: evaluate int8 quantization of loaded "
                             "weights (--load_from)")
    parser.add_argument("--num-calibration-batches", default=32, type=int)
    return parser


def main(args):
    qat = QatConfig(enabled=True,
                    freeze_observer_epoch=args.qat_freeze_observer,
                    freeze_bn_epoch=args.qat_freeze_bn)
    if args.post_training_quantize:
        # the weights come from --load_from; the evaluation is the int8
        # model's (fake-quant equals int8 dequantization)
        args.test_only = True
    return train_cli.main(args, qat=qat)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
