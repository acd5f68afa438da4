#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, the torch and CUDA
   versions, the TF32 switches (both off for every timing), and the build
   of every kernel from ``iif_torch/csrc`` with each instantiation's
   registers and spill bytes (``ptxas -v``).
2. Kernel phase: the multi-level RoIAlign forward K1 against its plain
   PyTorch version at the LVIS serving shapes (levels 200x336 .. 25x42,
   B=2, C=256; 7x7 with R=2000 and 14x14 with R=600; f32 and bf16), with
   the error, the path the wrapper chose (``vec8`` or ``pair``), the
   wrapper call's time from CUDA events (``ms``, as every kernel's) and
   the kernel's device time from a CUDA graph of its launches
   (``kernel_ms``), the plain-version time and the HBM bound, and once
   more at 7x7 on levels that are views 2 elements into their storage
   (the two-channel path); then at the
   training shapes (B=4; 7x7 with R=2048 and 14x14 with R=512; heavily
   overlapping RoIs and the aspect 8/12/1/8/16 ones; f32 and bf16) K1
   again and its backward K2, through ``RoIAlignML.backward`` as autograd
   runs it, against the plain backward, likewise, its ``kernel_ms`` the C
   entry's launches alone (memset, kernel and, for bf16, the cast), and
   its float4 reductions estimated from the RoIs on a line of their own.
   Then the single-level RoIAlign forward K3 against its plain version
   (run in chunks of RoIs) at the C4 serving shapes (the C4 map (B, 50,
   84, 1024), B = 1 and 2, R = 1000 B RoIs shaped like the serving
   proposals with border, outside, sub-cell and wider-than-40-cell ones,
   14x14 at 1/16; f32 and bf16 maps), likewise (at B=1 also on a map 2
   elements into its storage), and on small cases of its other options
   (unaligned, sampling ratios 1 and 4, non-square bins). Then at the C4
   training shapes (B=4, R=2048 RoIs spread like the proposals plus
   border, outside, sub-cell, whole-map and zero-size ones and a pile on
   one cell, 14x14; f32 and bf16 maps): K3 again, and its backward K4,
   through ``RoIAlign.backward`` as autograd runs it, against the plain
   backward (in chunks of RoIs), likewise (``kernel_ms`` the memset and
   the kernel), and once more on its two-channel path (g a view 2
   elements into its storage, through the backward's launch function).
3. Serving phase: IIF MaskRCNN R50-FPN with 1203 LVIS classes, bf16 trunk,
   seeded random weights and IIF weights from seeded long-tailed counts,
   serving 40 seeded images through ``inference_detector`` (b1) and
   through ``inference_detector_batch`` in full batches of 2 (b2): ms per
   image (median and spread), and the kernel's launch counts on each of
   the two paths (and on a b1 request with masks), each counted from 0;
   one request's RoI features and class scores held against the plain
   RoIAlign.
4. Profile phase: one b1 request's unprofiled wall time, each stage's
   wall time with the device drained at its ends, and under
   ``torch.profiler`` each stage's kernel time and the device's busy share.
5. C4 serving phase: Faster R-CNN R50-C4 as its config stands (80
   classes, bf16 trunk, 1000 proposals, 100 detections), seeded random
   weights, the same 4 images at b1 and b2 as in 3., K3's launches (and
   K1's and K2's: none) counted from 0 on each path, one request's RoI
   features and class scores held against the plain RoIAlign, one
   forward at ``score_thr=0`` checked for range; then its profile as in
   4., by the C4 stages.
6. Training phase: the trainer of the MaskRCNN config (SGD lr 0.02, 500
   warm-up iterations, frozen stem and stage 1, ``norm_eval``,
   ``rpn_nms_pre=2000``, masks at stride 2) from ``trainer_from_config``,
   seeded fresh weights as JAX's ``model.init`` draws them
   (``fresh_init_``), on a seeded synthetic batch of 4 uint8 800x1344
   canvases with 100 gt slots (about 30% valid) and bit-packed masks at
   400x672: 3 warm-up steps and TRAIN_STEPS timed ones (ms/step and
   img/s, median and spread), every step's losses, K1's and K2's launches
   counted from 0 over those steps (every one on ``vec8``), NMS host
   syncs a step, the moved and the frozen parameters; then each stage's
   wall time with the device drained at its ends and
   its kernel time, and the device's busy share over the unprofiled step.
7. C4 training phase: the trainer of the C4 config as it stands (80
   classes, bf16 trunk, SGD lr 0.02 with 500 warm-up iterations, frozen
   stem and stage 1, ``norm_eval``, 2000 proposals, 512 RoIs an image,
   CE) on a seeded b4 batch like 6.'s without masks and with 80 classes:
   as in 6., with K3's and K4's launches (and K1's and K2's: none)
   counted from 0 (every K3 and K4 launch on ``vec8``), and its stages.
8. Training from files: ``python -m iif_torch.cli.train_det`` in the
   process on the headline config as it stands, its annotation and image
   paths overridden to a seeded synthetic LVIS v1-style set of 64 PNGs
   (32 landscape, 32 portrait COCO sizes, 1203 classes, image counts and
   frequencies from the set's own annotations; ``iif_torch/tools/
   synthetic_lvis.py``) and ``runner.max_epochs=1`` (the config's
   evaluation, every 12 epochs, is not reached): one epoch of 16 b4 steps
   through the loader
   over the six canvas buckets, K1's and K2's launches counted from 0
   (one a size a step, all on ``vec8``), at least 3 buckets, every loss
   finite, the frozen stage unchanged and trainable parameters moved,
   ``epoch_1.pth``; K1 and K2 against their plain versions on one step's
   own features and RoIs on a bucket below 800; a resume for 2 steps
   under torch.profiler; the checkpoint served back by ``init_detector``
   on one of the PNGs (read without cv2), its RoI features against the
   plain version; ms/step by bucket (each bucket's first step apart),
   img/s, the loader wait a step, the device's busy share, peak memory
   and a sample's host time by part.
9. Evaluation: ``python -m iif_torch.cli.test_det`` in the process on
   the headline config as it stands (1203 classes, bf16 trunk,
   ``score_thr=1e-4``, 300 detections, masks, b4) with the files phase's
   checkpoint (its work directory), on a seeded LVIS v1-style val set of
   32 PNGs with negative and not-exhaustive category ids
   (``data.test.*``), ``--eval bbox segm --out``: s/image (median and
   spread after the first batch, the first apart), each batch split into
   the loader, the device forward (drained), the masks' paste and
   read-back, the RLE encode and the results conversion, the evaluator's
   seconds, detections per image and both AP dicts (near 0 after 16
   steps: printed, not checked). Checks: K1's launches from 0 twice a
   batch, all on ``vec8``, K2-K4 none; the first batch's RoI features and
   class scores against the plain RoIAlign; the rescaled boxes equal
   NumPy's true division; the val set's gt as detections scores AP 1
   (bbox, segm, and each of APr/APc/APf with members); the AP dicts
   through the C++ matcher and IoU equal the plain Python ones;
   ``results.json`` reads back as the records.
10. Overfit: ``iif_torch/tools/overfit.py``'s config and 8 seeded
   bright-squares PNGs (MaskRCNN R50-FPN, 2 classes, 96x128, b4, 40
   epochs, the evaluation hook after the last), ``train_det`` then
   ``test_det`` in the process: bbox and segm AP at least 0.5, the hook's
   AP equal to ``test_det``'s, K1's and K2's launches from 0 (all on
   ``vec8``), ms/step. Then K1 on the first evaluation batch's features
   and RoIs, and K1 and K2 on the first overfit step's, against their
   plain versions (rows of their own in the ``kernels`` line).
11. Classification, CIFAR-100-LT: ``python -m iif_torch.cli.train`` in
   the process with the README's command (``--model resnet32 --classif
   iif --iif raw --imb_factor 0.01 --cosine_scheduler``) on ``--dset_name
   synthetic`` (10,847 training images after the imbalance, 10,000 to
   evaluate), the CLI's default batch of 32, bf16, 3 epochs, then
   ``--test-only --load_from`` its checkpoints: ms/step (CUDA events,
   median and spread), img/s over each epoch and each evaluation, Acc@1
   and Acc@5, Many / Median / Low, the busy share and kernel split of one
   profiled step, peak memory. Checks: every loss finite, Acc@1 at least
   half the JAX CLI's on the CPU with the same flags (``CLS_CIFAR_JAX_
   ACC1``), ``--test-only`` reproducing the last epoch's Acc@1 exactly,
   no K1-K4 launch.
12. Classification, ImageNet-LT shape: the north-star recipe's three
   calls (``scripts/repro_imagenet_lt.sh``) on 1,000 classes with counts
   from the exp profile 1280 -> 5 over a pool of 1,024 seeded 256x256 PNGs
   (ImageNet-LT train and test lists, read through the CLI's
   ``imagenet_lt`` branch), each epoch cut to 4 b256 steps: stage 1
   SE-ResNet-50 at 224, ``--bn-groups 4``, cosine head, mixup 0.2,
   ``--auto-augment imagenet`` (the sub-policy of each step logged),
   stage 2 ``--classif iif --iif smooth --decoup``, the post-hoc IIF
   ``--test-only`` and the same checkpoint's plain CE evaluation:
   ms/step and img/s of each stage, peak memory, one profiled stage-1
   step's busy share and top kernels. Checks: every loss finite, stage 2
   leaves the trunk equal bit for bit and moves the head and the BN
   running statistics, the post evaluation's predictions differ from
   the plain ones, no K1-K4 launch.
13. QAT (``BASELINE.json`` configs[3]'s shape): ``python -m iif_torch.
   cli.train_quantization --model resnet50 -b 256 --epochs 3
   --qat-freeze-bn 1 --qat-freeze-observer 2`` on 12.'s lists, each epoch
   cut to 4 steps, then ``--post-training-quantize --load_from`` its
   checkpoint (``qat_phase``).
14. Augmentation: every op of the policies at three levels, a sub-policy
   of each policy, RandAugment, each OneOf branch, cutout and random
   erasing on the card at b256 224x224 and b128 32x32, held against the
   same function on the CPU on the same draws; ms a batch of each policy
   (``augmentation_phase``).
15. Classifier families: one b64 bf16 step and 3 timed ones of each of
   resnet18/34, resnext50_32x4d, resnext101_32x8d, wide_resnet50_2,
   wide_resnet101_2 and se_resnext50_32x4d at full depth and width, 224
   (``family_phase``).
16. FASA cascade serving (``cascade_serving_phase``): the flagship
   ``configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py`` as it stands
   through ``init_detector`` with ``fresh_init_`` weights, 20 b1 requests
   and 10 b2 batches, K1's launches from 0 (three 7x7 and one 14x14 a
   forward, all ``vec8``), each image's stage RoI features and scores
   against the plain RoIAlign, K1 on each stage's RoIs (``k1_row``), and
   after the MaskRCNN profile its own, a span a stage.
17. FASA cascade training (``cascade_training_phase``): the same config
   with ``grad_clip`` 35 through ``trainer_from_config`` at b4, 3 + 5
   steps at epoch 0 and 5 at epoch 1, K1 and K2 from 0, the global
   norms, peak memory, a profiled step, K1 and K2 on a step's stage-3
   RoIs.
18. The dynamic runner (``fasa_cli_phase``): ``iif_torch.cli.train_det``
   on the flagship config over 8 + 8 seeded PNGs with ``data.val``, 2
   epochs of 2 steps, the val pass and dynamic sampling at 1203 classes
   (its seconds), ``prob_list`` moved, ``--resume-from`` restoring every
   FASA field, the checkpoint served back; then FASA MaskRCNN R50 steps
   (``fasa_r50_phase``).
19. HTC serving (``htc_serving_phase``, beside 16.; its profile beside
   the cascade's, spans from ``cascade.py`` and ``htc.py``): the paper's
   ``configs/activations/iif/iif_htc_r101_4x4_1x.py`` as it stands (HTC
   R101-FPN, bf16, 1203 classes, IIF) through ``init_detector`` with
   ``fresh_init_`` weights, 20 b1 requests and 10 b2 batches, K1 three
   7x7 and one 14x14 a forward, every served image's stage RoI features
   against the plain RoIAlign, K1 on each stage's RoIs and the
   detections, the masks of three chained trunks finite and in [0, 1].
   Then the X101 sigmoid baseline ``configs/activations/x101_4x4_1x.py``
   (ResNeXt-101 32x4d) likewise at b1 (``x101_serving_phase``), its
   ``backbone_fpn`` span beside HTC R101's.
20. HTC training (``htc_training_phase``): the same config through
   ``trainer_from_config`` at b4 on 6.'s batch, ``grad_clip`` 35, 3 + 5
   steps, K1 and K2 three a size a step, NMS host syncs, a profiled step
   by stage (``stage{i}_mask_trunk`` / ``_mask_loss``), K1 and K2 on each
   stage's own RoIs (the mask RoIs re-sampled from the refined boxes).
21. HTC through the CLIs (``htc_cli_phase``): ``cli.train_det`` on 8
   seeded PNGs (one epoch of 2 b4 steps, mmdet's HTC names in the
   checkpoint, a resume restoring it bit for bit), ``cli.test_det`` on
   that checkpoint (``results.json``, gt as detections AP 1), one HTTP
   request through ``cli.serve``'s ``make_server`` (a PNG body, decoded
   without cv2).
22. The activations baselines' training: the X101 sigmoid baseline at b4
   (3 + 5 steps, its ``backbone_fpn`` span beside HTC R101's, the sigmoid
   CE of a step's own logits on the card against the CPU,
   ``x101_training_phase``), and the sigmoid cascade R50
   ``configs/activations/cascade_r50_4x4_1x.py`` (1 + 3 steps,
   ``sigmoid_cascade_phase``).
23. The card's name and power limit, the ``kernels`` JSON line (each row
   also with its launches on the classification, QAT, augmentation,
   family, FASA, HTC and activations paths), then the device line as the
   last line.

Exits non-zero, with no result line, when CUDA is unavailable or the
``iif_torch`` package is not beside this file; any failed check raises.
"""
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BUILD = REPO / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
LVIS_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
CANVAS = (800, 1344)
NUM_CLASSES = 1203
LVIS_IMAGES = 100170               # N of the detection IIF weights
SOURCE = "iif_torch/csrc/roi_align_ml.cu"
K3_SOURCE = "iif_torch/csrc/roi_align.cu"
REPLACES = {"K1": "iif_tpu/ops/pallas/roi_align_kernel.py:725",
            "K2": "iif_tpu/ops/pallas/roi_align_kernel.py:769",
            "K3": "iif_tpu/ops/pallas/roi_align_kernel.py:103",
            "K4": "iif_tpu/ops/pallas/roi_align_kernel.py:262"}
KERNEL_OF = {v: k for k, v in REPLACES.items()}
C4_CONFIG = "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py"
C4_MAP = (50, 84)                  # stride 16 on the 800x1344 canvas
C4_CHANNELS = 1024
C4_ROIS = 1000                     # rpn_max_per_img of the C4 test_cfg
PLAIN_CHUNK = 100                  # RoIs a call of K3's plain version
GRAD_CHUNK = 128                   # RoIs a call of K4's plain version
C4_CLASSES = 80
C4_TRAIN_ROIS = 512 * 4            # rcnn_num_samples x samples_per_gpu
COCO_TRAIN_IMAGES = 118287         # train2017, for steps_per_epoch
F32_TOL = 1e-5
# K2 adds with atomics in an order that changes from run to run: f32
# within GRAD_REL_TOL of the largest magnitude; bf16 besides within 2^-8
# of each value (one rounding of an f32 sum that may differ in its last
# bits)
GRAD_REL_TOL = 1e-5
CLS_REL_TOL = 1e-2
REQUESTS = 40                      # timed images per serving path
TRAIN_BATCH = 4                    # samples_per_gpu of the LVIS config
TRAIN_GT = 100                     # gt slots an image (pipeline max_gt)
TRAIN_WARMUP = 3
TRAIN_STEPS = 10                   # timed training steps


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def check_vec8(what, by_path, launched):
    """Every one of a main path's ``launched`` launches of a kernel took
    the eight-channel instantiation (the wrappers count launches by
    ``kernel_path``)."""
    check(by_path == ({"vec8": launched} if launched else {}),
          f"{what}: {launched} launches, all on vec8, got {by_path}")


def ptxas_report(reports):
    """Registers and spill bytes of every kernel instantiation, from each
    source's ``ptxas -v`` report, names demangled by ``c++filt`` where the
    machine has it."""
    import re

    funcs = []
    for source, rep in reports.items():
        fn = None
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = {"source": source, "function": m.group(1)}
                funcs.append(fn)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn is not None:
                fn["spill_stores"] = int(m.group(1))
                fn["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                fn["registers"] = int(m.group(1))
    filt = shutil.which("c++filt")
    if filt and funcs:
        names = subprocess.run(
            [filt], input="\n".join(f["function"] for f in funcs),
            capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(funcs):
            for fn, name in zip(funcs, names):
                fn["function"] = name
    return funcs


def cuda_ms(fn, iters=10, reps=20):
    """Per-call time: CUDA events around ``iters`` back-to-back calls, the
    median over ``reps`` such runs, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters=10, reps=20):
    """Device time of one call of ``fn``, a kernel's launch with no other
    work: ``iters`` calls captured in a CUDA graph and replayed between
    CUDA events, the median over ``reps`` replays. Unlike ``cuda_ms`` of
    a wrapper call, the host's time to issue a call does not enter."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=1, reps=reps) / iters


def spread(ms):
    """Median and spread of host-clock times."""
    ms = sorted(ms)
    return {"n": len(ms), "median": statistics.median(ms), "min": ms[0],
            "p90": ms[int(0.9 * (len(ms) - 1))], "max": ms[-1]}


def bf16_ulp(x):
    import torch

    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def offset_view(t, offset):
    """``t`` copied into a contiguous view that starts ``offset`` elements
    into its storage: 2 elements in, the forward kernels take their
    two-channel path."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def make_rois(rng, r, device):
    """LVIS-scale RoIs: log-uniform size and aspect, aspect 8, 12, 1/8 and
    16 for the first four, clamped to the canvas border, batch index 0/1
    (the shapes of tests/test_pallas_roi_align.py)."""
    import numpy as np
    import torch

    centers = rng.rand(r, 2) * [1300, 780]
    scale_px = np.exp(rng.uniform(np.log(16), np.log(512), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    aspect[:4] = [8.0, 12.0, 1.0 / 8.0, 16.0]
    w_px = scale_px * np.sqrt(aspect)
    h_px = scale_px / np.sqrt(aspect)
    x1 = np.clip(centers[:, 0] - w_px / 2, 0, CANVAS[1] - 1)
    y1 = np.clip(centers[:, 1] - h_px / 2, 0, CANVAS[0] - 1)
    x2 = np.clip(centers[:, 0] + w_px / 2, 0, CANVAS[1] - 1)
    y2 = np.clip(centers[:, 1] + h_px / 2, 0, CANVAS[0] - 1)
    bidx = rng.randint(0, 2, r)
    bidx[:2] = 1
    return torch.tensor(np.stack([bidx, x1, y1, x2, y2], 1),
                        dtype=torch.float32, device=device)


def touched_rows(feats, rois, o, s=2):
    """Unique (image, level, y, x) feature rows that this run's bilinear
    corners touch."""
    import torch

    from iif_torch.ops.roi_align_ml import map_roi_levels

    dev = rois.device
    c, item = feats[0].shape[-1], feats[0].element_size()
    lvl = map_roi_levels(rois, 4).long()
    hs = torch.tensor([f.shape[1] for f in feats], device=dev)[lvl]
    ws = torch.tensor([f.shape[2] for f in feats], device=dev)[lvl]
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    offs = torch.tensor([sum(sizes[:i]) for i in range(4)], device=dev)[lvl]
    stride = torch.tensor([4.0, 8.0, 16.0, 32.0], device=dev)[lvl]
    pos = (torch.arange(o * s, dtype=torch.float32, device=dev) + 0.5) / s
    rows = []
    for lo, hi, n in ((1, 3, ws), (2, 4, hs)):
        a = rois[:, lo] / stride - 0.5
        z = rois[:, hi] / stride - 0.5
        p = (a[:, None] + (z - a)[:, None] / o * pos[None]).clamp(min=0)
        p = torch.minimum(p, (n - 1)[:, None].float())
        p0 = p.floor()
        rows.append(torch.stack([p0, torch.minimum(p0 + 1, (n - 1)[:, None]
                                                   .float())], 1).long())
    xs, ys = rows                                   # (R, 2, T)
    base = rois[:, 0].long() * sum(sizes) + offs
    idx = (base[:, None, None, None, None]
           + ys[:, :, :, None, None] * ws[:, None, None, None, None]
           + xs[:, None, None, :, :])
    return torch.unique(idx.reshape(-1)).numel()


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def roi_align_bound(feats, rois, o, s=2):
    """Least time for K1's call on the card: the larger of (unique feature
    rows that this run's samples touch + rois + output) over HBM
    bandwidth, and its f32 FLOPs over the non-tensor-core f32 peak."""
    c, item = feats[0].shape[-1], feats[0].element_size()
    touched = touched_rows(feats, rois, o, s)
    r = rois.shape[0]
    nbytes = touched * c * item + r * 5 * 4 + r * o * o * c * item
    return _bound(nbytes, r * o * o * c * s * s * 12) + (touched,)


def roi_align_grad_bound(feats, rois, o, s=2):
    """Least time for K2's call: g read once, the touched rows' f32
    accumulators read and written once, and the levels' gradient written
    once in the feature dtype, over HBM bandwidth; or its f32 FLOPs (as
    K1's) over the f32 peak."""
    c, item = feats[0].shape[-1], feats[0].element_size()
    touched = touched_rows(feats, rois, o, s)
    r = rois.shape[0]
    numel = sum(f.numel() for f in feats)
    nbytes = (r * o * o * c * item + r * 5 * 4 + touched * c * 4 * 2
              + numel * item)
    return _bound(nbytes, r * o * o * c * s * s * 12) + (touched,)


def distinct_cells(a, z, n, o, s=2, clamp_min=False, per_bin=False):
    """Per RoI (or, with ``per_bin``, per RoI and bin), the distinct map
    cells along one axis that its taps touch with a nonzero weight (the
    backward kernels' footprint slots): RoI start ``a`` and end ``z`` in
    cells, ``n`` cells in the map (both (R,) tensors)."""
    import torch

    extent = z - a
    if clamp_min:
        extent = extent.clamp(min=1.0)
    pos = (torch.arange(o * s, dtype=torch.float32, device=a.device)
           + 0.5) / s
    p = torch.minimum((a[:, None] + extent[:, None] / o * pos[None])
                      .clamp(min=0), (n - 1)[:, None].float())
    lo = p.floor()
    hi = torch.where(p > lo, lo + 1, lo)        # frac 0: no high corner
    cells = torch.stack([lo, hi], 2).reshape(
        a.shape[0], o if per_bin else 1, -1).sort(2).values
    count = 1 + (cells[..., 1:] != cells[..., :-1]).sum(2)
    return count if per_bin else count[:, 0]


def grad_reductions(rois, o, scale, heights, widths, c, offset=0.5,
                    clamp_min=False):
    """An estimate of the backward kernels' (K2, K4) float4 atomics on
    these RoIs: one per touched (row, column) of a RoI and 4 channels.
    The taps come from torch's arithmetic, not make_tap's, so a tap near a
    cell's edge may land in the next cell: not a count of the kernel's.
    ``scale``, ``heights`` and ``widths`` are (R,) tensors, each RoI's
    level's."""
    cols = distinct_cells(rois[:, 1] * scale - offset,
                          rois[:, 3] * scale - offset, widths, o,
                          clamp_min=clamp_min)
    rows = distinct_cells(rois[:, 2] * scale - offset,
                          rois[:, 4] * scale - offset, heights, o,
                          clamp_min=clamp_min)
    return int((rows * cols).sum().item()) * (c // 4)


def k1_row(torch, feats32, rois, o, dt, offset=0):
    """K1 against its plain version on one set of inputs, in ``dt``: the
    error, K1's path, the wrapper call's time (``ms``, with the level
    mapping and the host's time to issue it) and its kernel's device time
    (``kernel_ms``, ``graph_ms`` of its launch), the plain version's
    time and the bound. With an ``offset``, each level is a view that many
    elements into its storage."""
    from iif_torch.ops.roi_align import kernel_path
    from iif_torch.ops.roi_align_ml import (
        _launch_fwd,
        _roi_meta,
        roi_align_ml,
        roi_align_ml_reference,
    )

    feats = [f.to(dt) for f in feats32]
    if offset:
        feats = [offset_view(f, offset) for f in feats]
    got = roi_align_ml(feats, rois, (o, o))
    torch.cuda.synchronize()
    path = kernel_path(*feats, got)
    want = roi_align_ml_reference(feats, rois, (o, o))
    err = (got.float() - want.to(dt).float()).abs().max().item()
    if dt == torch.float32:
        ok = err <= F32_TOL
        tol = F32_TOL
        ulps = None
    else:
        cast = want.to(dt).float()
        ulps = ((got.float() - cast).abs() / bf16_ulp(cast)).max().item()
        ok = ulps <= 1.0
        tol = "1 bf16 ulp of the value"
    lvl, bidx = _roi_meta(rois, 4, 56.0)
    kernel_ms = graph_ms(lambda: _launch_fwd(feats, rois, lvl, bidx, o, 2,
                                             (4, 8, 16, 32)))
    ms = cuda_ms(lambda: roi_align_ml(feats, rois, (o, o)))
    plain_ms = cuda_ms(lambda: roi_align_ml_reference(
        feats, rois, (o, o)).to(dt))
    bound_ms, bound_by, touched = roi_align_bound(feats, rois, o)
    row = {"o": o, "R": rois.shape[0], "B": feats[0].shape[0],
           "dtype": str(dt).split(".")[-1], "path": path,
           "storage_offset": offset,
           "max_abs_err": err, "max_err_ulps": ulps,
           "tolerance": tol, "ok": ok, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "kernel_bound_share": bound_ms / kernel_ms,
           "touched_feature_rows": touched}
    log("kernel K1", json.dumps(row))
    if not ok:
        raise RuntimeError(f"roi_align_ml disagrees: {row}")
    return row


def kernel_phase(torch, np):
    """K1 against its plain version at the serving shapes (B=2), then its
    two-channel path there: the bf16 levels as views 2 elements into their
    storage, at 7x7."""
    rng = np.random.RandomState(0)
    feats32 = [torch.tensor(rng.randn(2, h, w, 256), dtype=torch.float32,
                            device="cuda") for h, w in LVIS_LEVELS]
    results = {}
    for o, r in ((7, 2000), (14, 600)):
        rois = make_rois(rng, r, "cuda")
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, feats32, rois, o, dt)
            check(row["path"] == "vec8", "K1 takes vec8 at the LVIS shapes")
            results[(o, row["dtype"])] = row
        if o == 7:
            row = k1_row(torch, feats32, rois, o, torch.bfloat16, offset=2)
            check(row["path"] == "pair", "K1 takes pair on an offset view")
            results["pair"] = row
    return results


def make_train_rois(rng, r, device):
    """K1's RoIs (aspect 8, 12, 1/8 and 16 among them) over 4 images, half
    of them piled on 8 spots (centres within 8 px, 64-256 px wide), so
    that many RoIs add into the same cells."""
    import numpy as np
    import torch

    rois = make_rois(rng, r, "cpu").numpy()
    rois[:, 0] = rng.randint(0, TRAIN_BATCH, r)
    spots = rng.rand(8, 2) * [1000, 500] + [150, 150]
    pile = np.arange(4, r, 2)
    c = spots[rng.randint(0, 8, pile.size)] + rng.uniform(-8, 8,
                                                          (pile.size, 2))
    half = rng.uniform(32, 128, (pile.size, 2))
    rois[pile, 1:3] = c - half
    rois[pile, 3:5] = c + half
    return torch.tensor(rois, dtype=torch.float32, device=device)


def k2_row(torch, feats32, rois, g32, o, dt):
    """K2, through ``RoIAlignML.backward`` as autograd runs it in a
    training step, against the plain backward on one set of inputs, in
    ``dt``: the error against GRAD_REL_TOL, K2's path, the autograd call's
    time (``ms``) and its C entry's alone (``kernel_ms``: memset, kernel
    and, for bf16, the cast), the plain backward's time and the bound;
    its float4 reductions estimated from the RoIs on a line of their
    own."""
    from iif_torch.ops.roi_align_ml import (
        _bwd_buffers,
        _bwd_call,
        _roi_meta,
        roi_align_ml,
        roi_align_ml_grad_reference,
    )

    r = rois.shape[0]
    levels = [tuple(f.shape[1:3]) for f in feats32]
    feats = [f.to(dt).requires_grad_() for f in feats32]
    g = g32.to(dt)
    out = roi_align_ml(feats, rois, (o, o))

    def k2_call():
        return torch.autograd.grad(out, feats, g, retain_graph=True)

    got = k2_call()
    torch.cuda.synchronize()
    want = roi_align_ml_grad_reference(feats32, rois, g.float(), (o, o))
    scale = max(w.abs().max().item() for w in want)
    err, excess = 0.0, 0.0
    for a, w in zip(got, want):
        d = (a.float() - w).abs()
        bound = GRAD_REL_TOL * scale
        if dt == torch.bfloat16:
            bound = bound + 2.0 ** -8 * w.abs()
        err = max(err, d.max().item())
        excess = max(excess, (d - bound).max().item())
    ms = cuda_ms(k2_call)
    # the C entry alone (memset, kernel and, for bf16, the cast)
    shapes = [tuple(f.shape) for f in feats]
    lvl, bidx = _roi_meta(rois, 4, 56.0)
    acc, res, gk, path = _bwd_buffers(shapes, dt, g)
    kernel_ms = graph_ms(lambda: _bwd_call(
        acc, res, gk, path, shapes, rois, lvl, bidx, o, 2, (4, 8, 16, 32)))
    del acc, res, gk
    plain_ms = cuda_ms(lambda: roi_align_ml_grad_reference(
        feats, rois, g, (o, o)), iters=1, reps=5)
    bound_ms, bound_by, touched = roi_align_grad_bound(feats, rois, o)
    lv = lvl.long()
    dims = torch.tensor(levels, device="cuda")[lv]
    row = {"o": o, "R": r, "B": feats32[0].shape[0], "levels": levels,
           "dtype": str(dt).split(".")[-1], "path": path,
           "max_abs_err": err, "max_grad": scale,
           "tolerance": (f"{GRAD_REL_TOL} x max |grad|"
                         + (" + 2^-8 x |value|"
                            if dt == torch.bfloat16 else "")),
           "ok": excess <= 0.0, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / ms,
           "kernel_bound_share": bound_ms / kernel_ms,
           "touched_feature_rows": touched}
    check(path == "vec8", "K2 takes vec8 at the training shapes")
    log("kernel K2", json.dumps(row))
    log("K2 atomics estimated from the RoIs", json.dumps({
        "o": o, "dtype": row["dtype"], "levels": levels,
        "float4_reductions": grad_reductions(
            rois, o, 1.0 / 2.0 ** (lv + 2).float(), dims[:, 0],
            dims[:, 1], 256),
        "scalar_atomics_before": r * o * o * 16 * 256}))
    if not row["ok"]:
        raise RuntimeError(f"K2 disagrees with its plain version: {row}")
    return row


def kernel_train_phase(torch, np):
    """At the training shapes (B=4): K1 against its plain version, and K2,
    through ``RoIAlignML.backward`` as autograd runs it in a training
    step, against the plain backward."""
    rng = np.random.RandomState(3)
    feats32 = [torch.tensor(rng.randn(TRAIN_BATCH, h, w, 256),
                            dtype=torch.float32, device="cuda")
               for h, w in LVIS_LEVELS]
    k1, k2 = {}, {}
    for o, r in ((7, 512 * TRAIN_BATCH), (14, 128 * TRAIN_BATCH)):
        rois = make_train_rois(rng, r, "cuda")
        g32 = torch.tensor(rng.randn(r, o, o, 256), dtype=torch.float32,
                           device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, feats32, rois, o, dt)
            k1[(o, row["dtype"])] = row
            row = k2_row(torch, feats32, rois, g32, o, dt)
            k2[(o, row["dtype"])] = row
    return k1, k2


def make_c4_rois(rng, r, batch, device):
    """RoIs shaped like the C4 serving proposals: log-uniform size (8 px
    to the canvas) and aspect (1/4 to 4), clipped to the canvas as the RPN
    clips its boxes, batch index over ``batch``; first the whole canvas,
    RoIs on and past each border, two wholly outside, two under one cell
    a side, and RoIs wider and taller than a TPU window's 40 x 32 cells
    (whose taps that window would have clamped)."""
    import numpy as np
    import torch

    h, w = CANVAS
    c = rng.rand(r, 2) * [w, h]
    size = np.exp(rng.uniform(np.log(8), np.log(w), r))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), r))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    boxes = np.stack([c[:, 0] - bw / 2, c[:, 1] - bh / 2,
                      c[:, 0] + bw / 2, c[:, 1] + bh / 2], 1)
    boxes = np.clip(boxes, 0, [w, h, w, h])
    special = [[0, 0, w, h], [-48, -32, 32, 48],
               [w - 40, h - 30, w + 60, h + 50],
               [w + 16, h + 16, w + 90, h + 70], [-100, -80, -20, -10],
               [81.6, 35.2, 86.4, 36.8], [8.0, 8.0, 14.4, 9.6],
               [100, 50, w - 44, h - 40], [300, 100, 900, 660]]
    boxes[:len(special)] = special
    bidx = rng.randint(0, batch, r)
    return torch.tensor(np.concatenate([bidx[:, None], boxes], 1),
                        dtype=torch.float32, device=device)


def touched_rows_single(feat, rois, oh, ow, s, scale, aligned):
    """Unique (image, y, x) feature rows that one single-level call's
    bilinear corners touch."""
    import torch

    b, h, w, _ = feat.shape
    dev = rois.device
    off = 0.5 if aligned else 0.0
    rows = []
    for lo, hi, n, o in ((1, 3, w, ow), (2, 4, h, oh)):
        a = rois[:, lo] * scale - off
        extent = rois[:, hi] * scale - off - a
        if not aligned:
            extent = extent.clamp(min=1.0)
        pos = (torch.arange(o * s, dtype=torch.float32, device=dev) + 0.5) / s
        p = (a[:, None] + extent[:, None] / o * pos[None]).clamp(0, n - 1)
        p0 = p.floor()
        rows.append(torch.stack([p0, (p0 + 1).clamp(max=n - 1)], 1).long())
    xs, ys = rows                                   # (R, 2, T)
    base = rois[:, 0].long().clamp(0, b - 1) * h * w
    idx = (base[:, None, None, None, None] + ys[:, :, :, None, None] * w
           + xs[:, None, None, :, :])
    return torch.unique(idx.reshape(-1)).numel()


def roi_align_single_bound(feat, rois, oh, ow, s, scale, aligned):
    """Least time for K3's call: the touched feature rows read once, the
    RoIs read once and the f32 output written once, over HBM bandwidth;
    or its f32 FLOPs over the f32 peak."""
    c, item = feat.shape[-1], feat.element_size()
    touched = touched_rows_single(feat, rois, oh, ow, s, scale, aligned)
    r = rois.shape[0]
    nbytes = touched * c * item + r * 5 * 4 + r * oh * ow * c * 4
    return _bound(nbytes, r * oh * ow * c * s * s * 12) + (touched,)


def plain_single_chunked(feat, rois, out, scale, sr=0, aligned=True):
    """K3's plain version over all RoIs, PLAIN_CHUNK at a time: at once,
    its four (R, 28, 28, C) f32 corner gathers would take 3.2 GB each at
    R=1000, C=1024."""
    import torch

    from iif_torch.ops.roi_align import roi_align_reference

    return torch.cat([
        roi_align_reference(feat, rois[i:i + PLAIN_CHUNK], out, scale, sr,
                            aligned)
        for i in range(0, rois.shape[0], PLAIN_CHUNK)])


def k3_row(torch, feat, rois, b):
    """K3 against its plain version at the C4 serving shapes on one map:
    the error, K3's path, the wrapper call's time (``ms``) and its
    kernel's device time (``kernel_ms``, ``graph_ms`` of its launch), the
    plain version's (chunked) and the bound."""
    from iif_torch.ops.roi_align import _launch, kernel_path, roi_align

    def k3():
        return roi_align(feat, rois, (14, 14), 1 / 16)

    got = k3()
    torch.cuda.synchronize()
    check(got.dtype == torch.float32, "K3 writes f32")
    path = kernel_path(feat, got)
    want = plain_single_chunked(feat, rois, (14, 14), 1 / 16)
    err = (got - want).abs().max().item()
    del got, want
    kernel_ms = graph_ms(lambda: _launch(feat, rois, 14, 14, 2, 1 / 16,
                                         True))
    ms = cuda_ms(k3)
    plain_ms = cuda_ms(lambda: plain_single_chunked(
        feat, rois, (14, 14), 1 / 16), iters=1, reps=3)
    bound_ms, bound_by, touched = roi_align_single_bound(
        feat, rois, 14, 14, 2, 1 / 16, True)
    row = {"o": 14, "R": rois.shape[0], "B": b,
           "dtype": str(feat.dtype).split(".")[-1], "path": path,
           "storage_offset": feat.storage_offset(), "max_abs_err": err,
           "tolerance": F32_TOL, "ok": err <= F32_TOL, "ms": ms,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "plain_note": f"the plain version in chunks of "
                         f"{PLAIN_CHUNK} RoIs over all R",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / ms,
           "kernel_bound_share": bound_ms / kernel_ms,
           "touched_feature_rows": touched}
    log("kernel K3", json.dumps(row))
    if not row["ok"]:
        raise RuntimeError(f"K3 disagrees with its plain version: {row}")
    return row


def kernel_k3_phase(torch, np):
    """K3 against its plain version at the C4 serving shapes (the C4 map
    (B, 50, 84, 1024), R = 1000 B, 14x14 at 1/16, s=0, aligned; B = 1, 2;
    f32 and bf16 maps), with the error, K3's time, the plain version's
    (chunked) and the bound; at B=1 its two-channel path too (the bf16
    map as a view 2 elements into its storage); then small cases of its
    other options."""
    from iif_torch.ops.roi_align import roi_align

    rng = np.random.RandomState(4)
    rows = {}
    for b in (1, 2):
        f32 = torch.tensor(rng.randn(b, *C4_MAP, C4_CHANNELS),
                           dtype=torch.float32, device="cuda")
        rois = make_c4_rois(rng, C4_ROIS * b, b, "cuda")
        for dt in (torch.float32, torch.bfloat16):
            row = k3_row(torch, f32.to(dt), rois, b)
            check(row["path"] == "vec8", "K3 takes vec8 at the C4 shapes")
            rows[(b, row["dtype"])] = row
        if b == 1:
            row = k3_row(torch, offset_view(f32.to(torch.bfloat16), 2),
                         rois, b)
            check(row["path"] == "pair", "K3 takes pair on an offset view")
            rows["pair"] = row
    # the other options on the C4 map at C=256: unaligned with sub-cell
    # RoIs (the min-size clamp), sampling ratios 1 and 4, non-square bins
    extra = {}
    f32 = torch.tensor(rng.randn(2, *C4_MAP, 256), dtype=torch.float32,
                       device="cuda")
    rois = make_c4_rois(rng, 300, 2, "cuda")
    for out, sr, aligned in (((14, 14), 0, False), ((7, 7), 1, True),
                             ((7, 7), 4, True), ((5, 9), 2, False)):
        for dt in (torch.float32, torch.bfloat16):
            feat = f32.to(dt)
            got = roi_align(feat, rois, out, 1 / 16, sr, aligned)
            torch.cuda.synchronize()
            want = plain_single_chunked(feat, rois, out, 1 / 16, sr, aligned)
            err = (got - want).abs().max().item()
            key = (f"{out[0]}x{out[1]} s={sr} aligned={aligned} "
                   f"{str(dt).split('.')[-1]}")
            extra[key] = err
            if err > F32_TOL:
                raise RuntimeError(f"K3 disagrees at {key}: {err}")
    log("kernel K3 options", json.dumps(extra))
    return rows, extra


def make_c4_train_rois(rng, device):
    """C4_TRAIN_ROIS RoIs over TRAIN_BATCH images: ``make_c4_rois``'s
    (the proposals' spread, the whole canvas, border, outside and sub-cell
    ones), a zero-size one, and 128 small RoIs piled onto one 16 px cell
    of image 0, so that many samples add into the same corners."""
    import torch

    rois = make_c4_rois(rng, C4_TRAIN_ROIS, TRAIN_BATCH, "cpu")
    rois[9] = torch.tensor([1.0, 300.0, 200.0, 300.0, 200.0])
    n = 128
    x0 = 512 + rng.uniform(0, 8, n)
    y0 = 352 + rng.uniform(0, 8, n)
    size = rng.uniform(2, 8, (n, 2))
    rois[10:10 + n] = torch.tensor(
        [[0.0, a, b, a + w, b + h] for a, b, (w, h) in zip(x0, y0, size)])
    return rois.to(device)


def roi_align_single_grad_bound(feat, rois, o, s=2):
    """Least time for K4's call at the C4 scale (1/16): g (f32) read once,
    the RoIs read once, the touched rows' f32 accumulators read and
    written once, and the map's gradient written once in its dtype, over
    HBM bandwidth; or its f32 FLOPs (as K3's) over the f32 peak."""
    c, item = feat.shape[-1], feat.element_size()
    touched = touched_rows_single(feat, rois, o, o, s, 1 / 16, True)
    r = rois.shape[0]
    nbytes = (r * o * o * c * 4 + r * 5 * 4 + touched * c * 4 * 2
              + feat.numel() * item)
    return _bound(nbytes, r * o * o * c * s * s * 12) + (touched,)


def plain_single_grad_chunked(feat, rois, g):
    """K4's plain version over all RoIs, GRAD_CHUNK at a time, summed in
    f32 and cast once to the map's dtype: at once, its four corner
    gathers would take 6.6 GB each at R=2048, C=1024."""
    import torch

    from iif_torch.ops.roi_align import roi_align_grad_reference

    f32 = feat.detach().float()
    total = torch.zeros_like(f32)
    for i in range(0, rois.shape[0], GRAD_CHUNK):
        total += roi_align_grad_reference(
            f32, rois[i:i + GRAD_CHUNK], g[i:i + GRAD_CHUNK], (14, 14),
            1 / 16)
    return total.to(feat.dtype)


def kernel_k4_phase(torch, np):
    """At the C4 training shapes (the C4 map (4, 50, 84, 1024), R=2048,
    14x14 at 1/16, s=0, aligned; f32 and bf16 maps): K3 against its plain
    version, and K4, through ``RoIAlign.backward`` as autograd runs it in
    a training step, against the plain backward, each with its error,
    time, the plain version's time and the bound."""
    from iif_torch.ops import roi_align as k34_mod
    from iif_torch.ops.roi_align import (
        _bwd_buffers,
        _bwd_call,
        _launch,
        _launch_bwd,
        kernel_path,
        roi_align,
    )

    rng = np.random.RandomState(5)
    f32 = torch.tensor(rng.randn(TRAIN_BATCH, *C4_MAP, C4_CHANNELS),
                       dtype=torch.float32, device="cuda")
    rois = make_c4_train_rois(rng, "cuda")
    g = torch.tensor(rng.randn(C4_TRAIN_ROIS, 14, 14, C4_CHANNELS),
                     dtype=torch.float32, device="cuda")
    # the gradient does not depend on the map's values: the f32 plain
    # backward is the yardstick for both dtypes
    want = plain_single_grad_chunked(f32, rois, g)
    scale = want.abs().max().item()
    k3, k4 = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        feat = f32.to(dt).detach().requires_grad_()

        def k3_call():
            with torch.no_grad():
                return roi_align(feat, rois, (14, 14), 1 / 16)

        got = k3_call()
        torch.cuda.synchronize()
        path = kernel_path(feat, got)
        err = (got - plain_single_chunked(feat.detach(), rois, (14, 14),
                                          1 / 16)).abs().max().item()
        del got
        bound_ms, bound_by, touched = roi_align_single_bound(
            feat, rois, 14, 14, 2, 1 / 16, True)
        kernel_ms = graph_ms(lambda: _launch(feat.detach(), rois, 14, 14,
                                             2, 1 / 16, True))
        ms = cuda_ms(k3_call)
        row = {"o": 14, "R": C4_TRAIN_ROIS, "B": TRAIN_BATCH, "dtype": name,
               "path": path, "max_abs_err": err, "tolerance": F32_TOL,
               "ok": err <= F32_TOL, "ms": ms, "kernel_ms": kernel_ms,
               "plain_ms": cuda_ms(lambda: plain_single_chunked(
                   feat.detach(), rois, (14, 14), 1 / 16), iters=1, reps=3),
               "plain_note": f"the plain version in chunks of "
                             f"{PLAIN_CHUNK} RoIs over all R",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms,
               "kernel_bound_share": bound_ms / kernel_ms,
               "touched_feature_rows": touched}
        log("kernel K3 train", json.dumps(row))
        if not row["ok"]:
            raise RuntimeError(f"K3 disagrees at the training shapes: {row}")
        k3[name] = row

        out = roi_align(feat, rois, (14, 14), 1 / 16)

        def k4_call():
            return torch.autograd.grad(out, feat, g, retain_graph=True)[0]

        got = k4_call()
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == feat.shape,
              "K4 gives the map's dtype and shape")
        d = (got.float() - want).abs()
        bound = GRAD_REL_TOL * scale
        if dt == torch.bfloat16:
            bound = bound + 2.0 ** -8 * want.abs()
        err = d.max().item()
        excess = (d - bound).max().item()
        del got, d
        bound_ms, bound_by, touched = roi_align_single_grad_bound(
            feat, rois, 14)
        ms = cuda_ms(k4_call)
        kernel_ms, path = k4_kernel_ms(_bwd_buffers, _bwd_call, feat, rois,
                                       g)
        check(path == "vec8", "K4 takes vec8 at the C4 training shapes")
        row = {"o": 14, "R": C4_TRAIN_ROIS, "B": TRAIN_BATCH, "dtype": name,
               "path": path, "max_abs_err": err, "max_grad": scale,
               "tolerance": (f"{GRAD_REL_TOL} x max |grad|"
                             + (" + 2^-8 x |value|"
                                if dt == torch.bfloat16 else "")),
               "ok": excess <= 0.0, "ms": ms, "kernel_ms": kernel_ms,
               "plain_ms": cuda_ms(lambda: plain_single_grad_chunked(
                   feat, rois, g), iters=1, reps=3),
               "plain_note": f"the plain backward in chunks of "
                             f"{GRAD_CHUNK} RoIs, summed in f32",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms,
               "kernel_bound_share": bound_ms / kernel_ms,
               "touched_feature_rows": touched}
        log("kernel K4", json.dumps(row))
        est = c4_grad_reductions(feat, rois)
        log("K4 atomics estimated from the RoIs", json.dumps({
            "dtype": name, "float4_reductions": est[0],
            "float2_reductions_before": est[1]}))
        if not row["ok"]:
            raise RuntimeError(f"K4 disagrees with its plain version: "
                               f"{row}")
        k4[name] = row
        del out
    # the two-channel path: g a view 2 elements into its storage, through
    # the backward's launch function (autograd may copy a gradient)
    feat = f32.to(torch.bfloat16)
    g_view = offset_view(g, 2)
    k34_mod.reset_launches()
    got = _launch_bwd(tuple(feat.shape), feat.dtype, rois, g_view, 14, 14, 2,
                      1 / 16, True)
    torch.cuda.synchronize()
    check(k34_mod.grad_launches_by_path == {"pair": 1},
          f"K4 takes pair on an offset g view: "
          f"{k34_mod.grad_launches_by_path}")
    d = (got.float() - want).abs()
    err = d.max().item()
    excess = (d - (GRAD_REL_TOL * scale + 2.0 ** -8 * want.abs())).max().item()
    del got, d
    kernel_ms, path = k4_kernel_ms(_bwd_buffers, _bwd_call, feat, rois,
                                   g_view)
    ms = cuda_ms(lambda: _launch_bwd(tuple(feat.shape), feat.dtype, rois,
                                     g_view, 14, 14, 2, 1 / 16, True))
    bound_ms = k4["bfloat16"]["bound_ms"]
    row = {"path": path, "storage_offset": g_view.storage_offset(),
           "max_abs_err": err, "ok": excess <= 0.0, "ms": ms,
           "ms_note": "the backward's launch function, not through autograd",
           "kernel_ms": kernel_ms, "bound_share": bound_ms / ms,
           "kernel_bound_share": bound_ms / kernel_ms}
    log("kernel K4 pair", json.dumps(row))
    check(path == "pair" and row["ok"], f"K4 pair path: {row}")
    k4["pair"] = row
    return k3, k4


def k4_kernel_ms(bwd_buffers, bwd_call, feat, rois, g):
    """K4's C entry alone on its buffers (the memset and the kernel; the
    cast to the map's dtype is the wrapper's): ``graph_ms`` and the path
    the buffers take."""
    acc, gk, path = bwd_buffers(tuple(feat.shape), g)
    ms = graph_ms(lambda: bwd_call(acc, gk, path, rois, 14, 14, 2, 1 / 16,
                                   True))
    return ms, path


def c4_grad_reductions(feat, rois):
    """Estimates (``grad_reductions``) of K4's float4 atomics at the C4
    scale (14x14 at 1/16, aligned), and of the float2 ones of K4's
    earlier design on the same RoIs (one block a (RoI, bin row), one
    float2 per touched (row, column) of a bin row and 2 channels)."""
    import torch

    n, dev = rois.shape[0], rois.device
    h = torch.full((n,), feat.shape[1], device=dev)
    w = torch.full((n,), feat.shape[2], device=dev)
    scale = torch.full((n,), 1 / 16, device=dev)
    c = feat.shape[-1]
    cols = distinct_cells(rois[:, 1] * scale - 0.5,
                          rois[:, 3] * scale - 0.5, w, 14)
    rows_per_bin = distinct_cells(rois[:, 2] * scale - 0.5,
                                  rois[:, 4] * scale - 0.5, h, 14,
                                  per_bin=True)
    before = int((rows_per_bin.sum(1) * cols).sum().item()) * (c // 2)
    return grad_reductions(rois, 14, scale, h, w, c), before


def write_lvis_annotations(np, path):
    """An LVIS-style annotation file with 1203 categories whose image
    counts are seeded long-tailed (1 to 10^4) over N = 100170 images, so
    ``init_detector`` builds the IIF loss as it does from LVIS v1."""
    rng = np.random.RandomState(0)
    counts = np.round(np.exp(rng.uniform(0, np.log(1e4), NUM_CLASSES)))
    data = {"categories": [{"id": i + 1, "name": f"class_{i}",
                            "image_count": int(c), "frequency": "r"}
                           for i, c in enumerate(counts)],
            "images": [{"id": i, "width": 640, "height": 480}
                       for i in range(LVIS_IMAGES)],
            "annotations": []}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))
    return counts


def serving_images(np):
    """The 4 seeded uint8 images both serving phases cycle over."""
    rng = np.random.RandomState(1)
    sizes = [(480, 640), (427, 640), (640, 512), (800, 1333)]
    return sizes, [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for hw in sizes]


def request_vs_plain(torch, det, image):
    """One MaskRCNN request of ``det`` on ``image`` (an array or a path):
    ``features_vs_plain`` of its 7x7 and 14x14 extractor calls."""
    from iif_torch.detection.inference import inference_detector

    seen = []
    with patched(capture_extractor(seen)):
        inference_detector(det, image, masks=False)
    return features_vs_plain(torch, seen, [7, 14],
                             lambda i: det.model.roi_head.bbox_head)


def capture_extractor(seen):
    """A ``patched`` change of ``SingleRoIExtractor.__call__`` that adds
    (output size, level maps, RoIs, output) of each call to ``seen``."""
    from iif_torch.detection.roi_extractor import SingleRoIExtractor

    extract = SingleRoIExtractor.__call__

    def record(self, feats, rois):
        out = extract(self, feats, rois)
        seen.append((self.output_size[0], [f.detach() for f in feats[:4]],
                     rois.detach().clone(), out.detach()))
        return out

    return SingleRoIExtractor, "__call__", record


def features_vs_plain(torch, seen, sizes, head_of):
    """The (output size, FPN maps, RoIs, K1's output) of one forward's
    extractor calls, of output ``sizes`` in order, against the plain
    RoIAlign on the same inputs (within one bf16 ulp), and the class
    scores of each 7x7 call's features from the two, through the bbox head
    ``head_of(i)`` of call ``i`` (within CLS_REL_TOL). A size called more
    than once (the cascade's stages) names its calls ``_stage{i}``. Each
    call's mean RoI side in pixels is kept too."""
    from iif_torch.ops.roi_align_ml import roi_align_ml_reference

    got = [o for o, *_ in seen]
    check(got == list(sizes), f"extractor calls of sizes {sizes}: {got}")
    compare = {"cls_score_tolerance": CLS_REL_TOL}
    with torch.inference_mode():
        for i, (o, nhwc, rois, k_feat) in enumerate(seen):
            tag = "" if sizes.count(o) == 1 else f"_stage{i}"
            p_feat = roi_align_ml_reference(nhwc, rois, (o, o)).to(
                k_feat.dtype)
            ulps = ((k_feat.float() - p_feat.float()).abs()
                    / bf16_ulp(p_feat.float())).max().item()
            compare[f"roi_feats_{o}{tag}_max_err_ulps"] = ulps
            compare[f"mean_roi_side_px_{o}{tag}"] = (
                (rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2])
            ).clamp(min=0).sqrt().mean().item()
            check(ulps <= 1.0, f"{o}x{o}{tag} RoI features differ: {ulps}")
            if o == 7:
                head = head_of(i)
                k_cls, p_cls = head(k_feat)[0], head(p_feat)[0]
                rel = ((k_cls - p_cls).abs().max()
                       / p_cls.abs().max()).item()
                compare[f"cls_score{tag}_max_rel_err"] = rel
                check(rel <= CLS_REL_TOL, f"cls_score{tag} differs: {rel}")
    return compare


def serving_phase(torch, np):
    from iif_torch.config import Config
    from iif_torch.detection.detector import maskrcnn_simple_test
    from iif_torch.detection.inference import (
        inference_detector,
        inference_detector_batch,
        init_detector,
    )
    from iif_torch.detection.losses import (
        DetIIFLoss,
        compute_det_iif_from_counts,
    )
    from iif_torch.ops.nms import nms
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_size,
        reset_launches,
        roi_align_ml,
    )

    cfg = Config.fromfile(str(REPO / "configs/iif/iif_r50_1x.py"))
    ann = BUILD / "lvis_v1_synthetic.json"
    counts = write_lvis_annotations(np, ann)
    cfg.data["test"]["ann_file"] = str(ann)
    t0 = time.time()
    det = init_detector(cfg, device="cuda")
    log(f"init_detector s {time.time() - t0:.3f}")
    check(isinstance(det.loss_cls, DetIIFLoss), "IIF loss built")
    want_w = compute_det_iif_from_counts(counts, LVIS_IMAGES)
    check(np.array_equal(det.loss_cls.weights.cpu().numpy(), want_w),
          "IIF weights from the counts")
    check(det.model.num_classes == NUM_CLASSES, "1203 classes")
    check(det.model.backbone.compute_dtype == torch.bfloat16, "bf16 trunk")
    check(det.test_cfg.score_thr == 1e-4 and det.test_cfg.max_per_img == 300,
          "LVIS test_cfg")
    check(det.pipeline.canvas == CANVAS, "800x1344 canvas")

    sizes, images = serving_images(np)
    # warm-up (cuDNN algorithm choice), not counted
    inference_detector(det, images[0], masks=False)
    inference_detector_batch(det, images[:2], pad_to=2, masks=False)
    torch.cuda.synchronize()

    # b1 path: REQUESTS requests cycling over the images, each timed on
    # the host clock (a request ends in its device-to-host copy)
    reset_launches()
    nms.host_syncs = 0
    b1_ms, results = [], []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        results.append(inference_detector(det, images[i % len(images)],
                                          masks=False))
        b1_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"b1": dict(roi_align_ml.launches_by_size)}
    kernel_paths = {"b1": dict(roi_align_ml.launches_by_path)}
    check(not grad_launches_by_size,
          "serving launches K1 alone, no K2")
    b1_syncs = nms.host_syncs / REQUESTS
    # b2 path: REQUESTS images in full batches of 2, per image
    reset_launches()
    nms.host_syncs = 0
    b2_ms, batched = [], []
    for i in range(0, REQUESTS, 2):
        pair = [images[i % len(images)], images[(i + 1) % len(images)]]
        t0 = time.perf_counter()
        batched += inference_detector_batch(det, pair, pad_to=2, masks=False)
        b2_ms.append((time.perf_counter() - t0) * 1e3 / 2)
    launches["b2"] = dict(roi_align_ml.launches_by_size)
    kernel_paths["b2"] = dict(roi_align_ml.launches_by_path)
    b2_syncs = nms.host_syncs / REQUESTS
    # b1 with pasted masks
    reset_launches()
    with_masks = inference_detector(det, images[0], masks=True)
    torch.cuda.synchronize()
    launches["b1_masks"] = dict(roi_align_ml.launches_by_size)
    kernel_paths["b1_masks"] = dict(roi_align_ml.launches_by_path)
    log("main path launches", json.dumps(launches),
        "by kernel path", json.dumps(kernel_paths),
        "nms host syncs per image", json.dumps({"b1": b1_syncs,
                                                "b2": b2_syncs}))
    for path, counts in launches.items():
        if not (counts.get(7, 0) > 0 and counts.get(14, 0) > 0):
            raise RuntimeError(
                f"RoIAlign kernel not on the {path} path: {counts}")
        check_vec8(f"K1 on the {path} path", kernel_paths[path],
                   sum(counts.values()))

    for res in results + batched + [with_masks]:
        check(res["boxes"].shape == (300, 4) and res["valid"].any(),
              "300 detections, some valid")
        for k, v in res.items():
            check(np.isfinite(v.astype(np.float64)).all(), f"finite {k}")
    check(with_masks["masks"].shape == (300,) + sizes[0]
          and with_masks["masks"].dtype == np.bool_, "pasted masks")

    # the outputs of one batched forward: keys, shapes, dtypes
    sample = det.pipeline(images[1], det.device)
    canvas = sample["image"][None].expand(2, -1, -1, -1)
    out = maskrcnn_simple_test(det.model, canvas, det.loss_cls, det.test_cfg)
    expect = {"boxes": ((2, 300, 4), torch.float32),
              "scores": ((2, 300), torch.float32),
              "labels": ((2, 300), torch.int64),
              "valid": ((2, 300), torch.bool),
              "masks": ((2, 300, 28, 28), torch.float32)}
    for k, (shape, dt) in expect.items():
        check(tuple(out[k].shape) == shape and out[k].dtype == dt,
              f"{k} shape and dtype")
        check(bool(torch.isfinite(out[k].float()).all()), f"finite {k}")

    # one served request: its FPN maps, RoIs and kernel outputs, recorded
    # at the extractor, against the plain RoIAlign on the same inputs
    compare = request_vs_plain(torch, det, images[1])
    log("request vs plain RoIAlign", json.dumps(compare))
    return {"b1_ms_per_image": spread(b1_ms),
            "b2_ms_per_image": spread(b2_ms),
            "nms_host_syncs_per_image_b1": b1_syncs,
            "nms_host_syncs_per_image_b2": b2_syncs, "launches": launches,
            "detector": det, "image": images[3]}


STAGES = ("backbone_fpn", "rpn", "bbox_roi_align", "bbox_head", "bbox_nms",
          "mask_roi_align", "mask_head")


def profile_phase(torch, det, image, modules, stages, kernel):
    """One b1 request of ``image``, three ways.

    Unprofiled: the median wall time of REQUESTS/2 requests, and of as
    many with the device drained at each stage's ends (the
    ``record_function`` spans ``stages`` of the simple_test in
    ``modules``, a module or a tuple of them, swapped for a synchronising
    timer), which gives each stage's wall
    time with its own host work and device work and nothing of its
    neighbours'. ``kernel`` names the RoIAlign kernel read by name.

    Under ``torch.profiler``: per stage the device time of the kernels
    launched inside its span, the device's busy time (union of kernel and
    copy intervals), and the kernels that take most device time. The busy
    share is that busy time over the unprofiled wall time: the profiler
    stretches the host's side of a request, not its device time."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iif_torch.detection.inference import inference_detector

    n = REQUESTS // 2
    inference_detector(det, image, masks=False)
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        inference_detector(det, image, masks=False)
        walls.append((time.perf_counter() - t0) * 1e3)
    stage_walls = {k: [] for k in stages}

    @contextlib.contextmanager
    def synced_span(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stage_walls[name].append((time.perf_counter() - t0) * 1e3)

    if not isinstance(modules, tuple):
        modules = (modules,)
    with patched(*((m, "record_function", synced_span) for m in modules)):
        for _ in range(n):
            inference_detector(det, image, masks=False)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_detector(det, image, masks=False)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    by_stage = {k: {"synced_wall_ms": statistics.median(stage_walls[k]),
                    "profiled_host_ms": 0.0, "kernel_ms": 0.0}
                for k in stages}
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.name in by_stage and e.device_type == DeviceType.CPU:
            by_stage[e.name]["profiled_host_ms"] += (
                e.time_range.elapsed_us() / 1e3)
            by_stage[e.name]["kernel_ms"] += e.device_time_total / 1e3
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            spans.append((e.time_range.start, e.time_range.end))
            t, k = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (t + e.time_range.elapsed_us() / 1e3, k + 1)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    wall_ms = statistics.median(walls)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    # the RoIAlign kernels are launched through ctypes, outside any aten
    # op, so the profiler does not charge them to a stage span; they are
    # read by their kernel name
    ker = [v for k, v in by_kernel.items() if kernel in k]
    return {"wall_ms": spread(walls), "profiled_wall_ms": profiled_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            f"{kernel}_ms": sum(t for t, _ in ker),
            f"{kernel}_launches": sum(k for _, k in ker),
            "stages": by_stage,
            "top_kernels": [(k[:70], t, c) for k, (t, c) in top]}


C4_STAGES = ("backbone", "rpn", "roi_align", "shared_head", "bbox_head",
             "bbox_nms")


def c4_serving_phase(torch, np):
    """Faster R-CNN R50-C4 as ``configs/faster_rcnn/
    faster_rcnn_r50_caffe_c4_1x_coco.py`` stands, seeded random weights,
    serving the 4 seeded images: REQUESTS b1 requests and REQUESTS/2 full
    b2 batches, each path's K3, K1 and K2 launches counted from 0, then
    one request's RoI features and class scores against the plain
    RoIAlign, and one forward at ``score_thr=0`` whose detections are
    checked for range."""
    import iif_torch.detection.c4 as c4_mod
    from iif_torch.config import Config
    from iif_torch.detection.inference import (
        inference_detector,
        inference_detector_batch,
        init_detector,
    )
    from iif_torch.detection.losses import DetCrossEntropyLoss
    from iif_torch.ops import roi_align as k3_mod
    from iif_torch.ops.nms import nms
    from iif_torch.ops import roi_align_ml as k12_mod

    cfg = Config.fromfile(str(REPO / C4_CONFIG))
    t0 = time.time()
    det = init_detector(cfg, device="cuda")
    log(f"init_detector C4 s {time.time() - t0:.3f}")
    model = det.model
    check(isinstance(model, c4_mod.C4FasterRCNN), "C4FasterRCNN built")
    check(model.num_classes == 80 and model.backbone.num_stages == 3
          and len(model.roi_head.shared_head.layer4) == 3,
          "80 classes, stages 1-3 trunk, 3-block res5 head")
    check(model.backbone.compute_dtype == torch.bfloat16, "bf16 trunk")
    check(model.backbone.frozen_stages == 1 and model.backbone.norm_eval,
          "frozen_stages=1, norm_eval")
    check(isinstance(det.loss_cls, DetCrossEntropyLoss), "CE loss")
    check(det.test_cfg.rpn_nms_pre == 1000 and det.test_cfg.rpn_max_per_img
          == C4_ROIS and det.test_cfg.score_thr == 0.05
          and det.test_cfg.nms_iou == 0.5 and det.test_cfg.max_per_img == 100,
          "C4 test_cfg")
    check(det.pipeline.canvas == CANVAS, "800x1344 canvas")

    sizes, images = serving_images(np)
    inference_detector(det, images[0], masks=False)
    inference_detector_batch(det, images[:2], pad_to=2, masks=False)
    torch.cuda.synchronize()

    def counts():
        return {"K3": k3_mod.roi_align.launches_by_size.get((14, 14), 0),
                "K3_all_sizes": sum(k3_mod.roi_align.launches_by_size
                                    .values()),
                "K4": sum(k3_mod.grad_launches_by_size.values()),
                "K1": sum(k12_mod.roi_align_ml.launches_by_size.values()),
                "K2": sum(k12_mod.grad_launches_by_size.values()),
                "K3_by_kernel_path": dict(k3_mod.roi_align.launches_by_path)}

    def reset():
        k3_mod.reset_launches()
        k12_mod.reset_launches()

    reset()
    nms.host_syncs = 0
    b1_ms, results = [], []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        results.append(inference_detector(det, images[i % len(images)],
                                          masks=False))
        b1_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"b1": counts()}
    syncs = {"b1": nms.host_syncs / REQUESTS}
    reset()
    nms.host_syncs = 0
    b2_ms, batched = [], []
    for i in range(0, REQUESTS, 2):
        pair = [images[i % len(images)], images[(i + 1) % len(images)]]
        t0 = time.perf_counter()
        batched += inference_detector_batch(det, pair, pad_to=2, masks=False)
        b2_ms.append((time.perf_counter() - t0) * 1e3 / 2)
    launches["b2"] = counts()
    syncs["b2"] = nms.host_syncs / REQUESTS
    log("C4 main path launches", json.dumps(launches),
        "nms host syncs per image", json.dumps(syncs))
    for path, n in (("b1", REQUESTS), ("b2", REQUESTS // 2)):
        got = launches[path]
        if not (got["K3"] == got["K3_all_sizes"] == n
                and got["K1"] == got["K2"] == got["K4"] == 0):
            raise RuntimeError(f"C4 {path} path: K3 must launch once a "
                               f"forward ({n}) and K1/K2/K4 never: {got}")
        check_vec8(f"K3 on the C4 {path} path", got["K3_by_kernel_path"], n)
    for res in results + batched:
        check(set(res) == {"boxes", "scores", "labels", "valid"}
              and res["boxes"].shape == (100, 4), "100 boxes, no masks")
        for k, v in res.items():
            check(np.isfinite(v.astype(np.float64)).all(), f"finite {k}")

    # one served request: the C4 map, RoIs and K3's output, recorded at
    # the call, against the plain RoIAlign on the same inputs
    seen = []
    k3 = c4_mod.roi_align

    def record(feat, rois, *args, **kw):
        out = k3(feat, rois, *args, **kw)
        seen.append((feat, rois, out))
        return out

    c4_mod.roi_align = record
    try:
        inference_detector(det, images[1], masks=False)
    finally:
        c4_mod.roi_align = k3
    check(len(seen) == 1, "one RoIAlign call a request")
    feat, rois, k_feat = seen[0]
    check(tuple(feat.shape) == (1, *C4_MAP, C4_CHANNELS)
          and feat.dtype == torch.bfloat16
          and tuple(k_feat.shape) == (C4_ROIS, 14, 14, C4_CHANNELS)
          and k_feat.dtype == torch.float32,
          "K3 on the bf16 C4 map, 1000 RoIs, f32 out")
    compare = {}
    with torch.inference_mode():
        p_feat = plain_single_chunked(feat, rois, (14, 14), 1 / 16)
        compare["roi_feats_max_abs_err"] = (k_feat - p_feat).abs().max(
            ).item()
        compare["roi_feats_tolerance"] = F32_TOL
        if compare["roi_feats_max_abs_err"] > F32_TOL:
            raise RuntimeError(f"C4 RoI features differ: {compare}")
        k_cls = model.forward_bbox(model.forward_shared(k_feat))[0]
        p_cls = model.forward_bbox(model.forward_shared(p_feat))[0]
        rel = ((k_cls - p_cls).abs().max() / p_cls.abs().max()).item()
        compare["cls_score_max_rel_err"] = rel
        compare["cls_score_tolerance"] = CLS_REL_TOL
        if rel > CLS_REL_TOL:
            raise RuntimeError(f"C4 cls_score differs: {rel}")
        # seeded weights give near-uniform 81-way scores (below the
        # config's 0.05): score_thr=0 makes the NMS keep detections
        sample = det.pipeline(images[3], det.device)
        out = c4_mod.c4_simple_test(model, sample["image"][None],
                                    det.loss_cls,
                                    det.test_cfg._replace(score_thr=0.0))
    compare["valid_at_0_05"] = int(sum(r["valid"].sum() for r in results))
    valid = out["valid"][0]
    boxes = out["boxes"][0][valid]
    compare["valid_at_0"] = int(valid.sum())
    check(bool(valid.any()), "detections at score_thr=0")
    check(bool(((boxes[:, 2:] >= boxes[:, :2]).all()
                & (boxes[:, 2] <= CANVAS[1]).all()
                & (boxes[:, 3] <= CANVAS[0]).all() & (boxes >= 0).all())),
          "boxes inside the canvas")
    check(bool(((out["labels"][0][valid] >= 0)
                & (out["labels"][0][valid] < 80)).all()), "80-way labels")
    check(bool(((out["scores"][0][valid] > 0)
                & (out["scores"][0][valid] <= 1)).all()), "softmax scores")
    log("C4 request vs plain RoIAlign", json.dumps(compare))
    return {"b1_ms_per_image": spread(b1_ms),
            "b2_ms_per_image": spread(b2_ms),
            "nms_host_syncs_per_image": syncs, "launches": launches,
            "compare": compare, "detector": det, "image": images[3]}


K12_PARTS = (("K1", "roi_align_ml_fwd_kernel"),
             ("K2", "roi_align_ml_bwd_kernel"),
             ("K2 cast", "cast_f32_bf16_kernel"))
TRAIN_STAGES = ("backbone_fpn", "rpn_loss", "rpn_proposals", "bbox_targets",
                "bbox_roi_align", "bbox_head_loss", "mask_targets",
                "mask_roi_align", "mask_head_loss", "backward", "optimizer")


def synthetic_train_batch(np, torch, device, num_classes=NUM_CLASSES,
                          with_masks=True):
    """A b4 batch shaped like ``bench.py``'s detection batch: uint8
    canvases, TRAIN_GT gt slots an image with about 30% valid, boxes 20 to
    100 px, ``num_classes``-way labels and, ``with_masks``, masks at half
    resolution bit-packed on the last axis."""
    b, (h, w), g = TRAIN_BATCH, CANVAS, TRAIN_GT
    rng = np.random.RandomState(0)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_boxes[..., 0] = rng.uniform(0, w - 100, (b, g))
    gt_boxes[..., 1] = rng.uniform(0, h - 100, (b, g))
    gt_boxes[..., 2] = gt_boxes[..., 0] + rng.uniform(20, 100, (b, g))
    gt_boxes[..., 3] = gt_boxes[..., 1] + rng.uniform(20, 100, (b, g))
    batch = {
        "image": rng.randint(0, 256, (b, h, w, 3), np.uint8),
        "gt_boxes": gt_boxes,
        "gt_labels": rng.randint(0, num_classes, (b, g)).astype(np.int64),
        "gt_valid": rng.rand(b, g) < 0.3,
    }
    if with_masks:
        batch["gt_masks_packed"] = np.packbits(
            (rng.rand(b, g, h // 2, w // 2) < 0.1).astype(np.uint8),
            axis=-1)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run_train_steps(torch, trainer, state, batch, launch_counts):
    """TRAIN_WARMUP + TRAIN_STEPS steps on ``batch`` after every launch
    count and the NMS host syncs are set to 0: the host-clock time of the
    timed steps, every step's losses (all finite), the launch counts read
    just after (``launch_counts()``) and the syncs a step."""
    from iif_torch.ops import roi_align as k34_mod
    from iif_torch.ops import roi_align_ml as k12_mod
    from iif_torch.ops.nms import nms

    torch.cuda.synchronize()
    k12_mod.reset_launches()
    k34_mod.reset_launches()
    nms.host_syncs = 0
    step_ms, metrics = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = launch_counts()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    losses = [{k: v.item() for k, v in m.items()} for m in metrics]
    for i, row in enumerate(losses):
        log(f"train step {i}", json.dumps(row))
        for k, v in row.items():
            check(math.isfinite(v), f"finite {k} at step {i}")
    return state, step_ms, losses, launches, nms.host_syncs / n_steps


def profile_train_step(torch, trainer, state, batch, modules, stages,
                       kernel_parts, step_median):
    """Each of ``stages`` (the ``record_function`` spans of ``modules``)
    synchronised at its ends: its wall time on the host clock over 2
    steps, then one step under torch.profiler, where the kernels that ran
    inside a span's window are the stage's; the device's busy share over
    the unprofiled step median; the kernels of ``kernel_parts`` (label ->
    part of the kernel's name) by name."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    walls = {k: [] for k in stages}

    @contextlib.contextmanager
    def synced_span(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(name):
            yield
            torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)

    originals = [m.record_function for m in modules]
    for m in modules:
        m.record_function = synced_span
    try:
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
    finally:
        for m, orig in zip(modules, originals):
            m.record_function = orig
    windows, kernels = [], []
    for e in prof.events():
        if e.name in walls and e.device_type == DeviceType.CPU:
            windows.append((e.time_range.start, e.time_range.end, e.name))
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            kernels.append((e.time_range.start, e.time_range.end, e.name))
    by_stage = {k: {"synced_wall_ms": statistics.median(v[:2]),
                    "kernel_ms": 0.0} for k, v in walls.items()}
    by_kernel = {}
    busy_us, end = 0.0, float("-inf")
    for lo, hi, name in sorted(kernels):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
        t, c = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (t + (hi - lo) / 1e3, c + 1)
        for wlo, whi, stage in windows:
            if wlo <= lo < whi:
                by_stage[stage]["kernel_ms"] += (hi - lo) / 1e3
                break
    return state, {
        "stages": by_stage,
        "stage_wall_sum_ms": sum(v["synced_wall_ms"]
                                 for v in by_stage.values()),
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / step_median,
        "roi_align_kernels": {
            label: [sum(t for k, (t, _) in by_kernel.items() if part in k),
                    sum(c for k, (_, c) in by_kernel.items() if part in k)]
            for label, part in kernel_parts},
        "top_kernels": [(k[:70], t, c) for k, (t, c) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][0])[:12]]}


def training_phase(torch, np):
    """The trainer of the headline config for TRAIN_WARMUP + TRAIN_STEPS
    steps at b4, its launches and checks, then its stages."""
    import iif_torch.detection.detector as detector_mod
    import iif_torch.engine.detection as engine_mod
    from iif_torch.config import Config
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.inference import build_loss_cls
    from iif_torch.detection.losses import compute_det_iif_from_counts
    from iif_torch.engine.detection import trainer_from_config
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_path,
        grad_launches_by_size,
        roi_align_ml,
    )

    cfg = Config.fromfile(str(REPO / "configs/iif/iif_r50_1x.py"))
    ann = BUILD / "lvis_v1_synthetic.json"
    counts = write_lvis_annotations(np, ann)
    cfg.data["train"]["ann_file"] = str(ann)
    train_ds = build_dataset({k: v for k, v in cfg.data["train"].items()
                              if k != "oversample_thr"})
    loss_cls = build_loss_cls(cfg.loss_cls, train_ds, NUM_CLASSES)
    check(np.array_equal(np.asarray(loss_cls.weights),
                         compute_det_iif_from_counts(counts, LVIS_IMAGES)),
          "IIF weights from the counts")
    t0 = time.time()
    trainer = trainer_from_config(
        cfg, loss_cls, LVIS_IMAGES // cfg.data["samples_per_gpu"],
        device="cuda")
    log(f"trainer_from_config s {time.time() - t0:.3f}")
    model, tcfg = trainer.model, trainer.train_cfg
    check(model.num_classes == NUM_CLASSES, "1203 classes")
    check(model.backbone.compute_dtype == torch.bfloat16, "bf16 trunk")
    check(model.backbone.frozen_stages == 1 and model.backbone.norm_eval,
          "frozen_stages=1, norm_eval")
    check(tcfg.rpn_nms_pre == 2000 and tcfg.mask_gt_stride == 2,
          "train_cfg rpn_nms_pre=2000, mask_gt_stride=2")
    check(cfg.data["samples_per_gpu"] == TRAIN_BATCH, "samples_per_gpu=4")
    state = trainer.init_state()
    opt = state.optimizer.param_groups[0]
    check(opt["momentum"] == 0.9 and opt["weight_decay"] == 1e-4
          and abs(opt["lr"] / (0.02 / 1000) - 1) < 1e-6
          and abs(trainer.lr_schedule(500) / 0.02 - 1) < 1e-6,
          "SGD 0.02, momentum 0.9, wd 1e-4, 500 warm-up steps from 1/1000")
    batch = synthetic_train_batch(np, torch, "cuda")
    params = dict(model.named_parameters())
    watch = {n: params[n].detach().clone() for n in (
        "backbone.layer1.0.conv1.weight", "backbone.layer2.0.conv1.weight",
        "roi_head.bbox_head.fc_cls.weight",
        "roi_head.mask_head.conv_logits.weight")}

    # the training path: K1 and K2 counted from 0 over all its steps
    torch.cuda.reset_peak_memory_stats()
    state, step_ms, losses, launches, syncs = run_train_steps(
        torch, trainer, state, batch,
        lambda: {"K1": dict(roi_align_ml.launches_by_size),
                 "K2": dict(grad_launches_by_size)})
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    log("training path launches", json.dumps(launches), "K1 by kernel path",
        json.dumps(roi_align_ml.launches_by_path), "K2 by kernel path",
        json.dumps(grad_launches_by_path))
    for k, counts_k in launches.items():
        if counts_k != {7: n_steps, 14: n_steps}:
            raise RuntimeError(f"{k} not launched once a size a step on the "
                               f"training path: {counts_k}")
    check_vec8("K1 on the training path", roi_align_ml.launches_by_path,
               2 * n_steps)
    check_vec8("K2 on the training path", grad_launches_by_path, 2 * n_steps)
    moved = {n: (params[n].detach() - v).abs().max().item()
             for n, v in watch.items()}
    log("parameter change", json.dumps(moved))
    check(moved["backbone.layer1.0.conv1.weight"] == 0.0,
          "frozen stage-1 weight unchanged")
    check(all(v > 0 for n, v in moved.items() if "layer1" not in n),
          "trainable parameters moved")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    result = {"steps": n_steps, "step_ms": spread(step_ms),
              "img_per_s": TRAIN_BATCH * 1e3 / statistics.median(step_ms),
              "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
              "launches": launches, "nms_host_syncs_per_step": syncs,
              "peak_allocated_gib": peak_gb}
    state, result["profile"] = profile_train_step(
        torch, trainer, state, batch, (detector_mod, engine_mod),
        TRAIN_STAGES, K12_PARTS, statistics.median(step_ms))
    return result


C4_TRAIN_STAGES = ("backbone", "rpn_loss", "rpn_proposals", "bbox_targets",
                   "roi_align", "shared_head", "bbox_head_loss", "backward",
                   "optimizer")


def c4_training_phase(torch, np):
    """The trainer of the C4 config as it stands for TRAIN_WARMUP +
    TRAIN_STEPS steps at b4: K3's and K4's launches (K1's and K2's: none)
    counted from 0, every loss finite, stage 1 frozen and the trainable
    parameters moved; then its stages."""
    import iif_torch.detection.c4 as c4_mod
    import iif_torch.engine.detection as engine_mod
    from iif_torch.config import Config
    from iif_torch.detection.inference import build_loss_cls
    from iif_torch.detection.losses import DetCrossEntropyLoss
    from iif_torch.engine.detection import trainer_from_config
    from iif_torch.ops import roi_align as k34_mod
    from iif_torch.ops import roi_align_ml as k12_mod

    cfg = Config.fromfile(str(REPO / C4_CONFIG))
    loss_cls = build_loss_cls(cfg.loss_cls, None, C4_CLASSES)
    check(isinstance(loss_cls, DetCrossEntropyLoss), "CE loss")
    t0 = time.time()
    trainer = trainer_from_config(
        cfg, loss_cls, COCO_TRAIN_IMAGES // cfg.data["samples_per_gpu"],
        device="cuda")
    log(f"trainer_from_config C4 s {time.time() - t0:.3f}")
    model, tcfg = trainer.model, trainer.train_cfg
    check(isinstance(model, c4_mod.C4FasterRCNN)
          and trainer.loss_fn is c4_mod.c4_loss, "C4 model, c4_loss")
    check(model.num_classes == C4_CLASSES and model.backbone.num_stages == 3
          and len(model.roi_head.shared_head.layer4) == 3,
          "80 classes, stages 1-3 trunk, 3-block res5 head")
    check(model.backbone.compute_dtype == torch.bfloat16, "bf16 trunk")
    check(model.backbone.frozen_stages == 1 and model.backbone.norm_eval,
          "frozen_stages=1, norm_eval")
    check(tcfg.rpn_nms_pre == 2000 and tcfg.rpn_max_per_img == 2000
          and tcfg.rcnn_num_samples * TRAIN_BATCH == C4_TRAIN_ROIS,
          "train_cfg rpn_nms_pre=2000, rpn_max_per_img=2000, 512 RoIs")
    check(cfg.data["samples_per_gpu"] == TRAIN_BATCH, "samples_per_gpu=4")
    state = trainer.init_state()
    opt = state.optimizer.param_groups[0]
    check(opt["momentum"] == 0.9 and opt["weight_decay"] == 1e-4
          and abs(opt["lr"] / (0.02 / 1000) - 1) < 1e-6
          and abs(trainer.lr_schedule(500) / 0.02 - 1) < 1e-6,
          "SGD 0.02, momentum 0.9, wd 1e-4, 500 warm-up steps from 1/1000")
    batch = synthetic_train_batch(np, torch, "cuda", C4_CLASSES,
                                  with_masks=False)
    params = dict(model.named_parameters())
    watch = {n: params[n].detach().clone() for n in (
        "backbone.layer1.0.conv1.weight", "backbone.layer2.0.conv1.weight",
        "roi_head.shared_head.layer4.0.conv1.weight",
        "roi_head.bbox_head.fc_cls.weight")}

    # the C4 training path: K3 and K4 (and K1, K2) counted from 0
    torch.cuda.reset_peak_memory_stats()
    state, step_ms, losses, launches, syncs = run_train_steps(
        torch, trainer, state, batch,
        lambda: {"K3": dict(k34_mod.roi_align.launches_by_size),
                 "K4": dict(k34_mod.grad_launches_by_size),
                 "K1": dict(k12_mod.roi_align_ml.launches_by_size),
                 "K2": dict(k12_mod.grad_launches_by_size)})
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    log("C4 training path launches",
        json.dumps({k: {str(s): n for s, n in v.items()}
                    for k, v in launches.items()}), "K3 by kernel path",
        json.dumps(k34_mod.roi_align.launches_by_path), "K4 by kernel path",
        json.dumps(k34_mod.grad_launches_by_path))
    want = {"K3": {(14, 14): n_steps}, "K4": {(14, 14): n_steps},
            "K1": {}, "K2": {}}
    if launches != want:
        raise RuntimeError(f"C4 training path: K3 and K4 must launch once a "
                           f"step at 14x14 and K1/K2 never: {launches}")
    check_vec8("K3 on the C4 training path",
               k34_mod.roi_align.launches_by_path, n_steps)
    check_vec8("K4 on the C4 training path", k34_mod.grad_launches_by_path,
               n_steps)
    moved = {n: (params[n].detach() - v).abs().max().item()
             for n, v in watch.items()}
    log("C4 parameter change", json.dumps(moved))
    check(moved["backbone.layer1.0.conv1.weight"] == 0.0,
          "frozen stage-1 weight unchanged")
    check(all(v > 0 for n, v in moved.items() if "layer1" not in n),
          "trainable parameters moved")
    result = {"steps": n_steps, "step_ms": spread(step_ms),
              "img_per_s": TRAIN_BATCH * 1e3 / statistics.median(step_ms),
              "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
              "launches": {k: v.get((14, 14), 0) for k, v in launches.items()},
              "nms_host_syncs_per_step": syncs,
              "peak_allocated_gib":
                  torch.cuda.max_memory_allocated() / 2 ** 30}
    state, result["profile"] = profile_train_step(
        torch, trainer, state, batch, (c4_mod, engine_mod), C4_TRAIN_STAGES,
        (("K3", "roi_align_fwd_kernel"), ("K4", "roi_align_bwd_kernel")),
        statistics.median(step_ms))
    return result


FILES_IMAGES = 64                  # images of the synthetic LVIS set
FILES_RESUME_STEPS = 2             # steps after the resume
FILES_PREBUILT = 6                 # steps on batches built beforehand
WATCH = ("backbone.layer1.0.conv1.weight", "backbone.layer2.0.conv1.weight",
         "roi_head.bbox_head.fc_cls.weight",
         "roi_head.mask_head.conv_logits.weight")


def files_sizes():
    """32 landscape and 32 portrait COCO sizes: each aspect group fills
    whole b4 batches."""
    from iif_torch.tools.synthetic_lvis import COCO_SIZES

    half = FILES_IMAGES // 2
    return ([COCO_SIZES[i % 3] for i in range(half)]
            + [COCO_SIZES[3 + i % 3] for i in range(half)])


@contextlib.contextmanager
def patched(*changes):
    """Set each (object, attribute, value) for the block, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in changes]
    for obj, name, value in changes:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def busy_in_spans(prof, span):
    """The CPU windows of the ``span`` record_function (each ends in a
    device sync) and the device's busy time inside them: the union of
    the CUDA kernels that start in a window. Returns (windows, window ms,
    busy ms)."""
    from torch.autograd import DeviceType

    windows, kernels = [], []
    for e in prof.events():
        if e.name == span and e.device_type == DeviceType.CPU:
            windows.append((e.time_range.start, e.time_range.end))
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            kernels.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(kernels):
        if hi > end and any(a <= lo < b for a, b in windows):
            busy += hi - max(lo, end)
            end = hi
    return len(windows), sum(b - a for a, b in windows) / 1e3, busy / 1e3


def sample_host_shares(np, torch, ann_file, img_prefix, cfg, n=8):
    """A train sample's host time split: decode (``read_image``), the
    image resize alone, and the masks (the sample with masks less the
    sample without), at the largest scale, over ``n`` images in one loader
    worker's setting, each share of decode + the whole sample."""
    from concurrent.futures import ThreadPoolExecutor

    from iif_torch.cli.train_det import build_pipeline
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.image_io import read_image
    from iif_torch.detection.pipeline import resize_bilinear, resized_shape

    ds = build_dataset({"type": "LVISV1Dataset", "ann_file": ann_file,
                        "img_prefix": img_prefix})
    pipe = build_pipeline(cfg)
    bare = build_pipeline(cfg)
    bare.with_mask = False
    t = {"decode": 0.0, "resize": 0.0, "sample": 0.0, "sample_no_masks": 0.0}
    last = len(pipe.scales) - 1

    def one(i):
        t0 = time.perf_counter()
        img = read_image(ds.image_path(i))
        t1 = time.perf_counter()
        ann = ds.get_ann(i)
        pipe.sample(img, ann, np.random.RandomState(i), scale_idx=last)
        t2 = time.perf_counter()
        bare.sample(img, ann, np.random.RandomState(i), scale_idx=last)
        t3 = time.perf_counter()
        _, nh, nw = resized_shape(*img.shape[:2], pipe.scales[last],
                                  pipe.canvas_of[last])
        resize_bilinear(torch.from_numpy(img), nh, nw)
        t4 = time.perf_counter()
        t["decode"] += t1 - t0
        t["sample"] += t2 - t1
        t["sample_no_masks"] += t3 - t2
        t["resize"] += t4 - t3

    # in a thread set up as the loader's workers are (one intra-op thread)
    with ThreadPoolExecutor(1, initializer=torch.set_num_threads,
                            initargs=(1,)) as pool:
        list(pool.map(one, range(n)))
        threads = pool.submit(torch.get_num_threads).result()
    total = t["decode"] + t["sample"]
    return {"images": n, "ms_per_sample": total / n * 1e3,
            "decode_share": t["decode"] / total,
            "resize_share": t["resize"] / total,
            "mask_share": (t["sample"] - t["sample_no_masks"]) / total,
            "intra_op_threads": threads}


def files_training_phase(torch, np, tmp):
    """``python -m iif_torch.cli.train_det`` in the process on the
    headline config as it stands (1203 classes, bf16 trunk, b4, six
    canvas buckets, masks at stride 2 bit-packed), its annotation and
    image paths overridden to a seeded synthetic LVIS set of FILES_IMAGES
    PNGs on disk, and ``runner.max_epochs=1``: one epoch through the loader with K1's and K2's launches counted from
    0 (one a size a step, all on ``vec8``), at least 3 buckets, every
    loss finite, the frozen stage unchanged and trainable parameters
    moved, ``epoch_1.pth`` written; K1 and K2 held against their plain
    versions on one step's features and RoIs on a bucket other than 800;
    a resume for FILES_RESUME_STEPS steps under torch.profiler (the
    device's busy share in the steps); the checkpoint served back by
    ``init_detector`` on one of the training images, its RoI features
    against the plain version; the host time of a sample by part. The
    set and the work directory go under ``tmp``; the work directory is
    returned under ``work_dir``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import iif_torch.engine.detection as engine_mod
    from iif_torch.cli import train_det
    from iif_torch.config import Config, parse_cfg_options
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.inference import (
        inference_detector,
        init_detector,
    )
    from iif_torch.detection.pipeline import DetectionLoader
    from iif_torch.detection.roi_extractor import SingleRoIExtractor
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_path,
        grad_launches_by_size,
        reset_launches,
        roi_align_ml,
    )
    from iif_torch.tools.synthetic_lvis import write_synthetic_lvis
    from iif_torch.utils.checkpoint import read_meta

    config = str(REPO / "configs/iif/iif_r50_1x.py")
    steps, waits, metrics, captured, watch = [], [], [], {}, {}

    def timed_step(self, state, batch, _step=engine_mod.DetectionTrainer
                   .train_step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("files_step"):
            out = _step(self, state, batch)
            torch.cuda.synchronize()
        steps.append((int(batch["image"].shape[1]),
                      (time.perf_counter() - t0) * 1e3))
        metrics.append(out[1])
        return out

    def timed_iter(self, _iter=DetectionLoader.__iter__):
        batches = _iter(self)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    return
                waits.append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            batches.close()

    def capture(self, feats, rois, _extract=SingleRoIExtractor.__call__):
        out = _extract(self, feats, rois)
        h, o = feats[0].shape[1] * 4, self.output_size[0]
        if (h != CANVAS[0] and o not in captured
                and captured.setdefault("h", h) == h):
            captured[o] = ([f.detach().float() for f in feats[:4]],
                           rois.detach().clone())
        return out

    def watched(*args, _make=engine_mod.trainer_from_config, **kw):
        trainer = _make(*args, **kw)
        params = dict(trainer.model.named_parameters())
        watch.update({n: params[n].detach().clone() for n in WATCH})
        return trainer

    t0 = time.time()
    data = write_synthetic_lvis(str(tmp / "lvis"), files_sizes(),
                                NUM_CLASSES, seed=0)
    log(f"synthetic LVIS set of {FILES_IMAGES} PNGs s "
        f"{time.time() - t0:.3f}")
    options = [f"data.train.ann_file={data['ann_file']}",
               f"data.train.img_prefix={data['img_prefix']}"]
    work = str(tmp / "work")
    argv = [config, "--work-dir", work]

    # one epoch: K1 and K2 counted from 0 over all its steps
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched((engine_mod.DetectionTrainer, "train_step", timed_step),
                 (DetectionLoader, "__iter__", timed_iter),
                 (SingleRoIExtractor, "__call__", capture),
                 (engine_mod, "trainer_from_config", watched)):
        trainer, state = train_det.main(
            argv + ["--cfg-options", *options, "runner.max_epochs=1"])
    run_s = time.perf_counter() - t0
    launches = {"K1": dict(roi_align_ml.launches_by_size),
                "K2": dict(grad_launches_by_size)}
    by_path = {"K1": dict(roi_align_ml.launches_by_path),
               "K2": dict(grad_launches_by_path)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(steps)
    log("files path launches", json.dumps(launches), "by kernel path",
        json.dumps(by_path))
    check(n == FILES_IMAGES // TRAIN_BATCH == state.step,
          f"one epoch of {FILES_IMAGES // TRAIN_BATCH} steps: {n}")
    for k in ("K1", "K2"):
        check(launches[k] == {7: n, 14: n},
              f"{k} once a size a step on the files path")
        check_vec8(f"{k} on the files path", by_path[k], 2 * n)
    canvases = sorted({h for h, _ in steps})
    check(len(canvases) >= 3, f"at least 3 canvas buckets: {canvases}")
    losses = [{k: v.item() for k, v in m.items()} for m in metrics]
    for i, row in enumerate(losses):
        for k, v in row.items():
            check(math.isfinite(v), f"finite {k} at step {i}")
    params = dict(trainer.model.named_parameters())
    moved = {k: (params[k].detach() - v).abs().max().item()
             for k, v in watch.items()}
    log("files parameter change", json.dumps(moved))
    check(moved["backbone.layer1.0.conv1.weight"] == 0.0,
          "frozen stage-1 weight unchanged")
    check(all(v > 0 for k, v in moved.items() if "layer1" not in k),
          "trainable parameters moved")
    ckpt = str(Path(work) / "checkpoints" / "epoch_1.pth")
    check(read_meta(ckpt)["iter"] == n, "epoch_1.pth after the epoch")

    # the same trainer on the epoch's first batches built beforehand:
    # steps with the loader idle, against the epoch's
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(
        options + [f"data.test.ann_file={data['ann_file']}"]))
    loader = DetectionLoader(
        build_dataset({k: v for k, v in cfg.data["train"].items()
                       if k != "oversample_thr"}),
        train_det.build_pipeline(cfg),
        batch_size=cfg.data["samples_per_gpu"], seed=cfg.seed)
    batches = []
    for batch in loader:
        batches.append({k: v for k, v in batch.items()
                        if k in engine_mod.FEED_KEYS})
        if len(batches) == FILES_PREBUILT:
            break
    prebuilt = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        prebuilt.append((int(batch["image"].shape[1]),
                         (time.perf_counter() - t0) * 1e3))
    del batches

    # K1 and K2 on one step's features and RoIs, a bucket below 800
    check(7 in captured and 14 in captured,
          f"a step on a bucket other than {CANVAS[0]}")
    k1, k2 = {}, {}
    rng = np.random.RandomState(5)
    for o in (7, 14):
        feats32, rois = captured[o]
        g32 = torch.tensor(rng.randn(rois.shape[0], o, o, 256),
                           dtype=torch.float32, device=rois.device)
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, feats32, rois, o, dt)
            k1[(o, row["dtype"])] = row
            row = k2_row(torch, feats32, rois, g32, o, dt)
            k2[(o, row["dtype"])] = row
    bucket = captured.pop("h")
    levels = [list(f.shape[1:3]) for f in captured[7][0]]
    captured.clear()

    # resume for FILES_RESUME_STEPS steps, profiled
    first = len(steps)
    with patched((engine_mod.DetectionTrainer, "train_step", timed_step),
                 (DetectionLoader, "__iter__", timed_iter)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, resumed = train_det.main(argv + [
                "--resume-from", ckpt, "--max-steps",
                str(FILES_RESUME_STEPS), "--cfg-options", *options,
                "runner.max_epochs=2"])
    check(resumed.step == n + FILES_RESUME_STEPS,
          f"resumed at step {n}, {FILES_RESUME_STEPS} more")
    spans, span_ms, busy_ms = busy_in_spans(prof, "files_step")
    check(spans == FILES_RESUME_STEPS, "profiled resume steps")

    # the checkpoint served back on a training image (PNG, no cv2)
    det = init_detector(cfg, ckpt, device="cuda")
    image = str(Path(data["img_prefix"]) / "train2017" /
                "000000000001.png")
    served = inference_detector(det, image, masks=False)
    check(served["boxes"].shape == (300, 4) and served["valid"].any(),
          "300 detections, some valid")
    compare = request_vs_plain(torch, det, image)
    log("served checkpoint vs plain RoIAlign", json.dumps(compare))
    shares = sample_host_shares(np, torch, data["ann_file"],
                                data["img_prefix"], cfg)

    epoch = steps[:first]
    by_bucket = {}
    for h in canvases:
        ms = [t for c, t in epoch if c == h]
        by_bucket[f"{h}x{CANVAS[1]}"] = {
            "steps": len(ms), "first_ms": ms[0],
            "after_first": spread(ms[1:]) if len(ms) > 1 else None}
    steady = [t for i, (c, t) in enumerate(epoch)
              if c in {cc for cc, _ in epoch[:i]}]
    epoch_ms = sum(t for _, t in epoch) + sum(waits[:first])
    per_step_busy = busy_ms / spans
    return {"steps": n, "buckets": by_bucket,
            "step_ms_after_first_of_bucket": spread(steady),
            "step_ms_prebuilt_batches": spread([t for _, t in prebuilt]),
            "prebuilt_buckets": [h for h, _ in prebuilt],
            "img_per_s": FILES_IMAGES * 1e3 / epoch_ms,
            "img_per_s_steady": TRAIN_BATCH * 1e3
                                / statistics.median(steady),
            "loader_wait_ms": spread(waits[:first]),
            "run_s": run_s, "first_loss": losses[0]["loss"],
            "last_loss": losses[-1]["loss"],
            "launches": {k: v for k, v in launches.items()},
            "peak_allocated_gib": peak_gb,
            "resume_profile": {
                "steps": spans, "step_window_ms": span_ms,
                "device_busy_ms": busy_ms,
                "device_busy_share_profiled": busy_ms / span_ms,
                "device_busy_share_of_epoch_median":
                    per_step_busy / statistics.median(steady),
                "device_busy_share_of_prebuilt_median":
                    per_step_busy / statistics.median(
                        [t for _, t in prebuilt])},
            "kernel_bucket": f"{bucket}x{CANVAS[1]}", "kernel_levels": levels,
            "served": compare, "host_sample": shares, "k1": k1, "k2": k2,
            "work_dir": work}


EVAL_IMAGES = 32                   # images of the seeded LVIS val set
AP_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf")


def same_ap(a, b):
    """Two AP dicts equal bit for bit, NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def eval_sizes():
    """COCO sizes, landscape and portrait in turn."""
    from iif_torch.tools.synthetic_lvis import COCO_SIZES

    return [COCO_SIZES[i % len(COCO_SIZES)] for i in range(EVAL_IMAGES)]


def gt_as_detections(dataset):
    """Every non-crowd gt of ``dataset`` as a detection: its box, score 1,
    its mask as compressed RLE and that mask's area."""
    from iif_torch.detection.mask_utils import (
        mask_area,
        rle_encode,
        segm_to_bitmap,
    )

    dets = []
    for rec in dataset.img_infos:
        for a in rec["anns"]:
            if a.get("iscrowd", 0):
                continue
            segm = a["segmentation"]
            if not (isinstance(segm, dict) and isinstance(segm["counts"],
                                                          str)):
                segm = rle_encode(segm_to_bitmap(segm, rec["height"],
                                                 rec["width"]))
            dets.append({"image_id": rec["id"],
                         "category_id": a["category_id"],
                         "bbox": list(a["bbox"]), "score": 1.0,
                         "segmentation": segm, "area": mask_area(segm)})
    return dets


def evaluation_phase(torch, np, work, tmp):
    """``python -m iif_torch.cli.test_det`` in the process on the headline
    config as it stands (1203 classes, bf16 trunk, ``score_thr=1e-4``,
    300 detections, masks, b4) with the files phase's checkpoint (its
    work directory: ``latest.pth``) on a seeded LVIS v1-style val set of
    EVAL_IMAGES PNGs with negative and not-exhaustive category ids
    (``data.test.*``), ``--eval bbox segm --out``. Each batch's host time
    split into the loader (decode, canvas on the card), the device
    forward drained, the masks' paste and read-back, the RLE encode and
    the results conversion; the evaluator's seconds by metric; K1's
    launches from 0 (2 a batch, all on ``vec8``; K2-K4 none); the first
    batch's RoI features and class scores against the plain RoIAlign;
    the rescaled boxes against NumPy's true division; the val set's own
    gt as detections scoring AP 1; the evaluator's AP dicts through the
    C++ matcher and IoU equal to the plain Python ones; ``results.json``
    read back equal to the records."""
    from iif_torch.cli import test_det
    from iif_torch.config import Config, parse_cfg_options
    from iif_torch.detection import simple_test
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.evaluation import DetEvaluator
    from iif_torch.detection.roi_extractor import SingleRoIExtractor
    from iif_torch.ops import roi_align as single_mod
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_size,
        reset_launches,
        roi_align_ml,
    )
    from iif_torch.tools.eval_timing import batch_split, summarize
    from iif_torch.tools.synthetic_lvis import write_synthetic_lvis

    config = str(REPO / "configs/iif/iif_r50_1x.py")
    t0 = time.time()
    data = write_synthetic_lvis(str(tmp / "val"), eval_sizes(), NUM_CLASSES,
                                seed=1, neg_ids=True)
    log(f"synthetic LVIS val set of {EVAL_IMAGES} PNGs s "
        f"{time.time() - t0:.3f}")
    options = [f"data.test.ann_file={data['ann_file']}",
               f"data.test.img_prefix={data['img_prefix']}"]
    out_json = tmp / "results.json"
    seen, model, rescaled, runs, evals = [], [], [], [], []

    def make(m, loss_cls, test_cfg, _make=simple_test.make_simple_test):
        model.append(m)
        return _make(m, loss_cls, test_cfg)

    def record(self, feats, rois, _extract=SingleRoIExtractor.__call__):
        out = _extract(self, feats, rois)
        if len(seen) < 2:
            seen.append((self.output_size[0], feats, rois, out))
        return out

    def rescale(boxes, sf, _rescale=test_det.rescale_boxes):
        out = _rescale(boxes, sf)
        rescaled.append((boxes.cpu().numpy(), np.asarray(sf),
                         out.cpu().numpy()))
        return out

    def run(*args, _run=test_det.run_inference, **kw):
        runs.append(_run(*args, **kw))
        return runs[-1]

    def evaluate(self, dets, iou_type="bbox", _ev=DetEvaluator.evaluate):
        t0 = time.perf_counter()
        res = _ev(self, dets, iou_type)
        evals.append((iou_type, self.native, time.perf_counter() - t0))
        return res

    reset_launches()
    single_mod.reset_launches()
    t0 = time.perf_counter()
    with patched((simple_test, "make_simple_test", make),
                 (SingleRoIExtractor, "__call__", record),
                 (test_det, "rescale_boxes", rescale),
                 (test_det, "run_inference", run),
                 (DetEvaluator, "evaluate", evaluate)), \
            batch_split() as (split, marks):
        metrics = test_det.main([config, str(work), "--eval", "bbox", "segm",
                                 "--out", str(out_json), "--cfg-options",
                                 *options])
    run_s = time.perf_counter() - t0
    n = len(marks) - 1
    launches = {"K1": dict(roi_align_ml.launches_by_size),
                "K2": dict(grad_launches_by_size),
                "K3": dict(single_mod.roi_align.launches_by_size),
                "K4": dict(single_mod.grad_launches_by_size)}
    by_path = dict(roi_align_ml.launches_by_path)
    log("evaluation path launches", json.dumps(
        {k: {str(s): c for s, c in v.items()} for k, v in launches.items()}),
        "by kernel path", json.dumps(by_path))
    check(n == EVAL_IMAGES // TRAIN_BATCH, f"{n} batches of 4")
    check(launches["K1"] == {7: n, 14: n}, "K1 twice a batch")
    check_vec8("K1 on the evaluation path", by_path, 2 * n)
    check(not (launches["K2"] or launches["K3"] or launches["K4"]),
          "no K2, K3 or K4 on the evaluation path")

    # the first batch's RoI features and class scores against the plain
    # RoIAlign
    compare = features_vs_plain(torch, seen, [7, 14],
                                lambda i: model[0].roi_head.bbox_head)
    log("evaluation batch vs plain RoIAlign", json.dumps(compare))
    captured = ([f.float() for f in seen[0][1][:4]], seen[0][2].clone(),
                seen[1][2].clone())
    seen.clear()

    # repair: boxes back to the image frame by a true float32 division;
    # the division by a Python float it replaced, on the same boxes
    by_float, coords = 0, 0
    for boxes, sf, got in rescaled:
        check(got.dtype == np.float32 and np.array_equal(got, boxes / sf),
              "rescaled boxes equal NumPy's true division")
        for b in range(boxes.shape[0]):
            old = (torch.from_numpy(boxes[b]).cuda()
                   / float(sf.reshape(-1)[b])).cpu().numpy()
            by_float += int((old != got[b]).sum())
            coords += old.size
    log("boxes divided by a Python float on the card differ from NumPy's "
        f"true division in {by_float} of {coords} coordinates")
    records = runs[0]
    first = records[0]
    b0 = rescaled[0][2][0]
    x1, y1, w, h = first["bbox"]
    check(any(list(row) == [x1, y1, x1 + w, y1 + h] for row in
              b0.astype(np.float64)), "records carry the rescaled boxes")
    check(json.loads(out_json.read_text()) == records,
          "results.json loads back as the records")

    # the val set's gt as detections: AP 1; the C++ and the plain
    # evaluator equal on this phase's results
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(options))
    ds = build_dataset({k: v for k, v in cfg.data["test"].items()})
    perfect = {}
    for iou_type in ("bbox", "segm"):
        res = test_det.build_evaluator(ds, cfg).evaluate(
            gt_as_detections(ds), iou_type)
        perfect[iou_type] = res
    members = {ds.cat_frequency[a["category_id"]] for rec in ds.img_infos
               for a in rec["anns"] if not a.get("iscrowd", 0)}
    log("gt as detections", json.dumps(perfect), "buckets with members",
        sorted(members))
    for iou_type, res in perfect.items():
        check(res["AP"] == 1.0, f"gt as detections: {iou_type} AP 1")
        for b in "rcf":
            check(res[f"AP{b}"] == 1.0 if b in members
                  else math.isnan(res[f"AP{b}"]),
                  f"gt as detections: {iou_type} AP{b}")
    t0 = time.perf_counter()
    plain = {m: test_det.build_evaluator(ds, cfg, native=False).evaluate(
        records, m) for m in ("bbox", "segm")}
    plain_s = time.perf_counter() - t0
    for m in ("bbox", "segm"):
        check(same_ap(metrics[m], plain[m]),
              f"{m} AP through C++ and plain Python equal")

    later = [(b - a) / TRAIN_BATCH for a, b in zip(marks[1:], marks[2:])]
    return {**summarize(split, marks, TRAIN_BATCH), "images": EVAL_IMAGES,
            "run_s": run_s, "s_per_image_after_first": spread(later),
            "evaluator_s": {f"{t}{'' if nat else '_plain'}": s
                            for t, nat, s in evals},
            "plain_evaluator_s": plain_s,
            "detections_per_image": len(records) / EVAL_IMAGES,
            "box_coords_off_by_float_division": [by_float, coords],
            "ap": {m: metrics[m] for m in ("bbox", "segm")},
            "launches": launches["K1"], "vs_plain": compare,
            "captured": captured}


OVERFIT_AP = 0.5                   # bbox and segm AP the overfit must reach


def overfit_phase(torch, np, tmp):
    """``iif_torch.tools.overfit``'s run in the process: the 8 seeded
    bright-squares PNGs and its MaskRCNN R50-FPN config (2 classes, no
    frozen stage, IIF ``raw``, 96x128 canvas, b4, SGD lr 0.01, EPOCHS
    epochs with the evaluation hook after the last), ``train_det`` then
    ``test_det`` (bbox, segm): both APs at least OVERFIT_AP, the hook's
    AP dicts equal to ``test_det``'s (same weights, same data), K1's and
    K2's launches from 0 over the training and the hook (all on
    ``vec8``), ms/step."""
    from iif_torch.cli import test_det, train_det
    import iif_torch.engine.detection as engine_mod
    from iif_torch.detection.roi_extractor import SingleRoIExtractor
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_path,
        grad_launches_by_size,
        reset_launches,
        roi_align_ml,
    )
    from iif_torch.tools.overfit import EPOCHS, write_config
    from iif_torch.tools.synthetic_lvis import write_synthetic_squares

    root = tmp / "squares"
    data = write_synthetic_squares(str(root))
    cfg = write_config(str(root), data, EPOCHS)
    work = str(root / "work")
    steps, hooks, captured = [], [], {}

    def timed_step(self, state, batch, _step=engine_mod.DetectionTrainer
                   .train_step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _step(self, state, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    def hook(*args, _run=train_det._run_eval, **kw):
        hooks.append(_run(*args, **kw))
        return hooks[-1]

    def capture(self, feats, rois, _extract=SingleRoIExtractor.__call__):
        out = _extract(self, feats, rois)
        o = self.output_size[0]
        if torch.is_grad_enabled() and o not in captured:
            captured[o] = ([f.detach().float() for f in feats[:4]],
                           rois.detach().clone())
        return out

    reset_launches()
    t0 = time.perf_counter()
    with patched((engine_mod.DetectionTrainer, "train_step", timed_step),
                 (train_det, "_run_eval", hook),
                 (SingleRoIExtractor, "__call__", capture)):
        _, state = train_det.main([cfg, "--work-dir", work])
    train_s = time.perf_counter() - t0
    launches = {"K1": dict(roi_align_ml.launches_by_size),
                "K2": dict(grad_launches_by_size)}
    by_path = {"K1": dict(roi_align_ml.launches_by_path),
               "K2": dict(grad_launches_by_path)}
    t0 = time.perf_counter()
    metrics = test_det.main([cfg, work, "--eval", "bbox", "segm"])
    test_s = time.perf_counter() - t0
    log("overfit path launches", json.dumps(launches), "by kernel path",
        json.dumps(by_path))
    n = len(steps)
    check(n == state.step == EPOCHS * 2, f"{EPOCHS} epochs of 2 steps: {n}")
    check(len(hooks) == 1, "the evaluation hook ran once")
    for m in ("bbox", "segm"):
        check(same_ap(hooks[0][m], metrics[m]),
              f"hook's {m} AP equal to test_det's")
        check(metrics[m]["AP"] >= OVERFIT_AP,
              f"overfit {m} AP {metrics[m]['AP']} >= {OVERFIT_AP}")
    # training: one K1 and one K2 launch a size a step; the hook's two
    # batches: one K1 launch a size each
    check(launches["K2"] == {7: n, 14: n}, "K2 once a size a step")
    check(launches["K1"] == {7: n + 2, 14: n + 2},
          "K1 once a size a step and a hook batch")
    check_vec8("K1 on the overfit path", by_path["K1"], 2 * (n + 2))
    check_vec8("K2 on the overfit path", by_path["K2"], 2 * n)
    return {"epochs": EPOCHS, "steps": n, "step_ms": spread(steps),
            "step_ms_after_first": spread(steps[1:]),
            "train_s": train_s, "test_s": test_s,
            "ap": {m: metrics[m] for m in ("bbox", "segm")},
            "hook_ap": hooks[0], "launches": launches,
            "captured": captured, "config": cfg, "work": work,
            "images": len(json.loads(open(data["ann_file"]).read())
                          ["images"])}


# --------------------------------------------------------- classification
CLS_CIFAR_EPOCHS = 3               # epochs of the CIFAR-100-LT phase
# Acc@1 of the JAX CLI on the CPU with the same flags, seeds and epochs
# (python -m iif_tpu.cli.train --dset_name synthetic --model resnet32
# --classif iif --iif raw --imb_factor 0.01 --cosine_scheduler --epochs 3;
# PERF.md): the card's run must reach at least half of it
CLS_CIFAR_JAX_ACC1 = 69.29
CLS_PROFILED_STEP = 40             # the CIFAR run's profiled step
LT_CLASSES = 1000
LT_POOL = 1024                     # seeded 256x256 PNGs the lists reuse
LT_STEPS = 4                       # b256 steps an epoch (the cut)
CONV_PARTS = ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "fprop",
              "implicit", "sm90")


def roi_launches_by_size():
    """K1-K4 launches counted since the wrappers' last reset, by output
    side (K3's and K4's outputs are square)."""
    import iif_torch.ops.roi_align as k34
    import iif_torch.ops.roi_align_ml as k12

    def by_side(counts):
        out = {}
        for (h, _), n in counts.items():
            out[h] = out.get(h, 0) + n
        return out

    return {"K1": dict(k12.roi_align_ml.launches_by_size),
            "K2": dict(k12.grad_launches_by_size),
            "K3": by_side(k34.roi_align.launches_by_size),
            "K4": by_side(k34.grad_launches_by_size)}


def roi_launches():
    """K1-K4 launches counted since the wrappers' last reset."""
    return {k: sum(v.values()) for k, v in roi_launches_by_size().items()}


def add_launches(a, b, sign=1):
    """``a`` plus (or with ``sign`` -1 less) ``b``, two
    ``roi_launches_by_size`` dicts."""
    return {k: {o: a[k].get(o, 0) + sign * b[k].get(o, 0)
                for o in set(a[k]) | set(b[k])} for k in a}


def reset_roi_launches():
    import iif_torch.ops.roi_align as k34
    import iif_torch.ops.roi_align_ml as k12

    k12.reset_launches()
    k34.reset_launches()


class ClsRecorder:
    """Wraps ``ClassificationTrainer``'s ``train_step`` (CUDA events
    around each step, its loss kept on the device; step ``profile_step``
    under torch.profiler, drained at its ends), ``train_one_epoch`` (host
    clock, drained), ``evaluate`` (host clock; its result kept) and the
    CLI's ``shot_acc`` (its Many / Median / Low kept)."""

    def __init__(self, torch, profile_step=None):
        self.torch = torch
        self.profile_step = profile_step
        self.steps, self.losses, self.epochs, self.evals = [], [], [], []
        self.shots = []
        self.profile = None

    def patches(self):
        from iif_torch.cli import train as cli
        from iif_torch.engine.classification import ClassificationTrainer

        torch, rec = self.torch, self
        step_fn = ClassificationTrainer.train_step
        epoch_fn = ClassificationTrainer.train_one_epoch
        eval_fn = ClassificationTrainer.evaluate

        def train_step(trainer, state, batch, mix=None, **kw):
            if len(rec.steps) == rec.profile_step:
                rec.profile, out = profile_cls_step(torch, step_fn, trainer,
                                                    state, batch, **kw)
                rec.steps.append(None)
                rec.losses.append(out[1]["loss"])
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(trainer, state, batch, mix, **kw)
            end.record()
            rec.steps.append((start, end))
            rec.losses.append(out[1]["loss"])
            return out

        def train_one_epoch(trainer, state, loader, epoch, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = epoch_fn(trainer, state, loader, epoch, **kw)
            torch.cuda.synchronize()
            rec.epochs.append((time.perf_counter() - t0,
                               len(loader) * loader.batch_size))
            return out

        def evaluate(trainer, batches, print_fn=print, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eval_fn(trainer, batches, print_fn, **kw)
            rec.evals.append((time.perf_counter() - t0, res))
            return res

        def shot_acc(*args, _fn=cli.shot_acc, **kw):
            rec.shots.append(_fn(*args, **kw))
            return rec.shots[-1]

        return [(ClassificationTrainer, "train_step", train_step),
                (ClassificationTrainer, "train_one_epoch", train_one_epoch),
                (ClassificationTrainer, "evaluate", evaluate),
                (cli, "shot_acc", shot_acc)]

    def summary(self):
        """ms/step (device timeline, CUDA events; the first and the
        profiled step apart), img/s over each epoch and each evaluation,
        the losses (all finite)."""
        steps = [a.elapsed_time(b) for a, b in
                 (s for s in self.steps if s is not None)]
        losses = [float(v) for v in self.torch.stack(self.losses).tolist()]
        check(all(math.isfinite(v) for v in losses),
              "every training loss finite")
        return {
            "steps": len(self.steps), "first_step_ms": steps[0],
            "step_ms": spread(steps[1:]),
            "epoch_img_per_s": [n / t for t, n in self.epochs],
            "epoch_s": [t for t, _ in self.epochs],
            "eval_img_per_s": [r["count"] / t for t, r in self.evals],
            "loss_first_last": [losses[0], losses[-1]],
            "profile": self.profile}


def profile_cls_step(torch, step_fn, trainer, state, batch, **kw):
    """One training step under torch.profiler, drained at its ends: the
    device's busy share of the step's wall time, the kernel time of the
    convolutions and matmuls against the rest, the device's busy time
    inside the ``augment`` span, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(trainer, state, batch, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False))
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in kernels:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (hi - lo) / 1e3, c + 1)
    conv = sum(t for k, (t, _) in by_name.items()
               if any(p in k.lower() for p in CONV_PARTS))
    total = sum(t for t, _ in by_name.values())
    aug_windows, aug_wall, aug_busy = busy_in_spans(prof, "augment")
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
            "augment_span": {"windows": aug_windows, "wall_ms": aug_wall,
                             "device_busy_ms": aug_busy},
            "device_busy_share": busy / 1e3 / wall,
            "kernel_ms": total, "conv_gemm_kernel_ms": conv,
            "other_kernel_ms": total - conv,
            "kernel_launches": sum(c for _, c in by_name.values()),
            "top_kernels": [(k[:80], t, c) for k, (t, c) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:10]]}, out


def run_cls_cli(torch, argv, rec):
    """``python -m iif_torch.cli.train`` in the process with ``rec``'s
    patches; returns its value and the peak device memory (GiB)."""
    from iif_torch.cli import train as cli

    torch.cuda.reset_peak_memory_stats()
    with patched(*rec.patches()):
        value = cli.main(cli.get_args_parser().parse_args(argv))
    return value, torch.cuda.max_memory_allocated() / 2 ** 30


def classification_cifar_phase(torch, np, tmp):
    """The README's classification command on the synthetic CIFAR-100-LT
    stand-in (100 classes, 10,847 training images after the imbalance,
    10,000 to evaluate), ResNet-32, IIF raw, cosine schedule, the CLI's
    default batch (32), bf16, CLS_CIFAR_EPOCHS epochs; then ``--test-only
    --load_from`` on its checkpoints. Checks: every loss finite, Acc@1 at
    least half the JAX CLI's on the CPU, ``--test-only`` reproducing the
    last epoch's Acc@1 exactly, no K1-K4 launch."""
    out = str(tmp / "cls_cifar")
    base = ["--dset_name", "synthetic", "--model", "resnet32", "--classif",
            "iif", "--iif", "raw", "--imb_factor", "0.01"]
    reset_roi_launches()
    rec = ClsRecorder(torch, CLS_PROFILED_STEP)
    t0 = time.perf_counter()
    best, peak = run_cls_cli(torch, base + [
        "--cosine_scheduler", "--epochs", str(CLS_CIFAR_EPOCHS),
        "--output-dir", out, "--print-freq", "100"], rec)
    train_s = time.perf_counter() - t0
    last = rec.evals[-1][1]
    test = ClsRecorder(torch)
    t0 = time.perf_counter()
    acc, _ = run_cls_cli(torch, base + [
        "--test-only", "--load_from", str(Path(out) / "checkpoints"),
        "--output-dir", str(tmp / "cls_cifar_test")], test)
    test_s = time.perf_counter() - t0
    res = test.evals[0][1]
    launches = roi_launches()
    summary = rec.summary()
    log("classification CIFAR-100-LT Acc@1 by epoch",
        [r["acc1"] for _, r in rec.evals])
    check(acc == last["acc1"],
          f"--test-only Acc@1 {acc} equal to training's last {last['acc1']}")
    check(last["acc1"] >= 0.5 * CLS_CIFAR_JAX_ACC1,
          f"Acc@1 {last['acc1']} >= half the JAX CLI's {CLS_CIFAR_JAX_ACC1}")
    check(not any(launches.values()), f"no K1-K4 launch: {launches}")
    check(rec.epochs[0][1] == 10847 // 32 * 32 and res["count"] == 10000,
          "10,847 training images in b32 steps, 10,000 to evaluate")
    return {"epochs": CLS_CIFAR_EPOCHS, "batch": 32, **summary,
            "acc1": last["acc1"], "acc5": last["acc5"], "best_acc1": best,
            "test_only_acc1": acc, "many_median_low": test.shots[0],
            "test_eval_img_per_s": res["count"] / test.evals[0][0],
            "train_s": train_s, "test_s": test_s, "peak_gib": peak,
            "launches": launches}


def write_lt_lists(np, root):
    """LT_POOL seeded 256x256 PNGs under ``root/pool`` and ImageNet-LT
    format lists: the train list with LT_CLASSES classes of counts from
    the exp profile 1280 -> 5 (ImageNet-LT's largest and smallest), each
    line a pool image; the eval list one image a class."""
    from iif_torch.detection.image_io import write_png

    rng = np.random.RandomState(12)
    os.makedirs(root / "pool", exist_ok=True)
    for i in range(LT_POOL):
        base = rng.randint(0, 256, 3)
        img = (base[None, None, :] + rng.randint(-40, 41, (256, 256, 3)))
        write_png(str(root / "pool" / f"{i}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))
    c = np.arange(LT_CLASSES)
    counts = np.round(1280.0 * (5.0 / 1280.0) ** (c / (LT_CLASSES - 1.0))
                      ).astype(int)
    labels = np.repeat(c, counts)
    with open(root / "ImageNet_LT_train.txt", "w") as f:
        f.writelines(f"pool/{i % LT_POOL}.png {y}\n"
                     for i, y in enumerate(labels))
    with open(root / "ImageNet_LT_test.txt", "w") as f:
        f.writelines(f"pool/{(7 * y) % LT_POOL}.png {y}\n" for y in c)
    return counts


def classification_lt_phase(torch, np, tmp):
    """The north-star recipe's three calls (``scripts/repro_imagenet_lt.
    sh``) with its flags on ImageNet-LT-shaped seeded data
    (``write_lt_lists``): stage 1 ``se_resnet50 -b 256 --bn-groups 4 --lr
    0.2 --cosine_scheduler --classif_norm cosine --mixup 0.2 --auto-augment
    imagenet``, stage 2 ``--classif iif --iif smooth --decoup --lr 0.00002
    --auto-augment imagenet --load_from`` stage 1, the post-hoc
    ``--classif iif --iif smooth --test-only``, and the same checkpoint's
    plain CE evaluation; each epoch cut to LT_STEPS b256 steps. Checks:
    every loss finite, stage 2 leaves the trunk's parameters equal bit for
    bit and moves the head and the BN running statistics, the post
    evaluation's predictions differ from the plain CE ones, an ImageNet
    sub-policy drawn each step (logged), no K1-K4 launch."""
    from iif_torch.data import autoaugment
    from iif_torch.data.loader import Loader

    root = tmp / "lt"
    t0 = time.perf_counter()
    counts = write_lt_lists(np, root)
    data_s = time.perf_counter() - t0
    base = ["--dset_name", "imagenet_lt", "--data-path", str(root),
            "--train-txt", str(root / "ImageNet_LT_train.txt"),
            "--eval-txt", str(root / "ImageNet_LT_test.txt"),
            "--model", "se_resnet50", "-b", "256", "--classif_norm",
            "cosine", "--seed", "0", "--print-freq", "1"]
    s1, s2 = root / "stage1", root / "stage2"
    real_len = Loader.__len__
    reset_roi_launches()
    recs, peaks = {}, {}
    drawn = []                      # the sub-policy of each step
    draw_fn = autoaugment.draw_policy

    def draw_policy(*a, **kw):
        out = draw_fn(*a, **kw)
        drawn.append(out["index"])
        return out

    with patched((Loader, "__len__",
                  lambda self: min(real_len(self), LT_STEPS)),
                 (autoaugment, "draw_policy", draw_policy)):
        recs["stage1"] = ClsRecorder(torch, profile_step=2)
        _, peaks["stage1"] = run_cls_cli(torch, base + [
            "--output-dir", str(s1), "--bn-groups", "4", "--lr", "0.2",
            "--epochs", "1", "--cosine_scheduler", "--reduction", "mean",
            "--mixup", "0.2", "--auto-augment", "imagenet", "--momentum",
            "0.9", "--wd", "1e-4"], recs["stage1"])
        recs["stage2"] = ClsRecorder(torch)
        _, peaks["stage2"] = run_cls_cli(torch, base + [
            "--output-dir", str(s2), "--bn-groups", "4", "--lr", "0.00002",
            "--epochs", "1", "--reduction", "mean", "--mixup", "0.2",
            "--auto-augment", "imagenet", "--load_from",
            str(s1 / "checkpoints"), "--classif", "iif", "--decoup",
            "--iif", "smooth"], recs["stage2"])
    recs["post"] = ClsRecorder(torch)
    post_acc, peaks["post"] = run_cls_cli(torch, base + [
        "--output-dir", str(root / "post"), "--load_from",
        str(s1 / "checkpoints"), "--classif", "iif", "--iif", "smooth",
        "--test-only", "--record-result"], recs["post"])
    recs["plain"] = ClsRecorder(torch)
    plain_acc, _ = run_cls_cli(torch, base + [
        "--output-dir", str(root / "plain"), "--load_from",
        str(s1 / "checkpoints"), "--test-only"], recs["plain"])
    launches = roi_launches()
    one = torch.load(s1 / "checkpoints" / "latest.pth",
                     weights_only=True)["state_dict"]
    two = torch.load(s2 / "checkpoints" / "latest.pth",
                     weights_only=True)["state_dict"]
    trunk = [k for k in one if not k.startswith("fc.")
             and "running" not in k and "num_batches" not in k]
    check(all(torch.equal(one[k], two[k]) for k in trunk),
          "stage 2 leaves every trunk parameter equal bit for bit")
    check(not torch.equal(one["fc.weight"], two["fc.weight"]),
          "stage 2 moves the head")
    check(any(not torch.equal(one[k], two[k]) for k in one
              if "running" in k), "stage 2 moves the BN running statistics")
    post = recs["post"].evals[0][1]
    plain = recs["plain"].evals[0][1]
    changed = int((post["preds"] != plain["preds"]).sum())
    check(changed > 0, "the post-hoc IIF evaluation's predictions differ "
          "from the plain CE evaluation's")
    check(not any(launches.values()), f"no K1-K4 launch: {launches}")
    check(len(drawn) == 2 * LT_STEPS, f"an ImageNet sub-policy drawn each "
          f"step of both stages: {drawn}")
    log("ImageNet policy sub-policy by step, stage 1 then 2", drawn)
    stages = {k: recs[k].summary() for k in ("stage1", "stage2")}
    return {"train_images": int(counts.sum()), "counts_max_min":
            [int(counts.max()), int(counts.min())], "pool": LT_POOL,
            "steps_an_epoch": LT_STEPS, "data_s": data_s, **stages,
            "post_acc1": post_acc, "plain_acc1": plain_acc,
            "post_many_median_low": recs["post"].shots[0],
            "post_eval_img_per_s": post["count"] / recs["post"].evals[0][0],
            "predictions_changed_by_iif": changed, "peak_gib": peaks,
            "trunk_tensors_equal": len(trunk), "sub_policies": drawn,
            "launches": launches}


# ------------------------------------------------- augmentation policies
CARD = "cuda"                      # the new phases' device
AUG_SIZES = ((256, 224), (128, 32))  # (batch, side): ImageNet-LT, CIFAR
AUG_LEVELS = (0, 4, 9)
AUG_TIMED = 20                     # batches timed for each policy
AUG_TOL = 2e-6                     # card against CPU where sums reorder
# the ops whose card output equals the CPU's bit for bit: elementwise in
# one order, integer grids, exact min / max
AUG_EXACT = ("color", "posterize", "solarize", "brightness", "autocontrast",
             "equalize", "invert", "identity")
# a composition (a policy, a branch, a pipeline): a warp's source point on
# the edge of the image within rounding turns a pixel grey on one device
# only, and a truncation to the 256-level grid (equalize, posterize) can
# land one level apart; each such element is counted, and their shares
# held below these
AUG_COMPOSED_OVER_TOL = 1e-3
AUG_COMPOSED_OVER_GREY = 1e-4


def aug_images(torch, np, b, side, seed):
    """A seeded (b, side, side, 3) uint8 batch on the card and its floats
    in [0, 1] (k / 255)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (b, 1, 1, 3))
    u8 = np.clip(base + rng.randint(-60, 61, (b, side, side, 3)), 0, 255)
    u8 = torch.from_numpy(u8.astype(np.uint8)).to(CARD)
    from iif_torch.data.augment import to_float

    return u8, to_float(u8)


def aug_error(torch, got, want, mask=None):
    """max |card - CPU| over the pixels outside ``mask`` (B, H, W), the
    pixels in ``mask`` that differ by more than AUG_TOL (``excluded``),
    and the elements beyond AUG_TOL and beyond one grey level."""
    d = (got.detach().cpu().float() - want.float()).abs()
    excluded = 0
    if mask is not None:
        mask = mask.cpu()
        excluded = int(((d > AUG_TOL).any(-1) & mask).sum())
        d = torch.where(mask[..., None], torch.zeros_like(d), d)
    return {"max_abs_err": float(d.max()), "over_tol": int((d > AUG_TOL)
                                                           .sum()),
            "over_grey": int((d > 1 / 255 + AUG_TOL).sum()),
            "excluded": excluded, "elements": d.numel()}


def to_cpu(torch, draw):
    """A draw (nested dicts and lists of tensors) on the CPU."""
    if isinstance(draw, dict):
        return {k: to_cpu(torch, v) for k, v in draw.items()}
    if isinstance(draw, list):
        return [to_cpu(torch, v) for v in draw]
    return draw.cpu() if isinstance(draw, torch.Tensor) else draw


def hold_composed(torch, what, got, want):
    err = aug_error(torch, got, want)
    check(err["over_tol"] <= AUG_COMPOSED_OVER_TOL * err["elements"]
          and err["over_grey"] <= AUG_COMPOSED_OVER_GREY * err["elements"],
          f"{what}: card equals CPU but for {err['over_tol']} of "
          f"{err['elements']} elements ({err['over_grey']} past a grey "
          "level)")
    return err


def augmentation_phase(torch, np):
    """Every op of ``autoaugment.OPS`` at levels 0, 4 and 9, one drawn
    sub-policy of each policy, RandAugment, each OneOf branch, cutout and
    random erasing, on a b256 224x224 and a b128 32x32 batch on the card,
    each held against the same function on the CPU on the same draws:
    AUG_EXACT equal, the other ops within AUG_TOL (a warp outside the
    pixels whose source point lies within 1e-4 of the image's edge,
    counted), compositions within the shares above. Then ms a batch
    (draw and apply, CUDA events, AUG_TIMED batches each with the
    host's choice of that step) for each policy at both sizes. No K1-K4
    launch."""
    from iif_torch.data import augment as A
    from iif_torch.data import autoaugment as P
    from iif_torch.data import branch_augment as BA

    reset_roi_launches()
    out = {}
    for b, side in AUG_SIZES:
        u8, x = aug_images(torch, np, b, side, seed=side)
        xc = x.cpu()
        gen = torch.Generator(device=CARD).manual_seed(side)
        ops = {}
        for name, op in P.OPS.items():
            for level in AUG_LEVELS:
                sign = P.draw_signs(gen, b, CARD)
                got = op(x, level, sign)
                want = op(xc, level, sign.cpu())
                mask = None
                if name in P.WARPS:
                    mask = P.near_boundary(P.warp_matrix(
                        name, side, side, level, sign), side, side)
                err = aug_error(torch, got, want, mask)
                exact = name in AUG_EXACT
                check(err["max_abs_err"] <= (0.0 if exact else AUG_TOL),
                      f"{name} level {level} at b{b} {side}: card "
                      f"{'equal to' if exact else 'within ' + str(AUG_TOL)}"
                      f" the CPU ({err['max_abs_err']})")
                ops.setdefault(name, []).append(err)
        composed = {}
        for key, policy in P.POLICIES.items():
            draw = P.draw_policy(gen, b, policy, CARD)
            composed[f"policy_{key}"] = dict(
                index=draw["index"], **hold_composed(
                    torch, f"{key} policy sub-policy {draw['index']}",
                    P.apply_policy(x, draw, policy),
                    P.apply_policy(xc, to_cpu(torch, draw), policy)))
        draw = P.draw_randaugment(gen, b, CARD)
        composed["randaugment"] = dict(
            ops=[P.RANDAUG_OPS[d["index"]] for d in draw["ops"]],
            **hold_composed(torch, "randaugment", P.randaugment(x, draw),
                            P.randaugment(xc, to_cpu(torch, draw))))
        for i in range(BA.N_BRANCHES):
            draw = BA.draw_one_of(gen, b, side, side, CARD, index=i)
            composed[f"oneof_{i}"] = hold_composed(
                torch, f"OneOf branch {i}", BA.one_of_augment(x, draw),
                BA.one_of_augment(xc, to_cpu(torch, draw)))
        draw = A.draw_cutout(gen, b, side, side, CARD)
        composed["cutout"] = hold_composed(
            torch, "cutout", A.cutout(x, draw, 16),
            A.cutout(xc, to_cpu(torch, draw), 16))
        draw = A.draw_random_erasing(gen, x.shape, x.dtype, CARD, 0.5)
        composed["random_erasing"] = hold_composed(
            torch, "random erasing", A.random_erasing(x, draw),
            A.random_erasing(xc, to_cpu(torch, draw)))
        ms = {}
        for key in ("cifar", "imagenet", "randaugment", "oneof", "jitter"):
            def one(step, key=key):
                g = torch.Generator(device=CARD).manual_seed(
                    (7 << 32) | step)
                if key == "randaugment":
                    return P.randaugment(x, P.draw_randaugment(g, b, CARD))
                if key == "oneof":
                    return BA.one_of_augment(x, BA.draw_one_of(
                        g, b, side, side, CARD))
                if key == "jitter":
                    return A.color_jitter(x, A.draw_color_jitter(
                        g, b, CARD))
                pol = P.POLICIES[key]
                return P.apply_policy(x, P.draw_policy(g, b, pol, CARD),
                                      pol)

            one(0)
            times = []
            for step in range(1, AUG_TIMED + 1):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                one(step)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms[key] = spread(times)
        out[f"b{b}_{side}"] = {
            "ops_max_abs_err_by_level": {
                k: [e["max_abs_err"] for e in v] for k, v in ops.items()},
            "warp_pixels_excluded": sum(e["excluded"] for v in ops.values()
                                        for e in v),
            "composed_max_abs_err_over_tol_over_grey": {
                k: [v["max_abs_err"], v["over_tol"], v["over_grey"]]
                + ([v["index"]] if "index" in v else v.get("ops", []))
                for k, v in composed.items()},
            "elements": x.numel(),
            "ms_a_batch": {k: {"median": v["median"], "min": v["min"],
                               "max": v["max"]} for k, v in ms.items()}}
    launches = roi_launches()
    check(not any(launches.values()), f"no K1-K4 launch: {launches}")
    out["launches"] = launches
    return out


# ------------------------------------------------- classifier families
FAMILIES = ("resnet18", "resnet34", "resnext50_32x4d", "resnext101_32x8d",
            "wide_resnet50_2", "wide_resnet101_2", "se_resnext50_32x4d")
FAMILY_BATCH = 64
FAMILY_STEPS = 3                   # timed steps after the first


def family_phase(torch, np):
    """One b64 bf16 SGD step of each classifier the port added, at full
    depth and width, 224x224, 1000 classes, through
    ``ClassificationTrainer`` (the ImageNet augmentation, CE) from seeded
    fresh weights, then FAMILY_STEPS timed steps: every loss finite,
    every parameter that got a gradient moved; ms/step (CUDA events) and
    peak memory. No K1-K4 launch."""
    from iif_torch.data import augment as A
    from iif_torch.data.lt_dataset import IMAGENET_MEAN, IMAGENET_STD
    from iif_torch.engine.classification import ClassificationTrainer
    from iif_torch.losses import get_criterion
    from iif_torch.models.factory import build_classifier
    from iif_torch.models.init import classifier_fresh_init_

    reset_roi_launches()
    rng = np.random.RandomState(3)
    batch = {"image": rng.randint(0, 256, (FAMILY_BATCH, 224, 224, 3))
             .astype(np.uint8),
             "label": rng.randint(0, 1000, FAMILY_BATCH).astype(np.int64)}

    def aug(g, x):
        b, h, w, _ = x.shape
        return A.imagenet_train_augment(
            x, A.draw_imagenet(g, b, h, w, x.device), IMAGENET_MEAN,
            IMAGENET_STD)

    out = {}
    for name in FAMILIES:
        model = build_classifier(name, 1000, compute_dtype=torch.bfloat16)
        classifier_fresh_init_(model, torch.Generator().manual_seed(0))
        torch.cuda.reset_peak_memory_stats()
        trainer = ClassificationTrainer(
            model, get_criterion("ce", [1] * 1000), lambda s: 0.1, aug,
            None, 1000, compute_dtype=torch.bfloat16, device=CARD)
        state = trainer.init_state()
        before = {k: v.detach().clone() for k, v in
                  trainer.model.named_parameters()}
        losses, times = [], []
        for step in range(FAMILY_STEPS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = trainer.train_step(state, batch)
            end.record()
            losses.append(m["loss"])
            times.append((start, end))
        torch.cuda.synchronize()
        losses = [float(v) for v in torch.stack(losses).tolist()]
        check(all(math.isfinite(v) for v in losses),
              f"{name}: every loss finite {losses}")
        moved = [k for k, p in trainer.model.named_parameters()
                 if not torch.equal(p.detach(), before[k])]
        n_params = len(before)
        check(len(moved) == n_params,
              f"{name}: every parameter moved ({len(moved)} of {n_params})")
        ms = [a.elapsed_time(b) for a, b in times]
        out[name] = {"params_m": sum(p.numel() for p in before.values())
                     / 1e6, "first_step_ms": ms[0],
                     "step_ms": spread(ms[1:]), "img_per_s": FAMILY_BATCH
                     / statistics.median(ms[1:]) * 1e3,
                     "loss_first_last": [losses[0], losses[-1]],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del trainer, model, state, before
        torch.cuda.empty_cache()
    launches = roi_launches()
    check(not any(launches.values()), f"no K1-K4 launch: {launches}")
    out["launches"] = launches
    return out


# ------------------------------------------------------------------ QAT
QAT_EPOCHS = 3


def qat_phase(torch, np, root):
    """``BASELINE.json`` configs[3]'s shape: ``python -m iif_torch.cli.
    train_quantization --dset_name imagenet_lt --model resnet50 -b 256
    --epochs 3 --qat-freeze-bn 1 --qat-freeze-observer 2`` in the process
    on phase 12's seeded ImageNet-LT lists under ``root``, each epoch cut
    to LT_STEPS steps; then ``--post-training-quantize --load_from`` its
    checkpoint. Checks: the scales frozen at epoch 2 equal
    ``observe_scales`` of the weights at that moment, bit for bit; every
    BatchNorm buffer is bit-equal across every step from epoch 1 on;
    ``dequantize_tree(quantize_tree(p))`` equals ``fake_quant_params(p)``
    bit for bit; ``evaluate_quantized``'s Acc@1 and predictions equal
    ``evaluate``'s on a copy of the model holding the dequantized
    weights; the post-training run prints its Acc@1; every loss finite;
    no K1-K4 launch."""
    import copy
    import io

    from iif_torch.cli import train_quantization as tq
    from iif_torch.data.loader import Loader, eval_batches
    from iif_torch.engine.classification import ClassificationTrainer
    from iif_torch.quant import (
        dequantize_tree,
        fake_quant_params,
        observe_scales,
        quantize_tree,
    )

    base = ["--dset_name", "imagenet_lt", "--data-path", str(root),
            "--train-txt", str(root / "ImageNet_LT_train.txt"),
            "--eval-txt", str(root / "ImageNet_LT_test.txt"),
            "--model", "resnet50", "-b", "256", "--print-freq", "1"]
    seen = {"trainer": None, "epochs": [], "bn_equal": [], "scales": None}
    fns = {}

    def bn_buffers(model):
        return [b.detach().clone() for n, b in model.named_buffers()
                if "running" in n or "num_batches" in n]

    def train_one_epoch(trainer, state, loader, epoch, **kw):
        seen["trainer"] = trainer
        seen["epochs"].append(epoch)
        if epoch == trainer.qat.freeze_observer_epoch:
            with torch.no_grad():
                seen["scales"] = observe_scales(trainer.model)
        seen["epoch"] = epoch
        seen["bn"] = bn_buffers(trainer.model)
        out = fns["epoch"](trainer, state, loader, epoch, **kw)
        if epoch == trainer.qat.freeze_observer_epoch:
            seen["frozen"] = {k: v.clone() for k, v in
                              trainer.frozen_scales.items()}
        return out

    def train_step(trainer, state, batch, mix=None, **kw):
        out = fns["step"](trainer, state, batch, mix, **kw)
        if seen["epoch"] >= trainer.qat.freeze_bn_epoch:
            now = bn_buffers(trainer.model)
            seen["bn_equal"].append(all(
                torch.equal(a, b) for a, b in zip(seen["bn"], now)))
        return out

    rec = ClsRecorder(torch, profile_step=None)
    real_len = Loader.__len__
    reset_roi_launches()
    work = root / "qat"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched((Loader, "__len__",
                  lambda self: min(real_len(self), LT_STEPS)),
                 *rec.patches()):
        # around the recorder's own wrappers
        fns["epoch"] = ClassificationTrainer.train_one_epoch
        fns["step"] = ClassificationTrainer.train_step
        with patched((ClassificationTrainer, "train_one_epoch",
                      train_one_epoch),
                     (ClassificationTrainer, "train_step", train_step)):
            args = tq.get_args_parser().parse_args(base + [
                "--output-dir", str(work), "--epochs", str(QAT_EPOCHS),
                "--qat-freeze-bn", "1", "--qat-freeze-observer", "2"])
            best = tq.main(args)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer = seen["trainer"]
    check(seen["epochs"] == list(range(QAT_EPOCHS)),
          f"QAT trained epochs {seen['epochs']}")
    check(seen["scales"] is not None and set(seen["scales"]) == set(
        seen["frozen"]) and all(torch.equal(seen["scales"][k],
                                            seen["frozen"][k])
                                for k in seen["scales"]),
          f"the {len(seen['frozen'])} scales frozen at epoch 2 equal "
          "observe_scales of the weights then")
    check(len(seen["bn_equal"]) == (QAT_EPOCHS - 1) * LT_STEPS
          and all(seen["bn_equal"]),
          f"every BN buffer bit-equal over the {len(seen['bn_equal'])} "
          "steps from epoch 1 on")
    model, frozen = trainer.model, trainer.frozen_scales
    with torch.no_grad():
        q, s = quantize_tree(model, scales=frozen)
        deq = dequantize_tree(model, q, s)
        fq = fake_quant_params(model, scales=frozen)
    int8 = [k for k, v in q.items() if v.dtype == torch.int8]
    check(len(int8) == len(frozen) and all(torch.equal(deq[k], fq[k])
                                           for k in fq),
          f"dequantize_tree(quantize_tree(p)) equals fake_quant_params(p) "
          f"bit for bit ({len(int8)} int8 weights)")
    from iif_torch.cli import train as cli

    d = cli.build_data(args)

    def batches():
        return eval_batches(d["eval_data"], d["eval_targets"], 256)

    res_q = trainer.evaluate_quantized(batches())
    copy_model = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in copy_model.named_parameters():
            p.copy_(deq[k])
    with patched((trainer, "model", copy_model)):
        res_d = trainer.evaluate(batches())
    check(res_q["acc1"] == res_d["acc1"] and np.array_equal(
        res_q["preds"], res_d["preds"]),
        f"evaluate_quantized Acc@1 {res_q['acc1']} equals evaluate on the "
        f"dequantized model {res_d['acc1']}, every prediction")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ptq_acc = tq.main(tq.get_args_parser().parse_args(base + [
            "--output-dir", str(root / "ptq"), "--post-training-quantize",
            "--load_from", str(work / "checkpoints")]))
    ptq_s = time.perf_counter() - t0
    printed = [ln for ln in buf.getvalue().splitlines() if "Acc@1" in ln]
    sys.stdout.write(buf.getvalue()[-2000:])
    check(len(printed) == 1 and f"{ptq_acc:.3f}" in printed[0],
          f"--post-training-quantize prints its Acc@1 {ptq_acc}")
    launches = roi_launches()
    check(not any(launches.values()), f"no K1-K4 launch: {launches}")
    return {"epochs": QAT_EPOCHS, "steps_an_epoch": LT_STEPS,
            **rec.summary(), "best_acc1": best,
            "quantized_weights": len(int8),
            "evaluate_quantized_acc1": res_q["acc1"],
            "dequantized_acc1": res_d["acc1"], "ptq_acc1": ptq_acc,
            "ptq_printed": printed[0], "ptq_s": ptq_s, "train_s": train_s,
            "peak_gib": peak, "launches": launches}


# ------------------------------------------------------------ FASA + IIF
CASCADE_CONFIG = "configs/fasa/fasa_iif_cascade_r101_rfs_cos_norm_2x.py"
FASA_R50_CONFIG = "configs/fasa/fasa_iif_r50_rfs_cos_norm_2x.py"
CASCADE_REQUESTS = 20              # b1 requests; b2: half as many batches
CASCADE_TIMED = 5                  # timed steps at epoch 0 and at epoch 1
CASCADE_CLIP = 35.0                # optimizer_config.grad_clip.max_norm
FASA_CLI_IMAGES = 8                # train and val PNGs of the CLI phase
FASA_CLI_STEPS = 2                 # --max-steps: b4 steps an epoch
FASA_R50_STEPS = 3                 # timed epoch-1 steps after a warm-up
CASCADE_STAGES = ("backbone_fpn", "rpn") + tuple(
    f"stage{i}_{part}" for i in range(3)
    for part in ("bbox_roi_align", "bbox_head")) + (
    "bbox_nms", "mask_roi_align", "mask_head")
CASCADE_TRAIN_STAGES = ("backbone_fpn", "rpn_loss", "rpn_proposals") + tuple(
    f"stage{i}_{part}" for i in range(3)
    for part in ("targets", "bbox_roi_align", "bbox_head_loss", "fasa",
                 "mask_loss")) + ("backward", "optimizer")


def lvis_cfg(np, config, split):
    """``config`` with its ``split`` set on the seeded 1203-class LVIS
    annotations; returns the config and the classes' counts."""
    from iif_torch.config import Config

    cfg = Config.fromfile(str(REPO / config))
    ann = BUILD / "lvis_v1_synthetic.json"
    counts = write_lvis_annotations(np, ann)
    cfg.data[split]["ann_file"] = str(ann)
    return cfg, counts


def cascade_serving_phase(torch, np):
    """The FASA cascade config as it stands (R101-FPN, bf16 trunk, 1203
    classes, normed heads, class-specific regressors, the 0.33 stage stds,
    ``score_thr=1e-4``, ``nms_iou=0.3``, 300 detections) through
    ``init_detector``, its weights from ``fresh_init_`` (seeded):
    ``staged_serving`` with CASCADE_REQUESTS b1 requests on the 800x1344
    canvas."""
    from iif_torch.detection.cascade import (
        CascadeMaskRCNN,
        cascade_simple_test,
    )
    from iif_torch.detection.inference import init_detector
    from iif_torch.detection.init import fresh_init_
    from iif_torch.detection.losses import DetIIFLoss

    cfg, _ = lvis_cfg(np, CASCADE_CONFIG, "test")
    t0 = time.time()
    det = init_detector(cfg, device="cuda")
    fresh_init_(det.model, torch.Generator().manual_seed(0))
    log(f"cascade init_detector + fresh_init_ s {time.time() - t0:.3f}")
    m, tc = det.model, det.test_cfg
    check(isinstance(m, CascadeMaskRCNN) and m.num_stages == 3,
          "a three-stage cascade")
    check(m.num_classes == NUM_CLASSES and len(m.backbone.layer3) == 23
          and m.backbone.compute_dtype == torch.bfloat16,
          "R101, 1203 classes, bf16 trunk")
    check(m.stage_stds[2] == (0.33, 0.33, 0.067, 0.067)
          and not m.reg_class_agnostic
          and m.roi_head.bbox_head[0].fc_reg.out_features == 4 * NUM_CLASSES,
          "stage stds and class-specific regressors")
    check(type(m.roi_head.bbox_head[2].fc_cls).__name__ == "NormedLinear"
          and m.roi_head.mask_head[2].predictor == "normed",
          "normed heads")
    check(isinstance(det.loss_cls, DetIIFLoss), "IIF loss")
    check((tc.score_thr, tc.nms_iou, tc.max_per_img) == (1e-4, 0.3, 300),
          "test_cfg 1e-4, 0.3, 300")
    return staged_serving(torch, np, det, "cascade", cascade_simple_test,
                          CASCADE_REQUESTS)


def staged_serving(torch, np, det, label, simple_test, requests):
    """A three-stage detector served as the cascade and HTC phases serve
    it: ``requests`` b1 requests and half as many b2 batches
    (``served_launches``, NMS host syncs counted), K1 three 7x7 and one
    14x14 a forward on each path (all on ``vec8``, no K2-K4), 300 finite
    detections; each served
    image's stage RoI features and class scores against the plain
    RoIAlign; K1 against its plain version on each stage's RoIs and on
    the detections of the last image (f32 and bf16, ``k1_row``); the
    masks of a b2 forward finite and in [0, 1]."""
    from iif_torch.detection.inference import inference_detector

    m = det.model
    _, images = serving_images(np)
    ms, by_size, paths, results, syncs = served_launches(
        torch, det, images, requests)
    launches = {p: c["K1"] for p, c in by_size.items()}
    for path, n in (("b1", requests), ("b2", requests // 2)):
        check(launches[path] == {7: 3 * n, 14: n},
              f"K1 three 7x7 and one 14x14 a forward on {path}: "
              f"{launches[path]}")
        check(not any(by_size[path][k] for k in ("K2", "K3", "K4")),
              f"no K2, K3 or K4 on the {label} {path} path")
        check_vec8(f"K1 on the {label} {path} path", paths[path], 4 * n)
    log(f"{label} serving launches", json.dumps(launches))
    for res in results:
        check(res["boxes"].shape == (300, 4) and res["valid"].any(),
              "300 detections, some valid")
        for k, v in res.items():
            check(np.isfinite(v.astype(np.float64)).all(), f"finite {k}")
    compare, seen = {}, []
    for j, image in enumerate(images):
        seen.clear()
        with patched(capture_extractor(seen)):
            inference_detector(det, image, masks=False)
        compare[f"image{j}"] = features_vs_plain(
            torch, seen, [7, 7, 7, 14], lambda i: m.roi_head.bbox_head[i])
    log(f"{label} requests vs plain RoIAlign", json.dumps(compare))
    k1 = {}
    for i, (o, nhwc, rois, _) in enumerate(seen):
        feats32 = [f.float() for f in nhwc]
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, feats32, rois, o, dt)
            check(row["path"] == "vec8", f"K1 takes vec8 on {label} RoIs")
            k1[(f"stage{i}" if o == 7 else "mask", row["dtype"])] = row
    sample = det.pipeline(images[1], det.device)
    out = simple_test(m, sample["image"][None].expand(2, -1, -1, -1),
                      det.loss_cls, det.test_cfg)
    masks = out["masks"]
    check(tuple(masks.shape) == (2, 300, 28, 28)
          and bool(torch.isfinite(masks).all())
          and float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0,
          f"{label} masks finite and in [0, 1]")
    return {"b1_ms_per_image": spread(ms["b1"]),
            "b2_ms_per_image": spread(ms["b2"]),
            "nms_host_syncs_per_image": syncs, "launches": launches,
            "launches_by_size": add_launches(by_size["b1"], by_size["b2"]),
            "vs_plain": compare, "k1": k1, "detector": det,
            "image": images[3]}


def served_launches(torch, det, images, requests):
    """``requests`` b1 requests cycling over ``images`` and half as many
    full b2 batches, each path's K1-K4 launches and NMS host syncs
    counted from 0: ms/image, launches by path and output side, K1's by
    kernel path, the results, the syncs an image by path."""
    from iif_torch.detection.inference import (
        inference_detector,
        inference_detector_batch,
    )
    from iif_torch.ops.nms import nms
    from iif_torch.ops.roi_align_ml import roi_align_ml

    inference_detector(det, images[0], masks=False)
    inference_detector_batch(det, images[:2], pad_to=2, masks=False)
    torch.cuda.synchronize()
    ms, by_size, paths, results, syncs = {}, {}, {}, [], {}
    for path, step in (("b1", 1), ("b2", 2)):
        reset_roi_launches()
        nms.host_syncs = 0
        ms[path] = []
        for i in range(0, requests, step):
            batch = [images[(i + j) % len(images)] for j in range(step)]
            t0 = time.perf_counter()
            if step == 1:
                results.append(inference_detector(det, batch[0],
                                                  masks=False))
            else:
                results += inference_detector_batch(det, batch, pad_to=2,
                                                    masks=False)
            ms[path].append((time.perf_counter() - t0) * 1e3 / step)
        by_size[path] = roi_launches_by_size()
        paths[path] = dict(roi_align_ml.launches_by_path)
        syncs[path] = nms.host_syncs / requests
    return ms, by_size, paths, results, syncs


def lvis_trainer(torch, np, config, options=None):
    """``trainer_from_config`` of ``config`` (``options`` merged) on the
    seeded LVIS counts, its loss from them as the training CLI builds it.
    Returns the trainer, the config and the counts."""
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.inference import build_loss_cls
    from iif_torch.engine.detection import trainer_from_config

    cfg, counts = lvis_cfg(np, config, "train")
    cfg.merge_from_options(options or {})
    train_ds = build_dataset({k: v for k, v in cfg.data["train"].items()
                              if k != "oversample_thr"})
    loss_cls = build_loss_cls(cfg.loss_cls, train_ds, NUM_CLASSES)
    t0 = time.time()
    trainer = trainer_from_config(
        cfg, loss_cls, LVIS_IMAGES // cfg.data["samples_per_gpu"],
        device="cuda")
    log(f"{Path(config).stem} trainer_from_config s {time.time() - t0:.3f}")
    return trainer, cfg, counts


def fasa_trainer(torch, np, config, options=None):
    """``lvis_trainer`` of ``config`` and its initial state with FASA
    (one state a cascade stage)."""
    from iif_torch.engine.detection import init_fasa_states

    trainer, cfg, counts = lvis_trainer(torch, np, config, options)
    state = trainer.init_state(init_fasa_states(
        trainer.model, counts, cfg.fasa_cfg, trainer.device))
    check(trainer.grad_clip == CASCADE_CLIP, "grad clip 35")
    check(trainer.fasa_cfg == dict(cfg.fasa_cfg), "fasa_cfg")
    return trainer, state


def timed_steps(torch, trainer, state, batch, plan, label="FASA"):
    """The steps of ``plan``, (epoch, steps, timed from), each drained:
    the times by epoch, every step's metrics (all finite; with gradient
    clipping a positive global norm)."""
    times, rows = {}, []
    for epoch, n, first in plan:
        for i in range(n):
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, batch, epoch=epoch)
            torch.cuda.synchronize()
            if i >= first:
                times.setdefault(epoch, []).append(
                    (time.perf_counter() - t0) * 1e3)
            rows.append({k: v.item() for k, v in m.items()})
    for i, row in enumerate(rows):
        log(f"{label} step {i}", json.dumps(row))
        for k, v in row.items():
            check(math.isfinite(v), f"finite {k} at step {i}")
        if trainer.grad_clip is not None:
            check(row["grad_norm"] > 0, "global gradient norm logged")
    return state, times, rows


def cascade_training_phase(torch, np):
    """The FASA cascade config (with ``optimizer_config.grad_clip``
    max_norm 35 set, which the R50 FASA config has and the cascade's
    lacks) through ``trainer_from_config`` at b4 on a seeded synthetic
    batch: TRAIN_WARMUP + CASCADE_TIMED steps at epoch 0, then
    CASCADE_TIMED at epoch 1 with the virtual-feature loss on; K1's and
    K2's launches from 0 (three a size a step, all on ``vec8``), the
    global norms, ms/step, peak memory, the stages and busy share of a
    profiled step; then K1 and K2 against their plain versions on one
    step's own stage-3 RoIs and maps."""
    import iif_torch.detection.cascade as cascade_mod
    import iif_torch.engine.detection as engine_mod
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_path,
        roi_align_ml,
    )

    trainer, state = fasa_trainer(
        torch, np, CASCADE_CONFIG,
        {"optimizer_config": {"grad_clip": {"max_norm": CASCADE_CLIP}}})
    tcfg = trainer.train_cfg
    check((tcfg.rpn_nms_pre, tcfg.rpn_max_per_img) == (2000, 2000),
          "rpn_nms_pre and max_per_img 2000")
    batch = synthetic_train_batch(np, torch, "cuda")
    torch.cuda.synchronize()
    reset_roi_launches()
    torch.cuda.reset_peak_memory_stats()
    state, times, rows = timed_steps(
        torch, trainer, state, batch,
        ((0, TRAIN_WARMUP + CASCADE_TIMED, TRAIN_WARMUP),
         (1, CASCADE_TIMED, 0)))
    n = TRAIN_WARMUP + 2 * CASCADE_TIMED
    by_size = roi_launches_by_size()
    launches = {k: by_size[k] for k in ("K1", "K2")}
    log("cascade training launches", json.dumps(launches))
    for k, by_path in (("K1", roi_align_ml.launches_by_path),
                       ("K2", grad_launches_by_path)):
        check(launches[k] == {7: 3 * n, 14: 3 * n},
              f"{k} three a size a step: {launches[k]}")
        check_vec8(f"{k} on the cascade training path", by_path, 6 * n)
    check(not by_size["K3"] and not by_size["K4"], "no K3 or K4")
    check(all(s.feature_used.sum() > 0 for s in state.fasa),
          "each stage's FASA statistics moved")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    norms = [r["grad_norm"] for r in rows]
    median = statistics.median(times[0] + times[1])
    result = {"steps": n, "step_ms_epoch0": spread(times[0]),
              "step_ms_epoch1": spread(times[1]),
              "img_per_s": TRAIN_BATCH * 1e3 / median,
              "grad_norms": norms,
              "steps_clipped": sum(v >= CASCADE_CLIP for v in norms),
              "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
              "launches": launches, "launches_by_size": by_size,
              "peak_allocated_gib": peak}
    state, result["profile"] = profile_train_step(
        torch, trainer, state, batch, (cascade_mod, engine_mod),
        CASCADE_TRAIN_STAGES, K12_PARTS, median)

    # K1 and K2 on one step's own stage-3 maps and RoIs
    state, k1, k2, sides = train_rois_rows(
        torch, np, trainer, state, batch, [7, 14] * 3, (4, 5))
    k1 = {(o, d): r for (_, o, d), r in k1.items()}
    k2 = {(o, d): r for (_, o, d), r in k2.items()}
    result["mean_roi_side_px_by_call"] = sides
    result["k1"], result["k2"] = k1, k2
    return result


def fasa_cli_phase(torch, np, tmp):
    """``python -m iif_torch.cli.train_det`` in the process on the FASA
    cascade config as it stands (the dynamic runner, b4), over a seeded
    LVIS-style set of FASA_CLI_IMAGES PNGs with a ``data.val`` of as many
    more, ``--max-steps`` FASA_CLI_STEPS, 2 epochs: each epoch's FASA val
    pass and dynamic sampling run (the clustering's seconds at 1203
    classes logged), ``prob_list`` as built after epoch 0 and moved after
    epoch 1; K1's and K2's launches from 0 on the training steps and on
    the val passes; ``--resume-from epoch_1.pth`` restores every FASA
    field bit for bit; ``init_detector`` serves ``latest.pth``."""
    import iif_torch.engine.detection as engine_mod
    from iif_torch.cli import train_det
    from iif_torch.config import Config, parse_cfg_options
    from iif_torch.detection.fasa import FasaState
    from iif_torch.detection.inference import (
        inference_detector,
        init_detector,
    )
    from iif_torch.tools.synthetic_lvis import COCO_SIZES, write_synthetic_lvis

    sizes = [COCO_SIZES[i % 3] for i in range(FASA_CLI_IMAGES)]
    train = write_synthetic_lvis(str(tmp / "fasa_train"), sizes, NUM_CLASSES,
                                 seed=10)
    val = write_synthetic_lvis(str(tmp / "fasa_val"), sizes, NUM_CLASSES,
                               seed=11)
    options = [f"data.train.ann_file={train['ann_file']}",
               f"data.train.img_prefix={train['img_prefix']}",
               f"data.val.ann_file={val['ann_file']}",
               f"data.val.img_prefix={val['img_prefix']}",
               f"data.test.ann_file={val['ann_file']}",
               f"data.test.img_prefix={val['img_prefix']}",
               "log_config.tensorboard=False"]
    config = str(REPO / CASCADE_CONFIG)
    work = tmp / "fasa_work"
    argv = [config, "--work-dir", str(work), "--max-steps",
            str(FASA_CLI_STEPS)]
    ap_s, probs, probs_before, val_launches = [], [], [], []
    sampling = engine_mod.fasa_dynamic_sampling
    val_epoch = engine_mod.DetectionTrainer.fasa_val_epoch

    def timed_sampling(state, up, down):
        t0 = time.perf_counter()
        out = sampling(state, up, down)
        ap_s.append(time.perf_counter() - t0)
        return out

    def recorded_val(self, state, loader, print_fn=print):
        before = roi_launches_by_size()
        probs_before.append([s.prob_list.clone() for s in state.fasa])
        state = val_epoch(self, state, loader, print_fn)
        torch.cuda.synchronize()
        val_launches.append(add_launches(roi_launches_by_size(), before,
                                         -1))
        probs.append([s.prob_list.clone() for s in state.fasa])
        return state

    torch.cuda.synchronize()
    reset_roi_launches()
    t0 = time.perf_counter()
    with patched((engine_mod, "fasa_dynamic_sampling", timed_sampling),
                 (engine_mod.DetectionTrainer, "fasa_val_epoch",
                  recorded_val)):
        trainer, state = train_det.main(argv + [
            "--cfg-options", *options, "runner.max_epochs=2"])
    run_s = time.perf_counter() - t0
    total_by_size = roi_launches_by_size()
    total = roi_launches()
    n = 2 * FASA_CLI_STEPS
    check(state.step == n, f"{n} steps over 2 epochs: {state.step}")
    check(len(probs) == 2 and len(ap_s) == 6,
          "a val pass and three stages' sampling an epoch")
    val_by_size = add_launches(*val_launches)
    train_by_size = add_launches(total_by_size, val_by_size, -1)
    on_val = {k: {o: c for o, c in v.items() if c}
              for k, v in val_by_size.items()}
    on_train = {k: {o: c for o, c in v.items() if c}
                for k, v in train_by_size.items()}
    check(on_val == {"K1": {7: 2 * 3 * FASA_CLI_STEPS}, "K2": {}, "K3": {},
                     "K4": {}},
          f"the val passes: one 7x7 K1 a stage a batch: {on_val}")
    check(on_train == {"K1": {7: 3 * n, 14: 3 * n},
                       "K2": {7: 3 * n, 14: 3 * n}, "K3": {}, "K4": {}},
          f"three K1 and K2 a size a step: {on_train}")
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_path,
        roi_align_ml,
    )
    check_vec8("K1 on the FASA CLI path", roi_align_ml.launches_by_path,
               total["K1"])
    check_vec8("K2 on the FASA CLI path", grad_launches_by_path,
               total["K2"])
    check(all(torch.equal(p, q) for p, q in zip(probs[0], probs_before[0])),
          "prob_list as built after epoch 0 (its losses start as t0)")
    moved = [int((a != b).sum()) for a, b in zip(probs[1], probs[0])]
    check(any(moved), f"prob_list moved after epoch 1: {moved}")

    ckpts = work / "checkpoints"
    saved = torch.load(ckpts / "epoch_1.pth", map_location="cpu",
                       weights_only=True)["fasa"]
    _, restored = train_det.main(argv + [
        "--resume-from", str(ckpts / "epoch_1.pth"), "--cfg-options",
        *options, "runner.max_epochs=1"])
    for got, want in zip(restored.fasa, saved):
        for name in FasaState._fields:
            check(torch.equal(getattr(got, name).cpu(), want[name]),
                  f"--resume-from restores FASA's {name}")
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(options))
    det = init_detector(cfg, str(ckpts / "latest.pth"), device="cuda")
    served = inference_detector(det, str(Path(val["img_prefix"]) /
                                         "train2017" / "000000000001.png"),
                                masks=False)
    check(served["boxes"].shape == (300, 4) and served["valid"].any(),
          "the FASA checkpoint serves 300 detections")
    return {"run_s": run_s, "steps": n,
            "dynamic_sampling_s": ap_s, "classes": NUM_CLASSES,
            "prob_list_moved_by_stage": moved,
            "prob_list_after": [[float(p.min()), float(p.mean()),
                                 float(p.max())] for p in probs[1]],
            "launches_train": on_train, "launches_val": on_val,
            "launches_total": total}


def fasa_r50_phase(torch, np):
    """``fasa_iif_r50_rfs_cos_norm_2x.py`` as it stands (MaskRCNN R50,
    normed heads, grad clip 35, FASA) through ``trainer_from_config`` at
    b4: a warm-up step and FASA_R50_STEPS timed ones at epoch 1 (the
    virtual-feature loss on), K1's and K2's launches from 0."""
    trainer, state = fasa_trainer(torch, np, FASA_R50_CONFIG)
    m = trainer.model
    check(type(m.roi_head.bbox_head.fc_cls).__name__ == "NormedLinear"
          and m.roi_head.mask_head.predictor == "normed",
          "the R50 FASA config's normed heads")
    batch = synthetic_train_batch(np, torch, "cuda")
    torch.cuda.synchronize()
    reset_roi_launches()
    torch.cuda.reset_peak_memory_stats()
    state, times, rows = timed_steps(
        torch, trainer, state, batch, ((1, 1 + FASA_R50_STEPS, 1),))
    n = 1 + FASA_R50_STEPS
    by_size = roi_launches_by_size()
    launches = {k: by_size[k] for k in ("K1", "K2")}
    for k in ("K1", "K2"):
        check(launches[k] == {7: n, 14: n}, f"{k} once a size a step")
    check(not by_size["K3"] and not by_size["K4"], "no K3 or K4")
    return {"steps": n, "step_ms_epoch1": spread(times[1]),
            "grad_norms": [r["grad_norm"] for r in rows],
            "last_loss": rows[-1]["loss"], "launches": launches,
            "launches_by_size": by_size,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


HTC_CONFIG = "configs/activations/iif/iif_htc_r101_4x4_1x.py"
X101_CONFIG = "configs/activations/x101_4x4_1x.py"
SIGMOID_CASCADE_CONFIG = "configs/activations/cascade_r50_4x4_1x.py"
HTC_REQUESTS = 20                  # b1 requests; b2: half as many batches
HTC_TIMED = 5                      # timed b4 steps after TRAIN_WARMUP
HTC_CLI_IMAGES = 8                 # train and val PNGs of the CLI phase
HTC_CLI_STEPS = 2                  # --max-steps: b4 steps an epoch
X101_REQUESTS = 10                 # b1 requests of the X101 baseline
SIGMOID_CASCADE_STEPS = 3          # timed steps after a warm-up
SIGMOID_REL_TOL = 1e-5             # the card's sigmoid CE against the CPU's
HTC_STAGES = ("backbone_fpn", "rpn") + tuple(
    f"stage{i}_{part}" for i in range(3)
    for part in ("bbox_roi_align", "bbox_head")) + (
    "bbox_nms", "mask_roi_align") + tuple(
    f"stage{i}_{part}" for i in range(3)
    for part in ("mask_trunk", "mask_head"))
HTC_TRAIN_STAGES = ("backbone_fpn", "rpn_loss", "rpn_proposals") + tuple(
    f"stage{i}_{part}" for i in range(3)
    for part in ("targets", "bbox_roi_align", "bbox_head_loss",
                 "mask_targets", "mask_roi_align", "mask_trunk",
                 "mask_loss")) + ("backward", "optimizer")


def htc_serving_phase(torch, np):
    """The headline HTC config as it stands (HTC R101-FPN, bf16 trunk,
    1203 classes, IIF from the seeded LVIS counts, ``score_thr=1e-4``,
    300 detections) through ``init_detector``, weights from
    ``fresh_init_`` (seeded), stage 0 without ``conv_res``:
    ``staged_serving`` with HTC_REQUESTS b1 requests (the masks through
    three chained trunks)."""
    from iif_torch.detection.htc import HTC, htc_simple_test
    from iif_torch.detection.inference import init_detector
    from iif_torch.detection.init import fresh_init_
    from iif_torch.detection.losses import DetIIFLoss

    cfg, _ = lvis_cfg(np, HTC_CONFIG, "test")
    t0 = time.time()
    det = init_detector(cfg, device="cuda")
    fresh_init_(det.model, torch.Generator().manual_seed(0))
    log(f"HTC init_detector + fresh_init_ s {time.time() - t0:.3f}")
    m, tc = det.model, det.test_cfg
    heads = m.roi_head.mask_head
    check(type(m) is HTC and m.num_stages == 3, "a three-stage HTC")
    check(m.num_classes == NUM_CLASSES and len(m.backbone.layer3) == 23
          and m.backbone.compute_dtype == torch.bfloat16,
          "R101, 1203 classes, bf16 trunk")
    check(heads[0].conv_res is None and all(
        h.conv_res is not None for h in heads[1:]),
          "conv_res on stages 1 and 2 (mmdet's layout)")
    check(isinstance(det.loss_cls, DetIIFLoss), "IIF loss")
    check((tc.score_thr, tc.max_per_img) == (1e-4, 300),
          "test_cfg 1e-4, 300")
    return staged_serving(torch, np, det, "HTC", htc_simple_test,
                          HTC_REQUESTS)


def train_rois_rows(torch, np, trainer, state, batch, sizes, full,
                    f32=()):
    """One step of ``trainer`` with its extractor calls captured (their
    output ``sizes`` in order checked): K1 and K2 against their plain
    versions on the own maps and RoIs of the calls ``full`` names (f32
    and bf16) and of those ``f32`` names (f32); each call's mean RoI side.
    Returns the state, the rows by (call, output side, dtype) and the
    sides."""
    seen = []
    with patched(capture_extractor(seen)):
        state, _ = trainer.train_step(state, batch)
    check([o for o, *_ in seen] == list(sizes),
          f"extractor calls of sizes {sizes}")
    rng = np.random.RandomState(7)
    k1, k2, sides = {}, {}, []
    for i, (o, nhwc, rois, _) in enumerate(seen):
        sides.append(((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2])
                      ).clamp(min=0).sqrt().mean().item())
        if i not in full and i not in f32:
            continue
        feats32 = [f.float() for f in nhwc]
        g32 = torch.tensor(rng.randn(rois.shape[0], o, o, 256),
                           dtype=torch.float32, device="cuda")
        for dt in (torch.float32, torch.bfloat16)[:2 if i in full else 1]:
            row = k1_row(torch, feats32, rois, o, dt)
            k1[(i, o, row["dtype"])] = row
            row = k2_row(torch, feats32, rois, g32, o, dt)
            k2[(i, o, row["dtype"])] = row
    return state, k1, k2, sides


def htc_training_phase(torch, np):
    """The headline HTC config (``grad_clip`` 35 as it stands) through
    ``trainer_from_config`` at b4 on the MaskRCNN cell's synthetic batch:
    TRAIN_WARMUP + HTC_TIMED steps, ms/step, peak memory, NMS host syncs a
    step, K1's and K2's launches from 0 (three a size a step, all on
    ``vec8``), every loss finite, the global norms; the stages, busy share
    and top kernels of a profiled step; then K1 and K2 against their
    plain versions on one step's own maps and RoIs, each stage's (f32;
    bf16 too on stage 2's)."""
    import iif_torch.detection.cascade as cascade_mod
    import iif_torch.detection.htc as htc_mod
    import iif_torch.engine.detection as engine_mod
    from iif_torch.ops.nms import nms
    from iif_torch.ops.roi_align_ml import (
        grad_launches_by_path,
        roi_align_ml,
    )

    trainer, cfg, _ = lvis_trainer(torch, np, HTC_CONFIG)
    check(type(trainer.model).__name__ == "HTC"
          and trainer.loss_fn.__name__ == "htc_loss", "the HTC trainer")
    check(trainer.grad_clip == CASCADE_CLIP, "grad clip 35")
    check(trainer.train_cfg.rpn_nms_pre == 2000, "rpn_nms_pre 2000")
    state = trainer.init_state()
    batch = synthetic_train_batch(np, torch, "cuda")
    torch.cuda.synchronize()
    reset_roi_launches()
    nms.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_WARMUP + HTC_TIMED
    state, times, rows = timed_steps(
        torch, trainer, state, batch, ((0, n, TRAIN_WARMUP),), label="HTC")
    syncs = nms.host_syncs / n
    by_size = roi_launches_by_size()
    launches = {k: by_size[k] for k in ("K1", "K2")}
    log("HTC training launches", json.dumps(launches))
    for k, by_path in (("K1", roi_align_ml.launches_by_path),
                       ("K2", grad_launches_by_path)):
        check(launches[k] == {7: 3 * n, 14: 3 * n},
              f"{k} three a size a step: {launches[k]}")
        check_vec8(f"{k} on the HTC training path", by_path, 6 * n)
    check(not by_size["K3"] and not by_size["K4"], "no K3 or K4")
    check({f"s{s}.loss_mask" for s in range(3)} <= set(rows[-1]),
          "every stage's mask loss")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    median = statistics.median(times[0])
    norms = [r["grad_norm"] for r in rows]
    result = {"steps": n, "step_ms": spread(times[0]),
              "img_per_s": TRAIN_BATCH * 1e3 / median, "grad_norms": norms,
              "steps_clipped": sum(v >= CASCADE_CLIP for v in norms),
              "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
              "launches": launches, "launches_by_size": by_size,
              "nms_host_syncs_per_step": syncs, "peak_allocated_gib": peak}
    state, result["profile"] = profile_train_step(
        torch, trainer, state, batch, (cascade_mod, htc_mod, engine_mod),
        HTC_TRAIN_STAGES, K12_PARTS, median)
    state, k1, k2, sides = train_rois_rows(
        torch, np, trainer, state, batch, [7, 14] * 3, (4, 5), (0, 1, 2, 3))
    result["mean_roi_side_px_by_call"] = sides
    result["stages_f32_max_abs_err"] = {
        f"{key}_call{i}_{o}x{o}": [row["max_abs_err"], row.get("max_grad")]
        for key, rows in (("K1", k1), ("K2", k2))
        for (i, o, d), row in rows.items() if d == "float32"}
    result["k1"] = {(o, d): r for (i, o, d), r in k1.items() if i >= 4}
    result["k2"] = {(o, d): r for (i, o, d), r in k2.items() if i >= 4}
    return result


def htc_cli_phase(torch, np, tmp):
    """The three CLIs on the headline HTC config as it stands: ``python
    -m iif_torch.cli.train_det`` in the process over HTC_CLI_IMAGES
    seeded LVIS-style PNGs, one epoch of HTC_CLI_STEPS b4 steps (K1 and K2
    from 0: three a size a step), ``epoch_1.pth`` with mmdet's HTC names;
    ``--resume-from`` it restoring the weights bit for bit and the step;
    ``python -m iif_torch.cli.test_det`` on the work directory over as
    many val PNGs (``results.json``, K1 three 7x7 and one 14x14 a batch),
    the val set's gt as detections scoring AP 1; one HTTP request through
    ``cli.serve``'s ``make_server`` on the checkpoint (a PNG body)."""
    import threading
    import urllib.request

    from iif_torch.cli import test_det, train_det
    from iif_torch.cli.serve import make_server
    from iif_torch.config import Config, parse_cfg_options
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.image_io import write_png
    from iif_torch.detection.inference import init_detector
    from iif_torch.tools.synthetic_lvis import COCO_SIZES, write_synthetic_lvis

    sizes = [COCO_SIZES[i % 3] for i in range(HTC_CLI_IMAGES)]
    train = write_synthetic_lvis(str(tmp / "htc_train"), sizes, NUM_CLASSES,
                                 seed=12)
    val = write_synthetic_lvis(str(tmp / "htc_val"), sizes, NUM_CLASSES,
                               seed=13)
    options = [f"data.train.ann_file={train['ann_file']}",
               f"data.train.img_prefix={train['img_prefix']}",
               f"data.test.ann_file={val['ann_file']}",
               f"data.test.img_prefix={val['img_prefix']}",
               "log_config.tensorboard=False"]
    config = str(REPO / HTC_CONFIG)
    work = tmp / "htc_work"
    argv = [config, "--work-dir", str(work), "--max-steps",
            str(HTC_CLI_STEPS)]
    torch.cuda.synchronize()
    reset_roi_launches()
    t0 = time.perf_counter()
    trainer, state = train_det.main(argv + [
        "--cfg-options", *options, "runner.max_epochs=1"])
    train_s = time.perf_counter() - t0
    on_train = roi_launches_by_size()
    n = HTC_CLI_STEPS
    check(type(trainer.model).__name__ == "HTC" and state.step == n,
          f"{n} HTC steps: {state.step}")
    check(on_train["K1"] == {7: 3 * n, 14: 3 * n}
          and on_train["K2"] == {7: 3 * n, 14: 3 * n},
          f"three K1 and K2 a size a step: {on_train}")
    ckpt = work / "checkpoints" / "epoch_1.pth"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    names = set(saved["state_dict"])
    check("roi_head.mask_head.2.conv_res.conv.weight" in names
          and "roi_head.mask_head.0.conv_res.conv.weight" not in names
          and "roi_head.bbox_head.2.fc_cls.weight" in names,
          "the checkpoint holds mmdet's HTC names")
    resumed, rstate = train_det.main(argv + [
        "--resume-from", str(ckpt), "--cfg-options", *options,
        "runner.max_epochs=1"])
    check(rstate.step == n, "--resume-from restores the step")
    for k, v in resumed.model.state_dict().items():
        check(torch.equal(v.cpu(), saved["state_dict"][k]),
              f"--resume-from restores {k}")
    del trainer, resumed

    out_json = tmp / "htc_results.json"
    reset_roi_launches()
    t0 = time.perf_counter()
    metrics = test_det.main([config, str(work), "--eval", "bbox", "segm",
                             "--out", str(out_json), "--cfg-options",
                             *options])
    test_s = time.perf_counter() - t0
    on_test = roi_launches_by_size()
    batches = HTC_CLI_IMAGES // TRAIN_BATCH
    check(on_test["K1"] == {7: 3 * batches, 14: batches}
          and not on_test["K2"],
          f"test_det: K1 three 7x7 and one 14x14 a batch: {on_test}")
    records = json.loads(out_json.read_text())
    check(records and {"image_id", "bbox", "score", "segmentation"}
          <= set(records[0]), "results.json written")
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(options))
    ds = build_dataset(dict(cfg.data["test"]))
    for iou_type in ("bbox", "segm"):
        res = test_det.build_evaluator(ds, cfg).evaluate(
            gt_as_detections(ds), iou_type)
        check(res["AP"] == 1.0, f"gt as detections: {iou_type} AP 1")

    det = init_detector(cfg, str(work / "checkpoints" / "latest.pth"),
                        device="cuda")
    png = tmp / "htc_request.png"
    write_png(str(png), np.random.RandomState(5).randint(
        0, 256, (480, 640, 3)).astype(np.uint8))
    server = make_server(det, score_thr=0.0, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    reset_roi_launches()
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/ping", timeout=60) as r:
            check(json.loads(r.read()) == {"status": "Healthy"}, "ping")
        req = urllib.request.Request(base + "/predictions/htc",
                                     data=png.read_bytes(), method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            preds = json.loads(r.read())
        http_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the server thread stopped")
    on_http = roi_launches_by_size()
    check(isinstance(preds, list) and len(preds) > 0
          and {"class_name", "bbox", "score"} <= set(preds[0]),
          f"the HTTP request answers detections: {str(preds)[:200]}")
    check(on_http["K1"] == {7: 3, 14: 1}, f"one HTC forward: {on_http}")
    return {"train_s": train_s, "test_s": test_s, "http_ms": http_ms,
            "http_detections": len(preds), "results": len(records),
            "ap": {m: metrics[m] for m in ("bbox", "segm")},
            "launches_train": on_train, "launches_test": on_test,
            "launches_http": on_http}


def x101_serving_phase(torch, np):
    """``configs/activations/x101_4x4_1x.py`` as it stands (MaskRCNN
    ResNeXt-101 32x4d, bf16, sigmoid CE with the fc_cls bias at -6.5,
    softmax at inference) through ``init_detector`` with ``fresh_init_``
    weights: X101_REQUESTS b1 requests, ms/image, K1's launches from 0
    (once a size a request, ``vec8``), a request's RoI features and
    scores against the plain RoIAlign, K1 on its RoIs."""
    from iif_torch.detection.detector import MaskRCNN
    from iif_torch.detection.inference import (
        inference_detector,
        init_detector,
    )
    from iif_torch.detection.init import fresh_init_
    from iif_torch.ops.roi_align_ml import roi_align_ml

    cfg, _ = lvis_cfg(np, X101_CONFIG, "test")
    t0 = time.time()
    det = init_detector(cfg, device="cuda")
    fresh_init_(det.model, torch.Generator().manual_seed(0))
    log(f"X101 init_detector + fresh_init_ s {time.time() - t0:.3f}")
    m = det.model
    conv2 = m.backbone.layer1[0].conv2
    check(type(m) is MaskRCNN and conv2.groups == 32
          and conv2.out_channels == 128 and len(m.backbone.layer3) == 23,
          "ResNeXt-101 32x4d")
    check(det.loss_cls.use_sigmoid and not det.loss_cls.custom_activation,
          "sigmoid CE, softmax at inference")
    check(bool((m.roi_head.bbox_head.fc_cls.bias == -6.5).all()),
          "fc_cls bias -6.5")
    _, images = serving_images(np)
    inference_detector(det, images[0], masks=False)
    torch.cuda.synchronize()
    reset_roi_launches()
    ms, results = [], []
    for i in range(X101_REQUESTS):
        t0 = time.perf_counter()
        results.append(inference_detector(det, images[i % len(images)],
                                          masks=False))
        ms.append((time.perf_counter() - t0) * 1e3)
    by_size = roi_launches_by_size()
    n = X101_REQUESTS
    check(by_size["K1"] == {7: n, 14: n}, f"K1 once a size: {by_size}")
    check_vec8("K1 on the X101 path", roi_align_ml.launches_by_path, 2 * n)
    for res in results:
        check(res["boxes"].shape == (300, 4) and np.isfinite(
            res["scores"]).all(), "300 finite detections")
    seen = []
    with patched(capture_extractor(seen)):
        inference_detector(det, images[3], masks=False)
    compare = features_vs_plain(torch, seen, [7, 14],
                                lambda i: m.roi_head.bbox_head)
    k1 = {}
    for o, nhwc, rois, _ in seen:
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, [f.float() for f in nhwc], rois, o, dt)
            k1[(o, row["dtype"])] = row
    return {"b1_ms_per_image": spread(ms), "launches": by_size["K1"],
            "launches_by_size": by_size, "vs_plain": compare, "k1": k1,
            "detector": det, "image": images[3]}


def sigmoid_vs_cpu(torch, loss_cls, args):
    """The sigmoid CE and its logits gradient on the card against the
    same call on the CPU: the largest error over the largest magnitude."""
    def run(dev):
        score, labels, weight, avg = (a.detach().to(dev) for a in args)
        score.requires_grad_(True)
        loss = loss_cls(score, labels, weight=weight, avg_factor=avg)
        loss.backward()
        return loss.detach().cpu(), score.grad.cpu()

    (lc, gc), (lp, gp) = run("cuda"), run("cpu")
    return {"loss": float(lc), "loss_rel_err": abs(float(lc - lp))
            / abs(float(lp)),
            "grad_rel_err": float((gc - gp).abs().max() / gp.abs().max())}


def x101_training_phase(torch, np):
    """The X101 sigmoid baseline through ``trainer_from_config`` at b4 on
    the MaskRCNN cell's batch: TRAIN_WARMUP + HTC_TIMED steps, ms/step,
    peak memory, K1's and K2's launches from 0 (once a size a step), the
    profiled step's stages (``backbone_fpn`` beside HTC R101's); the
    sigmoid loss of a step's own logits on the card against the CPU
    (within SIGMOID_REL_TOL); K1 and K2 on a step's RoIs."""
    import iif_torch.detection.detector as detector_mod
    import iif_torch.engine.detection as engine_mod

    trainer, cfg, _ = lvis_trainer(torch, np, X101_CONFIG)
    check(trainer.model.backbone.layer4[0].conv2.groups == 32
          and trainer.loss_cls.use_sigmoid, "X101 with sigmoid CE")
    state = trainer.init_state()
    batch = synthetic_train_batch(np, torch, "cuda")
    calls = []
    loss_call = type(trainer.loss_cls).__call__

    def record(self, score, labels, weight=None, avg_factor=None, **kw):
        if not calls:
            calls.append((score, labels, weight, avg_factor))
        return loss_call(self, score, labels, weight=weight,
                         avg_factor=avg_factor, **kw)

    torch.cuda.synchronize()
    reset_roi_launches()
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_WARMUP + HTC_TIMED
    with patched((type(trainer.loss_cls), "__call__", record)):
        state, times, rows = timed_steps(
            torch, trainer, state, batch, ((0, n, TRAIN_WARMUP),),
            label="X101")
    by_size = roi_launches_by_size()
    check(by_size["K1"] == {7: n, 14: n} and by_size["K2"] == {7: n, 14: n},
          f"K1 and K2 once a size a step: {by_size}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sig = sigmoid_vs_cpu(torch, trainer.loss_cls, calls[0])
    log("sigmoid CE card vs CPU", json.dumps(sig))
    check(sig["loss_rel_err"] <= SIGMOID_REL_TOL
          and sig["grad_rel_err"] <= SIGMOID_REL_TOL,
          f"the sigmoid CE on the card agrees with the CPU's: {sig}")
    median = statistics.median(times[0])
    result = {"steps": n, "step_ms": spread(times[0]),
              "img_per_s": TRAIN_BATCH * 1e3 / median,
              "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
              "launches_by_size": by_size, "peak_allocated_gib": peak,
              "sigmoid_vs_cpu": sig, "sigmoid_tolerance": SIGMOID_REL_TOL}
    state, result["profile"] = profile_train_step(
        torch, trainer, state, batch, (detector_mod, engine_mod),
        TRAIN_STAGES, K12_PARTS, median)
    state, k1, k2, _ = train_rois_rows(torch, np, trainer, state, batch,
                                       [7, 14], (0, 1))
    result["k1"] = {(o, d): r for (_, o, d), r in k1.items()}
    result["k2"] = {(o, d): r for (_, o, d), r in k2.items()}
    return result


def sigmoid_cascade_phase(torch, np):
    """``configs/activations/cascade_r50_4x4_1x.py`` as it stands
    (Cascade Mask R-CNN R50, sigmoid CE, ``grad_clip`` 35) through
    ``trainer_from_config`` at b4: a warm-up step and
    SIGMOID_CASCADE_STEPS timed ones, K1's and K2's launches from 0
    (three a size a step)."""
    trainer, _, _ = lvis_trainer(torch, np, SIGMOID_CASCADE_CONFIG)
    m = trainer.model
    check(type(m).__name__ == "CascadeMaskRCNN" and len(m.backbone.layer3)
          == 6 and trainer.loss_cls.use_sigmoid
          and trainer.grad_clip == CASCADE_CLIP,
          "sigmoid cascade R50 with clip 35")
    batch = synthetic_train_batch(np, torch, "cuda")
    torch.cuda.synchronize()
    reset_roi_launches()
    torch.cuda.reset_peak_memory_stats()
    n = 1 + SIGMOID_CASCADE_STEPS
    state, times, rows = timed_steps(
        torch, trainer, trainer.init_state(), batch, ((0, n, 1),),
        label="sigmoid cascade")
    by_size = roi_launches_by_size()
    for k in ("K1", "K2"):
        check(by_size[k] == {7: 3 * n, 14: 3 * n},
              f"{k} three a size a step: {by_size[k]}")
    return {"steps": n, "step_ms": spread(times[0]),
            "grad_norms": [r["grad_norm"] for r in rows],
            "last_loss": rows[-1]["loss"], "launches_by_size": by_size,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


SEESAW_CONFIG = ("configs/seesaw_loss/"
                 "mask_rcnn_r50_fpn_seesaw_mstrain_2x_lvis_v1.py")
RSB_CONFIG = "configs/fasa/fasa_iof_base10_r50_rfs_cos_norm_1x_rsb.py"
SEESAW_REQUESTS = 20               # b1 requests; b2: half as many batches
SEESAW_TIMED = 5                   # timed b4 steps after TRAIN_WARMUP
SEESAW_REL_TOL = 1e-5              # Seesaw on the card against the CPU
RSB_IMAGES = 12                    # seeded PNGs of the RSB CLI phase
RSB_STEPS = 3                      # --max-steps: b4 steps (2 micro-batches)
RSB_TIMED = 3                      # timed b4 steps after the CLI's
RSB_ACCUM = 2                      # data.grad_accum
RSB_PROBE_LR = 1e-3                # the decay probe step's learning rate
TTA_IMAGES = 8                     # seeded PNGs of the TTA phase


def seesaw_vs_cpu(torch, loss, call):
    """Seesaw of one step's own logits (its counts, labels, weights and
    ``avg_factor``) on the card against the same call on the CPU: the
    loss's and the logits gradient's largest error over their largest
    magnitude."""
    cum, score, labels, weight, avg = call

    def run(dev):
        s = score.detach().to(dev).requires_grad_(True)
        value = loss.with_cum(cum.to(dev))(
            s, labels.to(dev), weight=weight.to(dev),
            avg_factor=avg.to(dev))
        value.backward()
        return value.detach().cpu(), s.grad.cpu()

    (lc, gc), (lp, gp) = run("cuda"), run("cpu")
    return {"loss": float(lc),
            "loss_rel_err": abs(float(lc - lp)) / abs(float(lp)),
            "grad_rel_err": float((gc - gp).abs().max() / gp.abs().max())}


def seesaw_phase(torch, np):
    """The Seesaw config as it stands (MaskRCNN R50-FPN, bf16 trunk, the
    normed C+2 classifier at temperature 20, ``SeesawLoss`` p 0.8 q 2,
    1203 classes, ``score_thr=1e-4``, 300 detections): ``init_detector``
    with ``fresh_init_`` (seeded) serving SEESAW_REQUESTS b1 requests and
    half as many b2 batches (K1 one 7x7 and one 14x14 a forward); then
    ``trainer_from_config`` at b4 on the MaskRCNN cell's batch,
    TRAIN_WARMUP + SEESAW_TIMED steps (K1 and K2 once a size a step), each
    step's ``seesaw_cum`` equal to the host's bincount of the labels of
    weight > 0 it counted, and the loss of the first step's own logits on
    the card against the CPU (within SEESAW_REL_TOL)."""
    from iif_torch.detection.inference import init_detector
    from iif_torch.detection.init import fresh_init_
    from iif_torch.detection.losses_extra import SeesawLoss

    cfg, _ = lvis_cfg(np, SEESAW_CONFIG, "test")
    det = init_detector(cfg, device="cuda")
    fresh_init_(det.model, torch.Generator().manual_seed(0))
    fc = det.model.roi_head.bbox_head.fc_cls
    check(isinstance(det.loss_cls, SeesawLoss)
          and type(fc).__name__ == "NormedLinear"
          and tuple(fc.weight.shape) == (1024, NUM_CLASSES + 2)
          and fc.temperature == 20.0, "Seesaw with a normed C+2 classifier")
    check((det.test_cfg.score_thr, det.test_cfg.max_per_img) == (1e-4, 300),
          "test_cfg 1e-4, 300")
    _, images = serving_images(np)
    ms, by_size, paths, results, syncs = served_launches(
        torch, det, images, SEESAW_REQUESTS)
    for path, n in (("b1", SEESAW_REQUESTS), ("b2", SEESAW_REQUESTS // 2)):
        check(by_size[path]["K1"] == {7: n, 14: n},
              f"K1 one 7x7 and one 14x14 a forward on {path}: "
              f"{by_size[path]['K1']}")
        check(not any(by_size[path][k] for k in ("K2", "K3", "K4")),
              f"no K2, K3 or K4 on the Seesaw {path} path")
        check_vec8(f"K1 on the Seesaw {path} path", paths[path], 2 * n)
    for res in results:
        check(res["boxes"].shape == (300, 4) and res["valid"].any()
              and res["labels"][res["valid"]].max() < NUM_CLASSES,
              "300 detections of the 1203 classes, some valid")
        for k, v in res.items():
            check(np.isfinite(v.astype(np.float64)).all(), f"finite {k}")
    serving = {"b1_ms_per_image": spread(ms["b1"]),
               "b2_ms_per_image": spread(ms["b2"]),
               "nms_host_syncs_per_image": syncs,
               "launches_by_size": add_launches(by_size["b1"],
                                                by_size["b2"])}
    del det

    trainer, _, _ = lvis_trainer(torch, np, SEESAW_CONFIG)
    check(isinstance(trainer.loss_cls, SeesawLoss)
          and trainer.model.roi_head.bbox_head.fc_cls.weight.shape[1]
          == NUM_CLASSES + 2, "the Seesaw trainer's C+2 classifier")
    state = trainer.init_state()
    check(not state.seesaw_cum.any(), "seesaw_cum starts at 0")
    batch = synthetic_train_batch(np, torch, "cuda")
    counted, calls = [], []
    update, loss_call = SeesawLoss.update_cum, SeesawLoss.__call__

    def record_update(self, labels, weight=None):
        counted.append((self.cum_samples.clone(), labels.clone(),
                        weight.clone()))
        return update(self, labels, weight)

    def record_call(self, score, labels, weight=None, avg_factor=None,
                    **kw):
        if not calls:
            calls.append((self.cum_samples.clone(), score.detach().clone(),
                          labels.clone(), weight.clone(),
                          torch.as_tensor(avg_factor).detach().clone()))
        return loss_call(self, score, labels, weight=weight,
                         avg_factor=avg_factor, **kw)

    torch.cuda.synchronize()
    reset_roi_launches()
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_WARMUP + SEESAW_TIMED
    with patched((SeesawLoss, "update_cum", record_update),
                 (SeesawLoss, "__call__", record_call)):
        state, times, rows = timed_steps(
            torch, trainer, state, batch, ((0, n, TRAIN_WARMUP),),
            label="Seesaw")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_size = roi_launches_by_size()
    for k in ("K1", "K2"):
        check(by_size[k] == {7: n, 14: n}, f"{k} once a size a step: "
              f"{by_size[k]}")
    check(not by_size["K3"] and not by_size["K4"], "no K3 or K4")
    check(len(counted) == n, f"one count a step: {len(counted)}")
    cum = np.zeros(NUM_CLASSES + 1)
    for i, (before, labels, weight) in enumerate(counted):
        check(np.array_equal(before.cpu().numpy(), cum),
              f"step {i} counts from the last step's seesaw_cum")
        lab, w = labels.cpu().numpy(), weight.cpu().numpy()
        cum = cum + np.bincount(lab[w > 0], minlength=NUM_CLASSES + 1)
    check(np.array_equal(state.seesaw_cum.cpu().numpy(), cum),
          "seesaw_cum equals the host's bincount of the valid labels")
    check(all(0.0 <= r["acc"] <= 100.0 for r in rows), "accuracy logged")
    vs_cpu = seesaw_vs_cpu(torch, trainer.loss_cls, calls[0])
    log("Seesaw card vs CPU", json.dumps(vs_cpu))
    check(vs_cpu["loss_rel_err"] <= SEESAW_REL_TOL
          and vs_cpu["grad_rel_err"] <= SEESAW_REL_TOL,
          f"Seesaw on the card agrees with the CPU's: {vs_cpu}")
    counts = state.seesaw_cum.cpu().numpy()
    return {"serving": serving, "steps": n, "step_ms": spread(times[0]),
            "img_per_s": TRAIN_BATCH * 1e3 / statistics.median(times[0]),
            "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
            "seesaw_cum_total": float(counts.sum()),
            "seesaw_cum_background": float(counts[-1]),
            "seesaw_vs_cpu": vs_cpu, "seesaw_tolerance": SEESAW_REL_TOL,
            "launches_by_size": by_size, "peak_allocated_gib": peak,
            "serving_launches_by_size": serving["launches_by_size"]}


def decay_fraction(torch, np, opt, p, old, lr):
    """The share of AdamW's decoupled decay a step of rate ``lr`` gave
    ``p`` (from ``old``): the update less the Adam direction rebuilt from
    the optimizer's moments, fitted by least squares to ``wd * old``; 1
    decayed, 0 not."""
    group = next(g for g in opt.param_groups
                 if any(q is p for q in g["params"]))
    st = opt.state[p]
    n = np.float32(st["count"])
    c1 = float(np.float32(1) - np.float32(group["b1"]) ** n)
    c2 = float(np.float32(1) - np.float32(group["b2"]) ** n)
    adam = (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2) + group["eps"])
    rest = ((old - p.detach()) / lr - adam).double()
    target = (0.05 * old).double()
    return float((rest * target).sum() / (target * target).sum())


def rsb_phase(torch, np, tmp):
    """``python -m iif_torch.cli.train_det`` in the process on the RSB
    config as it stands (FASA + IOF MaskRCNN R50, normed heads, AdamW lr
    2e-4 wd 0.05 with ``norm_decay_mult=0``, the dynamic runner) from a
    seeded mmcls-layout backbone ``.pth`` the phase writes (``backbone.*``
    and ``head.fc.*``), over RSB_IMAGES seeded LVIS-style PNGs (train and
    val), ``--cfg-options data.grad_accum=2``, ``--max-steps`` RSB_STEPS:
    K1 and K2 once a size a micro-batch, the val pass's K1; the frozen
    stem as the file wrote it; the norm layers in the group without
    decay; RSB_TIMED timed b4 steps on the MaskRCNN cell's batch; then a
    probe step at lr RSB_PROBE_LR: a conv weight took the decay and a BN
    weight none (``decay_fraction``)."""
    import iif_torch.engine.detection as engine_mod
    from iif_torch.cli import train_det
    from iif_torch.detection.detector import _DEPTH_LAYERS, random_init_
    from iif_torch.models.resnet import ResNet
    from iif_torch.tools.synthetic_lvis import COCO_SIZES, write_synthetic_lvis

    sizes = [COCO_SIZES[i % 3] for i in range(RSB_IMAGES)]
    data = write_synthetic_lvis(str(tmp / "rsb"), sizes, NUM_CLASSES,
                                seed=15)
    gen = torch.Generator().manual_seed(3)
    backbone = random_init_(ResNet(_DEPTH_LAYERS[50]), gen)
    sd = {f"backbone.{k}": v for k, v in backbone.state_dict().items()}
    sd["head.fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
    sd["head.fc.bias"] = torch.zeros(1000)
    pth = tmp / "resnet50_rsb_a1.pth"
    torch.save({"meta": {"note": "seeded, mmcls layout"}, "state_dict": sd},
               pth)
    options = [f"data.{split}.{k}={data[k]}" for split in ("train", "val")
               for k in ("ann_file", "img_prefix")] + [
        f"model.pretrained_backbone={pth}", f"data.grad_accum={RSB_ACCUM}",
        "runner.max_epochs=1", "log_config.tensorboard=False"]
    val_launches = []
    val_epoch = engine_mod.DetectionTrainer.fasa_val_epoch

    def recorded_val(self, state, loader, print_fn=print):
        before = roi_launches_by_size()
        state = val_epoch(self, state, loader, print_fn)
        torch.cuda.synchronize()
        val_launches.append(add_launches(roi_launches_by_size(), before, -1))
        return state

    torch.cuda.synchronize()
    reset_roi_launches()
    t0 = time.perf_counter()
    with patched((engine_mod.DetectionTrainer, "fasa_val_epoch",
                  recorded_val)):
        trainer, state = train_det.main([
            str(REPO / RSB_CONFIG), "--work-dir", str(tmp / "rsb_work"),
            "--max-steps", str(RSB_STEPS), "--cfg-options", *options])
    run_s = time.perf_counter() - t0
    total = roi_launches_by_size()
    check(len(val_launches) == 1, "one FASA val pass")
    on_val = {k: {o: c for o, c in v.items() if c}
              for k, v in val_launches[0].items()}
    on_train = {k: {o: c for o, c in v.items() if c} for k, v in
                add_launches(total, val_launches[0], -1).items()}
    micro = RSB_ACCUM * RSB_STEPS
    check(trainer.grad_accum == RSB_ACCUM and state.step == RSB_STEPS,
          f"{RSB_STEPS} steps of {RSB_ACCUM} micro-batches: {state.step}")
    check(on_train == {"K1": {7: micro, 14: micro},
                       "K2": {7: micro, 14: micro}, "K3": {}, "K4": {}},
          f"K1 and K2 once a size a micro-batch: {on_train}")
    check(on_val["K1"] == {7: RSB_STEPS} and not on_val["K2"],
          f"the val pass: one 7x7 K1 a batch: {on_val}")
    model = trainer.model
    check(torch.equal(model.backbone.conv1.weight.detach().cpu(),
                      sd["backbone.conv1.weight"]),
          "the frozen stem as the mmcls file wrote it")
    groups = state.optimizer.param_groups
    check([(g["weight_decay"], g["decay_offset"]) for g in groups]
          == [(0.05, 0.0), (0.0, 0.0), (0.05, 1.0)],
          "AdamW groups: decayed, norm layers undecayed, normed kernels")
    no_decay = {id(p) for p in groups[1]["params"]}
    conv = model.backbone.layer4[0].conv2.weight
    bn = model.backbone.layer4[0].bn2.weight
    check(id(bn) in no_decay and id(conv) not in no_decay,
          "a BN weight in the group without decay, a conv weight not")

    batch = synthetic_train_batch(np, torch, "cuda")
    torch.cuda.synchronize()
    reset_roi_launches()
    torch.cuda.reset_peak_memory_stats()
    n = 1 + RSB_TIMED
    state, times, rows = timed_steps(torch, trainer, state, batch,
                                     ((0, n, 1),), label="RSB")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_size = roi_launches_by_size()
    check(by_size["K1"] == {7: RSB_ACCUM * n, 14: RSB_ACCUM * n}
          and by_size["K2"] == {7: RSB_ACCUM * n, 14: RSB_ACCUM * n},
          f"K1 and K2 once a size a micro-batch: {by_size}")
    for g in groups:
        g["lr"] = RSB_PROBE_LR
    old_conv, old_bn = conv.detach().clone(), bn.detach().clone()
    state, _ = trainer.train_step(state, batch)
    fractions = {"conv": decay_fraction(torch, np, state.optimizer, conv,
                                        old_conv, RSB_PROBE_LR),
                 "bn": decay_fraction(torch, np, state.optimizer, bn, old_bn,
                                      RSB_PROBE_LR)}
    log("RSB decay probe", json.dumps(fractions))
    check(abs(fractions["conv"] - 1.0) < 0.05 and abs(fractions["bn"])
          < 0.05, f"a conv weight decayed, a BN weight not: {fractions}")
    return {"cli_run_s": run_s, "cli_steps": RSB_STEPS,
            "micro_batches": micro, "step_ms": spread(times[0]),
            "img_per_s": TRAIN_BATCH * 1e3 / statistics.median(times[0]),
            "last_loss": rows[-1]["loss"], "decay_fraction": fractions,
            "launches_train": on_train, "launches_val": on_val,
            "launches_by_size": by_size, "peak_allocated_gib": peak}


def tta_run(torch, test_det, argv, images, per_image):
    """``test_det.main(argv)`` with K1-K4 counted from 0: its metrics, its
    seconds an image and its launches; no K2-K4, and K1's checked against
    ``per_image`` (output side -> launches an image) where given."""
    torch.cuda.synchronize()
    reset_roi_launches()
    t0 = time.perf_counter()
    metrics = test_det.main(argv)
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / images
    by_size = roi_launches_by_size()
    check(not any(by_size[k] for k in ("K2", "K3", "K4")),
          f"{Path(argv[0]).name}: no K2-K4: {by_size}")
    if per_image is not None:
        want = {o: c * images for o, c in per_image.items()}
        check(by_size["K1"] == want,
              f"{Path(argv[0]).name} --tta: K1 {want}: {by_size}")
    return metrics, s, by_size


def tta_phase(torch, np, tmp, files_work, overfit):
    """``python -m iif_torch.cli.test_det --tta`` in the process (two
    views: the config's last scale, with and without a flip), each beside
    its single-view run: the headline config as it stands (1203 classes,
    bf16, 800x1344) with the files phase's checkpoint, the overfit
    phase's config with its trained checkpoint, and the FASA cascade
    config with a seeded checkpoint; TTA_IMAGES seeded LVIS-style PNGs
    (the overfit set for its config). s/image and K1's launches an image
    (MaskRCNN one 7x7 and one 14x14, the cascade three and one, on the
    views as one batch); AP is reported, not gated, beside the single
    view's; the records valid. K1 against its plain version on the
    merged RoIs of the headline config's first image, re-scored on both
    views (f32 and bf16)."""
    from iif_torch.cli import test_det
    from iif_torch.config import Config, parse_cfg_options
    from iif_torch.detection.inference import init_detector
    from iif_torch.detection.init import fresh_init_
    from iif_torch.detection.roi_extractor import SingleRoIExtractor
    from iif_torch.tools.synthetic_lvis import COCO_SIZES, write_synthetic_lvis

    sizes = [COCO_SIZES[i % 3] for i in range(TTA_IMAGES)]
    data = write_synthetic_lvis(str(tmp / "tta"), sizes, NUM_CLASSES,
                                seed=16)
    options = [f"data.test.ann_file={data['ann_file']}",
               f"data.test.img_prefix={data['img_prefix']}"]
    headline = str(REPO / "configs/iif/iif_r50_1x.py")
    cascade = str(REPO / CASCADE_CONFIG)
    cfg = Config.fromfile(cascade)
    cfg.merge_from_options(parse_cfg_options(options))
    det = init_detector(cfg, device="cuda")
    fresh_init_(det.model, torch.Generator().manual_seed(0))
    seeded = tmp / "cascade_seeded.pth"
    torch.save({"state_dict": det.model.state_dict()}, seeded)
    del det
    seen = []
    extract = SingleRoIExtractor.__call__

    def first_image(self, feats, rois):
        out = extract(self, feats, rois)
        if len(seen) < 2:
            seen.append((self.output_size[0],
                         [f.detach().float() for f in feats[:4]],
                         rois.detach().clone()))
        return out

    runs = {}
    plan = (("maskrcnn", headline, files_work, options, TTA_IMAGES,
             {7: 1, 14: 1}),
            ("overfit", overfit["config"], overfit["work"], [],
             overfit["images"], {7: 1, 14: 1}),
            ("cascade", cascade, str(seeded), options, TTA_IMAGES,
             {7: 3, 14: 1}))
    for name, config, ckpt, opts, images, tta_k1 in plan:
        argv = [config, str(ckpt), "--eval", "bbox", "segm"] + (
            ["--cfg-options", *opts] if opts else [])
        single, single_s, _ = tta_run(torch, test_det, argv, images, None)
        out_json = tmp / f"tta_{name}.json"
        with patched((SingleRoIExtractor, "__call__", first_image)) if \
                name == "maskrcnn" else contextlib.nullcontext():
            tta, tta_s, by_size = tta_run(
                torch, test_det, argv + ["--tta", "--out", str(out_json)],
                images, tta_k1)
        records = json.loads(out_json.read_text())
        check(records and {"image_id", "bbox", "score", "segmentation"}
              <= set(records[0]) and all(np.isfinite(r["bbox"]).all()
                                         for r in records),
              f"{name} --tta records valid")
        for m in ("bbox", "segm"):
            check(0.0 <= tta[m]["AP"] <= 1.0, f"{name} --tta {m} AP")
        runs[name] = {
            "tta_s_per_image": tta_s, "single_s_per_image": single_s,
            "k1_launches_per_image": {o: c / images for o, c in
                                      by_size["K1"].items()},
            "records": len(records),
            "ap": {m: {"tta": tta[m]["AP"], "single": single[m]["AP"]}
                   for m in ("bbox", "segm")}}
        log(f"TTA {name}", json.dumps(runs[name]))
    check([o for o, *_ in seen] == [7, 14], "the first TTA image's calls")
    k1 = {}
    for o, feats32, rois in seen:
        check(int(rois[:, 0].max()) == 1, "both views' RoIs")
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, feats32, rois, o, dt)
            check(row["path"] == "vec8", "K1 takes vec8 on the TTA RoIs")
            k1[(o, row["dtype"])] = row
    launches = {
        "tta_maskrcnn": {o: int(c * TTA_IMAGES) for o, c in
                         runs["maskrcnn"]["k1_launches_per_image"].items()},
        "tta_overfit": {o: int(c * overfit["images"]) for o, c in
                        runs["overfit"]["k1_launches_per_image"].items()},
        "tta_cascade": {o: int(c * TTA_IMAGES) for o, c in
                        runs["cascade"]["k1_launches_per_image"].items()}}
    return {"runs": runs, "k1": k1, "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "iif_torch" / "csrc").is_dir():
        print("chip_smoke: the iif_torch package is not beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from iif_torch.ops import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32: cudnn", torch.backends.cudnn.allow_tf32, "matmul",
        torch.backends.cuda.matmul.allow_tf32, "(every timing below)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card", card)
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda, "ninja", shutil.which("ninja"))
    from concurrent.futures import ThreadPoolExecutor

    from iif_torch.native import build as native_build

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        natives = [pool.submit(native_build.build, name)
                   for name in ("rle", "evalmatch")]
        reports = build.build_all()
        natives = [f.result().name for f in natives]
    log(f"kernel build s {time.time() - t0:.3f}", "host libraries", natives)
    ptxas = ptxas_report(reports)
    for fn in ptxas:
        log("ptxas", json.dumps(fn))

    import iif_torch.detection.c4 as c4_mod
    import iif_torch.detection.cascade as cascade_mod
    import iif_torch.detection.detector as detector_mod
    import iif_torch.detection.htc as htc_mod

    kern = kernel_phase(torch, np)
    kern_train, kern_grad = kernel_train_phase(torch, np)
    k3_rows, k3_options = kernel_k3_phase(torch, np)
    k3_train, k4_rows = kernel_k4_phase(torch, np)
    serve = serving_phase(torch, np)
    log("serving", json.dumps({k: v for k, v in serve.items()
                               if k not in ("detector", "image")}),
        "card", card)
    # the cascade's requests are timed before any torch.profiler use too
    cascade = cascade_serving_phase(torch, np)
    cascade_k1 = cascade.pop("k1")
    log("cascade serving", json.dumps({k: v for k, v in cascade.items()
                                       if k not in ("detector", "image")}),
        "card", card)
    htc = htc_serving_phase(torch, np)
    htc_k1 = htc.pop("k1")
    log("HTC serving", json.dumps({k: v for k, v in htc.items()
                                   if k not in ("detector", "image")}),
        "card", card)
    x101 = x101_serving_phase(torch, np)
    x101_k1 = x101.pop("k1")
    log("X101 serving", json.dumps({k: v for k, v in x101.items()
                                    if k not in ("detector", "image")}),
        "card", card)
    prof = profile_phase(torch, serve.pop("detector"), serve.pop("image"),
                         detector_mod, STAGES, "roi_align_ml")
    log("profile b1", json.dumps(prof))
    cascade_prof = profile_phase(torch, cascade.pop("detector"),
                                 cascade.pop("image"), cascade_mod,
                                 CASCADE_STAGES, "roi_align_ml")
    log("cascade profile b1", json.dumps(cascade_prof))
    htc_prof = profile_phase(torch, htc.pop("detector"), htc.pop("image"),
                             (cascade_mod, htc_mod), HTC_STAGES,
                             "roi_align_ml")
    log("HTC profile b1", json.dumps(htc_prof), "card", card)
    x101_prof = profile_phase(torch, x101.pop("detector"),
                              x101.pop("image"), detector_mod, STAGES,
                              "roi_align_ml")
    log("X101 profile b1", json.dumps(x101_prof), "card", card)
    log("backbone_fpn kernel ms at b1: X101",
        x101_prof["stages"]["backbone_fpn"]["kernel_ms"], "R101 (HTC)",
        htc_prof["stages"]["backbone_fpn"]["kernel_ms"], "card", card)
    c4 = c4_serving_phase(torch, np)
    log("C4 serving", json.dumps({k: v for k, v in c4.items()
                                  if k not in ("detector", "image")}),
        "card", card)
    c4_prof = profile_phase(torch, c4.pop("detector"), c4.pop("image"),
                            c4_mod, C4_STAGES, "roi_align_fwd")
    log("C4 profile b1", json.dumps(c4_prof))
    train = training_phase(torch, np)
    log("training", json.dumps(train), "card", card)
    c4_train = c4_training_phase(torch, np)
    log("C4 training", json.dumps(c4_train), "card", card)
    with tempfile.TemporaryDirectory() as tmp:
        files = files_training_phase(torch, np, Path(tmp))
        files_k1, files_k2 = files.pop("k1"), files.pop("k2")
        log("training from files", json.dumps(
            {k: v for k, v in files.items() if k != "work_dir"}),
            "card", card)
        files_work = files.pop("work_dir")
        evaluation = evaluation_phase(torch, np, files_work, Path(tmp))
        eval_feats, eval_rois7, eval_rois14 = evaluation.pop("captured")
        log("evaluation", json.dumps(evaluation), "card", card)
        overfit = overfit_phase(torch, np, Path(tmp))
        overfit_captured = overfit.pop("captured")
        log("overfit", json.dumps({k: v for k, v in overfit.items()
                                   if k not in ("config", "work")}),
            "card", card)
        tta = tta_phase(torch, np, Path(tmp), files_work, overfit)
        tta_k1 = tta.pop("k1")
        log("TTA", json.dumps(tta), "card", card)
        cls_cifar = classification_cifar_phase(torch, np, Path(tmp))
        log("classification CIFAR-100-LT", json.dumps(cls_cifar), "card",
            card)
        cls_lt = classification_lt_phase(torch, np, Path(tmp))
        log("classification ImageNet-LT shape", json.dumps(cls_lt), "card",
            card)
        qat = qat_phase(torch, np, Path(tmp) / "lt")
        log("QAT ImageNet-LT shape", json.dumps(qat), "card", card)
        log("QAT ResNet-50 ms/step", qat["step_ms"]["median"],
            "against phase 12 stage 1 (SE-ResNet-50, the policy, mixup)",
            cls_lt["stage1"]["step_ms"]["median"], "card", card)
    aug = augmentation_phase(torch, np)
    log("augmentation", json.dumps(aug), "card", card)
    families = family_phase(torch, np)
    log("classifier families", json.dumps(families), "card", card)
    cascade_train = cascade_training_phase(torch, np)
    ctrain_k1, ctrain_k2 = cascade_train.pop("k1"), cascade_train.pop("k2")
    log("cascade FASA training", json.dumps(cascade_train), "card", card)
    with tempfile.TemporaryDirectory() as tmp:
        fasa_cli = fasa_cli_phase(torch, np, Path(tmp))
    log("FASA dynamic runner", json.dumps(fasa_cli), "card", card)
    fasa_r50 = fasa_r50_phase(torch, np)
    log("FASA MaskRCNN R50", json.dumps(fasa_r50), "card", card)
    htc_train = htc_training_phase(torch, np)
    htrain_k1, htrain_k2 = htc_train.pop("k1"), htc_train.pop("k2")
    log("HTC training", json.dumps(htc_train), "card", card)
    with tempfile.TemporaryDirectory() as tmp:
        htc_cli = htc_cli_phase(torch, np, Path(tmp))
    log("HTC CLIs", json.dumps(htc_cli), "card", card)
    x101_train = x101_training_phase(torch, np)
    xtrain_k1, xtrain_k2 = x101_train.pop("k1"), x101_train.pop("k2")
    log("X101 training", json.dumps(x101_train), "card", card)
    log("backbone_fpn kernel ms a b4 step: X101",
        x101_train["profile"]["stages"]["backbone_fpn"]["kernel_ms"],
        "R101 (HTC)",
        htc_train["profile"]["stages"]["backbone_fpn"]["kernel_ms"],
        "card", card)
    sig_cascade = sigmoid_cascade_phase(torch, np)
    log("sigmoid cascade R50", json.dumps(sig_cascade), "card", card)
    seesaw = seesaw_phase(torch, np)
    log("Seesaw", json.dumps(seesaw), "card", card)
    with tempfile.TemporaryDirectory() as tmp:
        rsb = rsb_phase(torch, np, Path(tmp))
    log("RSB + grad_accum", json.dumps(rsb), "card", card)
    eval_k1 = {}
    for o, rois in ((7, eval_rois7), (14, eval_rois14)):
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, eval_feats, rois, o, dt)
            eval_k1[(o, row["dtype"])] = row
    del eval_feats
    overfit_k1, overfit_k2 = {}, {}
    rng = np.random.RandomState(6)
    for o in (7, 14):
        feats32, rois = overfit_captured[o]
        g32 = torch.tensor(rng.randn(rois.shape[0], o, o, 256),
                           dtype=torch.float32, device=rois.device)
        for dt in (torch.float32, torch.bfloat16):
            row = k1_row(torch, feats32, rois, o, dt)
            overfit_k1[(o, row["dtype"])] = row
            row = k2_row(torch, feats32, rois, g32, o, dt)
            overfit_k2[(o, row["dtype"])] = row

    # one entry per kernel, output size and path shape: K1 at the serving
    # shapes with the serving paths' launches, K1 and K2 at the training
    # shapes with the training path's
    kernels = []
    k1_paths = [(kern, "", serve["launches"]),
                (kern_train, "_train", {"train": train["launches"]["K1"]})]
    for rows, suffix, paths in k1_paths:
        for o in (7, 14):
            row = rows[(o, "bfloat16")]
            kernels.append({
                "name": f"roi_align_ml_{o}x{o}{suffix}", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES["K1"],
                "launches": sum(c.get(o, 0) for c in paths.values()),
                "launches_by_path": {p: c.get(o, 0)
                                     for p, c in paths.items()},
                "max_abs_err": row["max_abs_err"],
                "max_err_ulps": row["max_err_ulps"],
                "tolerance": row["tolerance"],
                "f32_max_abs_err": rows[(o, "float32")]["max_abs_err"],
                "f32_tolerance": F32_TOL,
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "kernel_ms": row["kernel_ms"],
                "path": row["path"], "bound_share": row["bound_share"],
                "kernel_bound_share": row["kernel_bound_share"],
                "f32_ms": rows[(o, "float32")]["ms"],
                "f32_kernel_ms": rows[(o, "float32")]["kernel_ms"],
                "shape": f"R={row['R']} bf16 LVIS levels B={row['B']} "
                         "C=256"})
            if o == 7 and "pair" in rows:
                pair = rows["pair"]
                kernels[-1]["pair"] = {
                    k: pair[k] for k in ("ms", "kernel_ms", "bound_share",
                                         "kernel_bound_share",
                                         "max_abs_err", "max_err_ulps",
                                         "storage_offset")}
    for o in (7, 14):
        row = kern_grad[(o, "bfloat16")]
        kernels.append({
            "name": f"roi_align_ml_grad_{o}x{o}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES["K2"],
            "launches": train["launches"]["K2"].get(o, 0),
            "launches_by_path": {"train": train["launches"]["K2"].get(o, 0)},
            "max_abs_err": row["max_abs_err"],
            "tolerance": row["tolerance"],
            "f32_max_abs_err": kern_grad[(o, "float32")]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "kernel_ms": row["kernel_ms"],
            "path": row["path"], "bound_share": row["bound_share"],
            "kernel_bound_share": row["kernel_bound_share"],
            "f32_ms": kern_grad[(o, "float32")]["ms"],
            "f32_kernel_ms": kern_grad[(o, "float32")]["kernel_ms"],
            "shape": f"R={row['R']} bf16 LVIS levels B={row['B']} C=256, "
                     "through autograd; kernel_ms the C entry (memset, "
                     "kernel, cast)"})
    row, row2 = k3_rows[(1, "bfloat16")], k3_rows[(2, "bfloat16")]
    by_path = {p: c["K3"] for p, c in c4["launches"].items()}
    kernels.append({
        "name": "roi_align_14x14_c4", "route": "cuda",
        "source": K3_SOURCE, "replaces": REPLACES["K3"],
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": row["max_abs_err"], "tolerance": F32_TOL,
        "f32_max_abs_err": k3_rows[(1, "float32")]["max_abs_err"],
        "b2_max_abs_err": max(k3_rows[(2, d)]["max_abs_err"]
                              for d in ("float32", "bfloat16")),
        "options_max_abs_err": max(k3_options.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "kernel_ms": row["kernel_ms"],
        "path": row["path"], "bound_share": row["bound_share"],
        "kernel_bound_share": row["kernel_bound_share"],
        "f32_ms": k3_rows[(1, "float32")]["ms"],
        "f32_kernel_ms": k3_rows[(1, "float32")]["kernel_ms"],
        "b2": {k: row2[k] for k in ("ms", "kernel_ms", "plain_ms",
                                    "bound_ms", "bound_share",
                                    "kernel_bound_share")},
        "pair": {k: k3_rows["pair"][k] for k in (
            "ms", "kernel_ms", "bound_share", "kernel_bound_share",
            "max_abs_err", "storage_offset")},
        "shape": "R=1000 B=1 bf16 C4 map 50x84x1024 -> f32 (b2: R=2000 "
                 "B=2); plain version in chunks of 100 RoIs"})
    # K3 and K4 at the C4 training shapes, with the C4 training path's
    # launches
    shape = (f"R={C4_TRAIN_ROIS} B={TRAIN_BATCH} bf16 C4 map 50x84x1024, "
             "14x14")
    for name, rows, key, source, note in (
            ("roi_align_14x14_c4_train", k3_train, "K3", K3_SOURCE,
             "; plain version in chunks of 100 RoIs"),
            ("roi_align_grad_14x14_c4_train", k4_rows, "K4", K3_SOURCE,
             ", through autograd; plain backward in chunks of 128 RoIs")):
        row = rows["bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[key],
            "launches": c4_train["launches"][key],
            "launches_by_path": {"c4_train": c4_train["launches"][key]},
            "max_abs_err": row["max_abs_err"],
            "tolerance": row["tolerance"],
            "f32_max_abs_err": rows["float32"]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "f32_ms": rows["float32"]["ms"],
            "shape": shape + note})
        kernels[-1].update({k: row[k] for k in (
            "kernel_ms", "path", "bound_share", "kernel_bound_share")})
        kernels[-1]["f32_kernel_ms"] = rows["float32"]["kernel_ms"]
        if key == "K4":
            kernels[-1]["pair"] = rows["pair"]
    # K1 and K2 on the files path (one step's own features and RoIs on a
    # bucket below 800), K1 on the evaluation path (the first batch's) and
    # K1 and K2 on the overfit path (its first step's), each with that
    # path's launches
    paths = [
        ("files", "train_from_files", files["launches"],
         {"K1": files_k1, "K2": files_k2},
         f"on the {files['kernel_bucket']} bucket's levels "
         f"{files['kernel_levels']}, a training step's own features and "
         "RoIs"),
        ("eval", "evaluation", {"K1": evaluation["launches"]},
         {"K1": eval_k1}, "on the 800x1344 canvas's levels, the first "
         "evaluation batch's own features and RoIs"),
        ("overfit", "overfit", overfit["launches"],
         {"K1": overfit_k1, "K2": overfit_k2}, "on the 96x128 canvas's "
         "levels, the first overfit step's own features and RoIs")]
    for suffix, path_name, path_launches, by_key, where in paths:
        for key, rows in by_key.items():
            for o in (7, 14):
                kernels.append(path_row(
                    rows, o, key, suffix,
                    {path_name: path_launches[key].get(o, 0)}, where))
    # K1 on the cascade serving path's stage-3 and mask RoIs, K1 and K2 on
    # the cascade training step's stage-3 RoIs, each with its path's
    # launches
    serve_by_size = {o: sum(c.get(o, 0) for c in cascade["launches"].values())
                     for o in (7, 14)}
    cascade_rows = {(7, d): cascade_k1[("stage2", d)] for d in (
        "float32", "bfloat16")}
    cascade_rows.update({(14, d): cascade_k1[("mask", d)] for d in (
        "float32", "bfloat16")})
    for o in (7, 14):
        kernels.append(path_row(
            cascade_rows, o, "K1", "cascade",
            {"cascade_serving": serve_by_size[o]},
            "on the 800x1344 canvas's levels, a served request's own maps "
            "and " + ("stage-3 RoIs" if o == 7 else "detections")))
        if o == 7:
            kernels[-1]["stages_max_abs_err"] = {
                f"{st}_{d}": cascade_k1[(st, d)]["max_abs_err"]
                for st in ("stage0", "stage1", "stage2")
                for d in ("float32", "bfloat16")}
        for key, rows in (("K1", ctrain_k1), ("K2", ctrain_k2)):
            kernels.append(path_row(
                rows, o, key, "cascade_train",
                {"cascade_training": cascade_train["launches"][key][o]},
                "on the 800x1344 canvas's levels, a training step's own "
                "maps and stage-3 RoIs"))
    # K1 on the HTC serving path's stage-3 RoIs and detections, K1 and K2
    # on the HTC training step's stage-3 RoIs, K1 on the X101 serving
    # request's RoIs and K1 and K2 on its training step's, each with its
    # path's launches
    htc_serve_by_size = htc["launches_by_size"]["K1"]
    htc_rows = {(7, d): htc_k1[("stage2", d)] for d in ("float32",
                                                       "bfloat16")}
    htc_rows.update({(14, d): htc_k1[("mask", d)] for d in ("float32",
                                                            "bfloat16")})
    for o in (7, 14):
        kernels.append(path_row(
            htc_rows, o, "K1", "htc", {"htc_serving": htc_serve_by_size[o]},
            "on the 800x1344 canvas's levels, a served HTC request's own "
            "maps and " + ("stage-3 RoIs" if o == 7 else "detections")))
        if o == 7:
            kernels[-1]["stages_max_abs_err"] = {
                f"{st}_{d}": htc_k1[(st, d)]["max_abs_err"]
                for st in ("stage0", "stage1", "stage2")
                for d in ("float32", "bfloat16")}
        for key, rows in (("K1", htrain_k1), ("K2", htrain_k2)):
            kernels.append(path_row(
                rows, o, key, "htc_train",
                {"htc_training": htc_train["launches"][key][o]},
                "on the 800x1344 canvas's levels, an HTC training step's "
                "own maps and stage-3 RoIs (" + ("refined, re-sampled "
                "mask RoIs" if o == 14 else "box RoIs") + ")"))
            kernels[-1]["stages_f32_max_abs_err"] = {
                k: v for k, v in htc_train["stages_f32_max_abs_err"].items()
                if k.startswith(key + "_") and k.endswith(f"{o}x{o}")}
        kernels.append(path_row(
            x101_k1, o, "K1", "x101",
            {"x101_serving": x101["launches"][o]},
            "on the 800x1344 canvas's levels, a served X101 request's own "
            "maps and RoIs"))
        for key, rows in (("K1", xtrain_k1), ("K2", xtrain_k2)):
            kernels.append(path_row(
                rows, o, key, "x101_train",
                {"x101_training": x101_train["launches_by_size"][key][o]},
                "on the 800x1344 canvas's levels, an X101 training step's "
                "own maps and RoIs"))
    # K1 on the merged TTA RoIs of the headline config's first image,
    # re-scored on both views (the second flipped), with the TTA paths'
    # launches
    for o in (7, 14):
        kernels.append(path_row(
            tta_k1, o, "K1", "tta",
            {p: tta["launches"][p].get(o, 0) for p in (
                "tta_maskrcnn", "tta_overfit", "tta_cascade")},
            "on the 800x1344 canvas's levels of two views (a flip), the "
            "merged " + ("proposals" if o == 7 else "detections") +
            " of a --tta image"))
    # the FASA and activations families' paths: each row gets its own
    # output size's count
    family_paths = {"cascade_serving": cascade["launches_by_size"],
                    "cascade_training": cascade_train["launches_by_size"],
                    "fasa_train_cli": fasa_cli["launches_train"],
                    "fasa_val": fasa_cli["launches_val"],
                    "fasa_r50": fasa_r50["launches_by_size"],
                    "htc_serving": htc["launches_by_size"],
                    "htc_training": htc_train["launches_by_size"],
                    "htc_train_cli": htc_cli["launches_train"],
                    "htc_test_cli": htc_cli["launches_test"],
                    "htc_http": htc_cli["launches_http"],
                    "x101_serving": x101["launches_by_size"],
                    "x101_training": x101_train["launches_by_size"],
                    "sigmoid_cascade_training":
                        sig_cascade["launches_by_size"],
                    "seesaw_serving": seesaw["serving_launches_by_size"],
                    "seesaw_training": seesaw["launches_by_size"],
                    "rsb_train_cli": rsb["launches_train"],
                    "rsb_val": rsb["launches_val"],
                    "rsb_training": rsb["launches_by_size"],
                    "tta_maskrcnn": {"K1": tta["launches"]["tta_maskrcnn"],
                                     "K2": {}, "K3": {}, "K4": {}},
                    "tta_overfit": {"K1": tta["launches"]["tta_overfit"],
                                    "K2": {}, "K3": {}, "K4": {}},
                    "tta_cascade": {"K1": tta["launches"]["tta_cascade"],
                                    "K2": {}, "K3": {}, "K4": {}}}
    for row in kernels:
        side = int(re.search(r"_(\d+)x\1(_|$)", row["name"]).group(1))
        for path, counts in family_paths.items():
            row["launches_by_path"].setdefault(
                path, counts[KERNEL_OF[row["replaces"]]].get(side, 0))
        row["launches_by_path"]["classification_cifar"] = \
            cls_cifar["launches"][KERNEL_OF[row["replaces"]]]
        row["launches_by_path"]["classification_imagenet_lt"] = \
            cls_lt["launches"][KERNEL_OF[row["replaces"]]]
        for path, res in (("qat", qat), ("augmentation", aug),
                          ("classifier_families", families)):
            row["launches_by_path"][path] = \
                res["launches"][KERNEL_OF[row["replaces"]]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def path_row(rows, o, key, suffix, launches_by_path, where):
    """The ``kernels`` entry of K1 or K2 (``key``) at ``o`` on one path:
    its bf16 row of ``rows``, the f32 row's error, the path's launches."""
    row = rows[(o, "bfloat16")]
    return {"name": ("roi_align_ml" if key == "K1" else
                     "roi_align_ml_grad") + f"_{o}x{o}_{suffix}",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES[key],
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": row["max_abs_err"],
            "tolerance": row["tolerance"],
            "f32_max_abs_err": rows[(o, "float32")]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "kernel_ms": row["kernel_ms"],
            "path": row["path"], "bound_share": row["bound_share"],
            "kernel_bound_share": row["kernel_bound_share"],
            "shape": f"R={row['R']} bf16 B={row['B']} C=256 {where}"}


if __name__ == "__main__":
    sys.exit(main())
