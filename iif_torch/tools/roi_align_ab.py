#!/usr/bin/env python3
"""Times of the RoIAlign kernels K1-K4 at the main paths' shapes, to
compare two checkouts, or builds of one, in one run on one card.

    python3 iif_torch/tools/roi_align_ab.py [--tree DIR] [--variants K2,K4,...]
        [--reduction-rate]

The inputs are those of this checkout's ``chip_smoke.py`` kernel phases
(the same seeds and builders, bf16 maps), and three more cases: the C4
training RoIs with their pile of 128 small RoIs on one cell replaced by
RoIs drawn like the others, to show what that contention costs; and K2
and K4 on the RoIs of the first step of ``chip_smoke.py``'s MaskRCNN and
C4 trainers (the main paths: the same configs, fresh init, seed and
batch), with a seeded random gradient. The kernels are those of the
checkout at ``--tree`` (default: this one), built there. Each shape
prints one JSON line: ``kernel_ms``, the kernel's device time
(``graph_ms`` of the wrapper's launch function for K1 and K3, of the C
entry alone for K2 and K4: memset, kernel and, for K2 at bf16, its cast),
and ``call_ms``, the wrapper call's (``cuda_ms``; K2 and K4 through
autograd), with the card's name and power limit on the first line.

``--variants`` also times builds of this checkout's sources with one
change each (``VARIANTS``, the alternatives that the sources' notes
cite): those named, and those of the kernels named, in two rounds, the
second in reverse order, each build's output held against the plain
version's in the first; the ``ptxas`` report of each build is printed
with it. ``--reduction-rate`` also builds and runs ``reduction_rate.cu``:
the card's rate of f32, float2 and float4 reductions into global memory.
"""
import argparse
import contextlib
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def small_rows(value):
    """A variant of the backward kernels' kSmallRows: the row slots up to
    which a RoI takes 8 consecutive channels an item."""
    return (("K2", "K4"), [("roi_align_common.cuh", r"kSmallRows = \d+;",
                            f"kSmallRows = {value};", 1)])


# Build variants, each an alternative that a source note cites: name ->
# (the kernels timed, [(file under csrc, pattern, replacement, matches)])
VARIANTS = {
    # K3's f32 output written with plain stores, not streaming ones
    "plain_stores": (("K3",), [("roi_align_common.cuh",
                                r"__stcs\((q(?: \+ 1)?), ", r"*(\1) = (", 2)]),
    # K3's bin rows summed by bin_row_plain, K1's loop
    "plain_loop": (("K3",), [("roi_align.cu",
                              r"forward_roi<T, float, V, S, true>",
                              "forward_roi<T, float, V, S, false>", 1)]),
    # the backward's items with the channels innermost across all of C
    "channels_innermost": (("K2", "K4"), [(
        "roi_align_common.cuh",
        r"return vecs < kChunkVecs \? vecs : kChunkVecs;", "return vecs;",
        1)]),
    # 32-bit offsets inside a RoI's gradient and its image
    "offsets_32": (("K2", "K4"), [
        ("roi_align_common.cuh", r"\(size_t\)ys.cell\[k\]", "ys.cell[k]", 1),
        ("roi_align_common.cuh", r"\(\(size_t\)ph \* out_w \+ pw\)",
         "(ph * out_w + pw)", 1),
        ("roi_align_common.cuh", r"\(size_t\)xs.cell\[j\]", "xs.cell[j]", 2)]),
    # a RoI's idle blocks return only after they build its rows
    "no_early_exit": (("K2", "K4"), [
        (path, r"  if \(!has_items\(rows_max[^\n]*\n", "", 1)
        for path in ("roi_align.cu", "roi_align_ml.cu")]),
    # every RoI on two runs of 4 channels an item, or on 8 consecutive
    # ones, or the rule's bound at 4 or 16 row slots
    "small_rows_0": small_rows(0),
    "small_rows_4": small_rows(4),
    "small_rows_16": small_rows(16),
    "small_rows_all": small_rows(1 << 20),
    # K4 with one item a thread, K2 with two, for a RoI of out * s + 1
    # rows (their kPasses)
    "k4_one_pass": (("K4",), [("roi_align.cu", r"kPasses = \d+;",
                               "kPasses = 1;", 1)]),
    "k2_two_passes": (("K2",), [("roi_align_ml.cu", r"kPasses = \d+;",
                                 "kPasses = 2;", 1)]),
}
LIBRARY = {"K1": "roi_align_ml", "K2": "roi_align_ml", "K3": "roi_align",
           "K4": "roi_align"}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(cs, torch, np):
    """(kernel, shape, inputs) of the kernel phases, drawn as they draw
    them."""
    out = []

    def bf16(a):                    # through f32, as the phases round
        return torch.tensor(a, dtype=torch.float32,
                            device="cuda").to(torch.bfloat16)

    def levels(rng, b):
        return [bf16(rng.randn(b, h, w, 256)) for h, w in cs.LVIS_LEVELS]

    rng = np.random.RandomState(0)
    feats = levels(rng, 2)
    for o, r in ((7, 2000), (14, 600)):
        out.append(("K1", f"{o}x{o} R={r} B=2",
                    (feats, cs.make_rois(rng, r, "cuda"), o)))
    rng = np.random.RandomState(3)
    feats = levels(rng, cs.TRAIN_BATCH)
    for o, r in ((7, 512 * cs.TRAIN_BATCH), (14, 128 * cs.TRAIN_BATCH)):
        shape = f"{o}x{o} R={r} B={cs.TRAIN_BATCH} train"
        rois = cs.make_train_rois(rng, r, "cuda")
        out.append(("K1", shape, (feats, rois, o)))
        out.append(("K2", shape, (feats, rois, bf16(rng.randn(r, o, o, 256)),
                                  o)))
    rng = np.random.RandomState(4)
    for b in (1, 2):
        feat = bf16(rng.randn(b, *cs.C4_MAP, cs.C4_CHANNELS))
        rois = cs.make_c4_rois(rng, cs.C4_ROIS * b, b, "cuda")
        out.append(("K3", f"14x14 R={cs.C4_ROIS * b} B={b}", (feat, rois)))
    rng = np.random.RandomState(5)
    feat = bf16(rng.randn(cs.TRAIN_BATCH, *cs.C4_MAP, cs.C4_CHANNELS))
    shape = f"14x14 R={cs.C4_TRAIN_ROIS} B={cs.TRAIN_BATCH} train"
    rois = cs.make_c4_train_rois(rng, "cuda")
    out.append(("K3", shape, (feat, rois)))
    g = torch.tensor(rng.randn(cs.C4_TRAIN_ROIS, 14, 14, cs.C4_CHANNELS),
                     dtype=torch.float32, device="cuda")
    out.append(("K4", shape, (feat, rois, g)))
    # the same RoIs with the pile (10:138) drawn like the others
    spread = rois.clone()
    spread[10:138] = cs.make_c4_rois(np.random.RandomState(6), 128,
                                     cs.TRAIN_BATCH, "cuda")
    out.append(("K4", shape + " no pile", (feat, spread, g)))
    return out + step_cases(cs, torch, np)


def first_step_inputs(cs, torch, np, c4):
    """The RoIAlign inputs of the first training step of ``chip_smoke.py``'s
    MaskRCNN trainer (``c4`` false: {o: (levels, rois)} of the RoI
    extractor's calls) or its C4 trainer (``c4``: {14: (map, rois)}): the
    same config, fresh init, seed and synthetic b4 batch, so the RoIs are
    those the main path's K2 or K4 gets at its first step."""
    import iif_torch.detection.c4 as c4_mod
    import iif_torch.detection.roi_extractor as extractor_mod
    from iif_torch.config import Config
    from iif_torch.detection.datasets import build_dataset
    from iif_torch.detection.inference import build_loss_cls
    from iif_torch.engine.detection import trainer_from_config

    if c4:
        cfg = Config.fromfile(str(REPO / cs.C4_CONFIG))
        classes, images = cs.C4_CLASSES, cs.COCO_TRAIN_IMAGES
        loss_cls = build_loss_cls(cfg.loss_cls, None, classes)
        mod, name = c4_mod, "roi_align"
    else:
        cfg = Config.fromfile(str(REPO / "configs/iif/iif_r50_1x.py"))
        classes, images = cs.NUM_CLASSES, cs.LVIS_IMAGES
        ann = cs.BUILD / "lvis_v1_synthetic.json"
        ann.parent.mkdir(parents=True, exist_ok=True)
        cs.write_lvis_annotations(np, ann)
        cfg.data["train"]["ann_file"] = str(ann)
        train_ds = build_dataset({k: v for k, v in cfg.data["train"].items()
                                  if k != "oversample_thr"})
        loss_cls = build_loss_cls(cfg.loss_cls, train_ds, classes)
        mod, name = extractor_mod, "roi_align_ml"
    trainer = trainer_from_config(
        cfg, loss_cls, images // cfg.data["samples_per_gpu"], device="cuda")
    batch = cs.synthetic_train_batch(np, torch, "cuda", classes,
                                     with_masks=not c4)
    seen = {}
    inner = getattr(mod, name)

    def capture(feat, rois, out_size, *args, **kwargs):
        o = out_size if isinstance(out_size, int) else out_size[0]
        if o not in seen:
            detach = (lambda t: [f.detach() for f in t]) if not c4 else (
                lambda t: t.detach().contiguous())
            seen[o] = (detach(feat), rois.detach().clone())
        return inner(feat, rois, out_size, *args, **kwargs)

    setattr(mod, name, capture)
    try:
        trainer.train_step(trainer.init_state(), batch)
    finally:
        setattr(mod, name, inner)
    torch.cuda.synchronize()
    return seen


def step_cases(cs, torch, np):
    """K2 and K4 on the RoIs of the main paths' first training step, with
    a seeded random gradient in the step's dtype (bf16 for K2, f32 for
    K4)."""
    out = []
    rng = np.random.RandomState(8)
    for o, (feats, rois) in sorted(first_step_inputs(cs, torch, np,
                                                     False).items()):
        g = torch.tensor(rng.randn(rois.shape[0], o, o, feats[0].shape[-1]),
                         dtype=torch.float32, device="cuda").to(feats[0].dtype)
        out.append(("K2", f"{o}x{o} R={rois.shape[0]} MaskRCNN step",
                    (feats, rois, g, o)))
    (feat, rois), = first_step_inputs(cs, torch, np, True).values()
    g = torch.tensor(rng.randn(rois.shape[0], 14, 14, feat.shape[-1]),
                     dtype=torch.float32, device="cuda")
    out.append(("K4", f"14x14 R={rois.shape[0]} C4 step", (feat, rois, g)))
    return out


STRIDES = (4, 8, 16, 32)


def k2_entry(k12, feats, rois, g, o):
    """K2's C entry alone on buffers allocated once. A tree from before
    the backward's path choice has no ``_bwd_buffers`` and its entry takes
    no path: it gets the same buffers and call without one."""
    import torch

    shapes = [tuple(f.shape) for f in feats]
    lvl, bidx = k12._roi_meta(rois, 4, 56.0)
    if hasattr(k12, "_bwd_buffers"):
        acc, out, gk, path = k12._bwd_buffers(shapes, g.dtype, g)
        return lambda: k12._bwd_call(acc, out, gk, path, shapes, rois, lvl,
                                     bidx, o, 2, STRIDES)
    sizes = [math.prod(shp) for shp in shapes]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    acc = torch.empty(sum(sizes), dtype=torch.float32, device="cuda")
    out = torch.empty(sum(sizes), dtype=g.dtype, device="cuda")
    fn = k12._fn("iif_roi_align_ml_bwd", k12._BWD_ARGS)
    return lambda: fn(
        acc.data_ptr(), out.data_ptr(), acc.numel(), *offs,
        *k12._level_dims(shapes), *[float(st) for st in STRIDES],
        rois.data_ptr(), lvl.data_ptr(), bidx.data_ptr(), g.data_ptr(),
        rois.shape[0], shapes[0][-1], o, 2, k12._DTYPES[g.dtype],
        torch.cuda.current_stream().cuda_stream)


def k4_entry(k34, feat, rois, g):
    """K4's C entry alone on buffers allocated once (memset and kernel);
    a tree from before the path choice as in ``k2_entry``."""
    import torch

    shape = tuple(feat.shape)
    if hasattr(k34, "_bwd_buffers"):
        acc, gk, path = k34._bwd_buffers(shape, g)
        return lambda: k34._bwd_call(acc, gk, path, rois, 14, 14, 2, 1 / 16,
                                     True)
    acc = torch.empty(shape, dtype=torch.float32, device="cuda")
    fn = k34._fn("iif_roi_align_bwd", k34._BWD_ARGS)
    return lambda: fn(acc.data_ptr(), *shape, rois.data_ptr(), g.data_ptr(),
                      rois.shape[0], 14, 14, 2, 1 / 16, 1,
                      torch.cuda.current_stream().cuda_stream)


def time_case(cs, kernel, args):
    import torch

    from iif_torch.ops import roi_align as k34
    from iif_torch.ops import roi_align_ml as k12

    if kernel == "K1":
        feats, rois, o = args
        lvl, bidx = k12._roi_meta(rois, 4, 56.0)
        kernel_ms = cs.graph_ms(lambda: k12._launch_fwd(
            feats, rois, lvl, bidx, o, 2, STRIDES))
        call_ms = cs.cuda_ms(lambda: k12.roi_align_ml(feats, rois, (o, o)))
    elif kernel == "K2":
        feats, rois, g, o = args
        kernel_ms = cs.graph_ms(k2_entry(k12, feats, rois, g, o))
        leaves = [f.detach().requires_grad_() for f in feats]
        out = k12.roi_align_ml(leaves, rois, (o, o))
        call_ms = cs.cuda_ms(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True))
    elif kernel == "K3":
        feat, rois = args
        kernel_ms = cs.graph_ms(lambda: k34._launch(feat, rois, 14, 14, 2,
                                                    1 / 16, True))
        call_ms = cs.cuda_ms(lambda: k34.roi_align(feat, rois, (14, 14),
                                                   1 / 16))
    else:
        feat, rois, g = args
        kernel_ms = cs.graph_ms(k4_entry(k34, feat, rois, g))
        leaf = feat.detach().requires_grad_()
        out = k34.roi_align(leaf, rois, (14, 14), 1 / 16)
        call_ms = cs.cuda_ms(lambda: torch.autograd.grad(
            out, leaf, g, retain_graph=True))
    return {"kernel_ms": kernel_ms, "call_ms": call_ms}


@contextlib.contextmanager
def built_from(build, csrc, names):
    """The wrappers of libraries ``names`` on builds from the sources in
    ``csrc``; yields each one's ``ptxas`` report."""
    saved = build.CSRC, build.BUILD_DIR
    if csrc != build.CSRC:
        build.CSRC, build.BUILD_DIR = csrc, csrc.parent / "lib"
    for name in names:
        build._libs.pop(name, None)
    try:
        yield {name: build.build(name) for name in names}
    finally:
        build.CSRC, build.BUILD_DIR = saved
        for name in names:
            build._libs.pop(name, None)


def variant_sources(build, name):
    """This checkout's csrc copied under build/, with variant ``name``'s
    changes made."""
    dst = REPO / "build" / "roi_align_variants" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(build.CSRC, dst)
    for path, pattern, repl, count in VARIANTS[name][1]:
        src = (dst / path).read_text()
        new, n = re.subn(pattern, repl, src)
        if n != count:
            raise RuntimeError(f"variant {name}: {n} matches of {pattern!r} "
                               f"in {path}, expected {count}")
        (dst / path).write_text(new)
    return dst


def max_error(cs, kernel, args):
    """The kernel's largest difference from its plain version on a
    case."""
    import torch

    from iif_torch.ops import roi_align as k34
    from iif_torch.ops import roi_align_ml as k12

    if kernel == "K3":
        feat, rois = args
        got = k34.roi_align(feat, rois, (14, 14), 1 / 16)
        want = cs.plain_single_chunked(feat, rois, (14, 14), 1 / 16)
        return (got - want).abs().max().item()
    if kernel == "K4":
        feat, rois, g = args
        leaf = feat.detach().requires_grad_()
        got = torch.autograd.grad(k34.roi_align(leaf, rois, (14, 14),
                                                1 / 16), leaf, g)[0]
        want = cs.plain_single_grad_chunked(feat, rois, g)
        return (got.float() - want.float()).abs().max().item()
    feats, rois, g, o = args
    leaves = [f.detach().requires_grad_() for f in feats]
    got = torch.autograd.grad(k12.roi_align_ml(leaves, rois, (o, o)), leaves,
                              g)
    want = k12.roi_align_ml_grad_reference(feats, rois, g.float(), (o, o))
    return max((a.float() - w.float()).abs().max().item()
               for a, w in zip(got, want))


def run_variants(cs, wanted, all_cases):
    """The variants named in ``wanted`` and every variant that changes a
    kernel named there, and the base build, in two rounds (the second in
    reverse order): each of its kernels' cases timed, and in the first
    round its error and its ``ptxas`` report."""
    from iif_torch.ops import build

    names = [n for n, (ks, _) in VARIANTS.items()
             if n in wanted or set(ks) & set(wanted)]
    kernels = sorted({k for n in names for k in VARIANTS[n][0]})
    builds = {"base": build.CSRC}
    builds.update((name, variant_sources(build, name)) for name in names)
    order = list(builds)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            timed = kernels if name == "base" else [
                k for k in VARIANTS[name][0] if k in kernels]
            libs = sorted({LIBRARY[k] for k in timed})
            with built_from(build, builds[name], libs) as reports:
                if rnd == 0:
                    for fn in cs.ptxas_report(reports):
                        cs.log("ptxas", name, json.dumps(fn))
                for kernel, shape, inputs in all_cases:
                    if kernel not in timed:
                        continue
                    row = {"kernel": kernel, "build": name, "round": rnd,
                           "shape": shape}
                    row.update(time_case(cs, kernel, inputs))
                    if rnd == 0:
                        row["max_abs_err"] = max_error(cs, kernel, inputs)
                    cs.log(json.dumps(row))


def reduction_rate(cs, build):
    """Build ``reduction_rate.cu`` (this checkout) under build/ and log
    its lines."""
    src = REPO / "iif_torch" / "tools" / "reduction_rate.cu"
    exe = REPO / "build" / "reduction_rate"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), "-O3", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-o", str(exe), str(src)],
                   check=True)
    for line in subprocess.run([str(exe)], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        cs.log("reduction_rate", line)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=REPO,
                        help="checkout whose kernels are timed")
    parser.add_argument("--reduction-rate", action="store_true",
                        help="also time the card's f32 reductions into "
                             "global memory (reduction_rate.cu)")
    parser.add_argument("--variants", default="",
                        help="comma-separated build variants, or kernels "
                             "(K2, K3, K4) whose variants, also to time "
                             "(this checkout)")
    args = parser.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("roi_align_ab: CUDA is not available", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from iif_torch.ops import build

    if Path(build.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"iif_torch imported from {build.__file__}, not "
                           f"from {tree}")
    variants = [k for k in args.variants.split(",") if k]
    if variants and tree != REPO:
        raise RuntimeError("--variants builds this checkout's sources")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log("card", card, "tree", str(tree))
    build.build_all()
    all_cases = cases(cs, torch, np)
    for kernel, shape, inputs in all_cases:
        row = {"kernel": kernel, "tree": tree.name, "shape": shape}
        row.update(time_case(cs, kernel, inputs))
        cs.log(json.dumps(row))
    if variants:
        run_variants(cs, variants, all_cases)
    if args.reduction_rate:
        reduction_rate(cs, build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
