#!/usr/bin/env python3
"""Times of the RoIAlign forward kernels K1 and K3 at the main paths'
shapes, to compare two checkouts, or two builds of K3, in one run on one
card.

    python3 iif_torch/tools/roi_align_ab.py [--tree DIR] [--k3-variants]

The inputs are those of this checkout's ``chip_smoke.py`` kernel phases
(the same seeds and builders, bf16 maps); the kernels are those of the
checkout at ``--tree`` (default: this one), built there. Each shape prints
one JSON line: ``kernel_ms``, the kernel's device time (``graph_ms`` of
the wrapper's launch function), and ``call_ms``, the wrapper call's
(``cuda_ms``), with the card's name and power limit on the first line.

``--k3-variants`` also times K3 built from this checkout's sources with one
change each (``VARIANTS``), in two rounds, the second in reverse order,
each build's output held against the plain version's; the ``ptxas``
report of each build's K3 instantiations is printed with it.
"""
import argparse
import contextlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# K3's build variants: (file under csrc, pattern, replacement, matches)
VARIANTS = {
    # the f32 output written with plain stores, not streaming ones
    "plain_stores": ("roi_align_common.cuh", r"__stcs\((q(?: \+ 1)?), ",
                     r"*(\1) = (", 2),
    # K3's bin rows summed by bin_row_plain, K1's loop
    "plain_loop": ("roi_align.cu", r"forward_roi<T, float, V, S, true>",
                   "forward_roi<T, float, V, S, false>", 1),
}


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
        out.append(("K1", f"{o}x{o} R={r} B={cs.TRAIN_BATCH} train",
                    (feats, cs.make_train_rois(rng, r, "cuda"), o)))
        rng.randn(r, o, o, 256)                 # the phase's gradient
    rng = np.random.RandomState(4)
    for b in (1, 2):
        feat = bf16(rng.randn(b, *cs.C4_MAP, cs.C4_CHANNELS))
        rois = cs.make_c4_rois(rng, cs.C4_ROIS * b, b, "cuda")
        out.append(("K3", f"14x14 R={cs.C4_ROIS * b} B={b}", (feat, rois)))
    rng = np.random.RandomState(5)
    feat = bf16(rng.randn(cs.TRAIN_BATCH, *cs.C4_MAP, cs.C4_CHANNELS))
    out.append(("K3", f"14x14 R={cs.C4_TRAIN_ROIS} B={cs.TRAIN_BATCH} train",
                (feat, cs.make_c4_train_rois(rng, "cuda"))))
    return out


def time_case(cs, kernel, args):
    from iif_torch.ops import roi_align as k3
    from iif_torch.ops import roi_align_ml as k1

    if kernel == "K1":
        feats, rois, o = args
        lvl, bidx = k1._roi_meta(rois, 4, 56.0)
        kernel_ms = cs.graph_ms(lambda: k1._launch_fwd(
            feats, rois, lvl, bidx, o, 2, (4, 8, 16, 32)))
        call_ms = cs.cuda_ms(lambda: k1.roi_align_ml(feats, rois, (o, o)))
    else:
        feat, rois = args
        kernel_ms = cs.graph_ms(lambda: k3._launch(feat, rois, 14, 14, 2,
                                                   1 / 16, True))
        call_ms = cs.cuda_ms(lambda: k3.roi_align(feat, rois, (14, 14),
                                                  1 / 16))
    return {"kernel_ms": kernel_ms, "call_ms": call_ms}


@contextlib.contextmanager
def k3_built_from(build, csrc):
    """K3's wrapper on a library built from the sources in ``csrc``."""
    saved = build.CSRC, build.BUILD_DIR
    build.CSRC, build.BUILD_DIR = csrc, csrc.parent / "lib"
    build._libs.pop("roi_align", None)
    try:
        yield build.build("roi_align")
    finally:
        build.CSRC, build.BUILD_DIR = saved
        build._libs.pop("roi_align", None)


def variant_sources(build, name):
    """This checkout's csrc copied under build/, with variant ``name``'s
    change made."""
    path, pattern, repl, count = VARIANTS[name]
    dst = REPO / "build" / "roi_align_variants" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(build.CSRC, dst)
    src = (dst / path).read_text()
    new, n = re.subn(pattern, repl, src)
    if n != count:
        raise RuntimeError(f"variant {name}: {n} matches of {pattern!r} in "
                           f"{path}, expected {count}")
    (dst / path).write_text(new)
    return dst


def k3_variants(cs, torch, k3_cases, base_report):
    from iif_torch.ops import build
    from iif_torch.ops import roi_align as k3

    builds = {"base": build.CSRC}
    builds.update((name, variant_sources(build, name)) for name in VARIANTS)
    order = list(builds)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            with k3_built_from(build, builds[name]) as report:
                if rnd == 0:
                    report = report or base_report
                    for fn in cs.ptxas_report({"roi_align": report}):
                        if "fwd" in fn["function"]:
                            cs.log("ptxas", name, json.dumps(fn))
                for shape, (feat, rois) in k3_cases:
                    row = {"kernel": "K3", "build": name, "round": rnd,
                           "shape": shape}
                    row.update(time_case(cs, "K3", (feat, rois)))
                    if rnd == 0:
                        got = k3.roi_align(feat, rois, (14, 14), 1 / 16)
                        want = cs.plain_single_chunked(feat, rois, (14, 14),
                                                       1 / 16)
                        row["max_abs_err"] = (got - want).abs().max().item()
                        del got, want
                    cs.log(json.dumps(row))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=REPO,
                        help="checkout whose kernels are timed")
    parser.add_argument("--k3-variants", action="store_true",
                        help="also time K3's build variants (this checkout)")
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
    if args.k3_variants and tree != REPO:
        raise RuntimeError("--k3-variants builds this checkout's sources")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log("card", card, "tree", str(tree))
    reports = build.build_all()
    all_cases = cases(cs, torch, np)
    for kernel, shape, inputs in all_cases:
        row = {"kernel": kernel, "tree": tree.name, "shape": shape}
        row.update(time_case(cs, kernel, inputs))
        cs.log(json.dumps(row))
    if args.k3_variants:
        k3_variants(cs, torch, [(shape, inputs)
                                for kernel, shape, inputs in all_cases
                                if kernel == "K3"], reports["roi_align"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
