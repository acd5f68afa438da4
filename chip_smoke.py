#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every kernel from ``iif_torch/csrc``.
2. Kernel phase: the multi-level RoIAlign kernel against its plain PyTorch
   version at the LVIS serving shapes (levels 200x336 .. 25x42, B=2,
   C=256; 7x7 with R=2000 and 14x14 with R=600; f32 and bf16), with the
   error, time, plain-version time and the HBM bound.
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
5. The ``kernels`` JSON line, then the device line as the last line.

Exits non-zero, with no result line, when CUDA is unavailable or the
``iif_torch`` package is not beside this file; any failed check raises.
"""
import json
import shutil
import statistics
import subprocess
import sys
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
REPLACES = "iif_tpu/ops/pallas/roi_align_kernel.py:725"
F32_TOL = 1e-5
CLS_REL_TOL = 1e-2
REQUESTS = 40                      # timed images per serving path


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


def spread(ms):
    """Median and spread of host-clock times."""
    ms = sorted(ms)
    return {"n": len(ms), "median": statistics.median(ms), "min": ms[0],
            "p90": ms[int(0.9 * (len(ms) - 1))], "max": ms[-1]}


def bf16_ulp(x):
    import torch

    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


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


def roi_align_bound(feats, rois, o, s=2):
    """Least time for this RoIAlign call on the card: the larger of (unique
    feature rows that this run's samples touch + rois + output) over HBM
    bandwidth, and its f32 FLOPs over the non-tensor-core f32 peak."""
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
    touched = torch.unique(idx.reshape(-1)).numel()
    r = rois.shape[0]
    nbytes = touched * c * item + r * 5 * 4 + r * o * o * c * item
    flops = r * o * o * c * s * s * 12
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", touched)


def kernel_phase(torch, np):
    from iif_torch.ops.roi_align_ml import roi_align_ml, roi_align_ml_reference

    rng = np.random.RandomState(0)
    feats32 = [torch.tensor(rng.randn(2, h, w, 256), dtype=torch.float32,
                            device="cuda") for h, w in LVIS_LEVELS]
    results = {}
    for o, r in ((7, 2000), (14, 600)):
        rois = make_rois(rng, r, "cuda")
        for dt in (torch.float32, torch.bfloat16):
            feats = [f.to(dt) for f in feats32]
            got = roi_align_ml(feats, rois, (o, o))
            torch.cuda.synchronize()
            want = roi_align_ml_reference(feats, rois, (o, o))
            err = (got.float() - want.to(dt).float()).abs().max().item()
            if dt == torch.float32:
                ok = err <= F32_TOL
                tol = F32_TOL
                ulps = None
            else:
                cast = want.to(dt).float()
                ulps = ((got.float() - cast).abs()
                        / bf16_ulp(cast)).max().item()
                ok = ulps <= 1.0
                tol = "1 bf16 ulp of the value"
            ms = cuda_ms(lambda: roi_align_ml(feats, rois, (o, o)))
            plain_ms = cuda_ms(lambda: roi_align_ml_reference(
                feats, rois, (o, o)).to(dt))
            bound_ms, bound_by, touched = roi_align_bound(feats, rois, o)
            row = {"o": o, "R": r, "dtype": str(dt).split(".")[-1],
                   "max_abs_err": err, "max_err_ulps": ulps,
                   "tolerance": tol, "ok": ok, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "touched_feature_rows": touched}
            log("kernel", json.dumps(row))
            if not ok:
                raise RuntimeError(f"roi_align_ml disagrees: {row}")
            results[(o, row["dtype"])] = row
    return results


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
    from iif_torch.detection.roi_extractor import SingleRoIExtractor
    from iif_torch.ops.nms import nms
    from iif_torch.ops.roi_align_ml import (
        reset_launches,
        roi_align_ml,
        roi_align_ml_reference,
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

    rng = np.random.RandomState(1)
    sizes = [(480, 640), (427, 640), (640, 512), (800, 1333)]
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in sizes]
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
    b2_syncs = nms.host_syncs / REQUESTS
    # b1 with pasted masks
    reset_launches()
    with_masks = inference_detector(det, images[0], masks=True)
    torch.cuda.synchronize()
    launches["b1_masks"] = dict(roi_align_ml.launches_by_size)
    log("main path launches", json.dumps(launches),
        "nms host syncs per image", json.dumps({"b1": b1_syncs,
                                                "b2": b2_syncs}))
    for path, counts in launches.items():
        if not (counts.get(7, 0) > 0 and counts.get(14, 0) > 0):
            raise RuntimeError(
                f"RoIAlign kernel not on the {path} path: {counts}")

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
    seen = []
    extract = SingleRoIExtractor.__call__

    def record(self, feats, rois):
        out = extract(self, feats, rois)
        seen.append((self.output_size[0], feats, rois, out))
        return out

    SingleRoIExtractor.__call__ = record
    try:
        inference_detector(det, images[1], masks=False)
    finally:
        SingleRoIExtractor.__call__ = extract
    check([o for o, *_ in seen] == [7, 14], "one 7x7 and one 14x14 call")
    compare = {}
    with torch.inference_mode():
        for o, nhwc, rois, k_feat in seen:
            p_feat = roi_align_ml_reference(nhwc, rois, (o, o)).to(
                k_feat.dtype)
            ulps = ((k_feat.float() - p_feat.float()).abs()
                    / bf16_ulp(p_feat.float())).max().item()
            compare[f"roi_feats_{o}_max_err_ulps"] = ulps
            if ulps > 1.0:
                raise RuntimeError(f"{o}x{o} RoI features differ: {ulps}")
            if o == 7:
                bbox_head = det.model.roi_head.bbox_head
                k_cls = bbox_head(k_feat)[0]
                p_cls = bbox_head(p_feat)[0]
                rel = ((k_cls - p_cls).abs().max()
                       / p_cls.abs().max()).item()
                compare["cls_score_max_rel_err"] = rel
                compare["cls_score_tolerance"] = CLS_REL_TOL
                if rel > CLS_REL_TOL:
                    raise RuntimeError(f"cls_score differs: {rel}")
    log("request vs plain RoIAlign", json.dumps(compare))
    return {"b1_ms_per_image": spread(b1_ms),
            "b2_ms_per_image": spread(b2_ms),
            "nms_host_syncs_per_image_b1": b1_syncs,
            "nms_host_syncs_per_image_b2": b2_syncs, "launches": launches,
            "detector": det, "image": images[3]}


STAGES = ("backbone_fpn", "rpn", "bbox_roi_align", "bbox_head", "bbox_nms",
          "mask_roi_align", "mask_head")


def profile_phase(torch, det, image):
    """One b1 request of ``image``, three ways.

    Unprofiled: the median wall time of REQUESTS/2 requests, and of as
    many with the device drained at each stage's ends (the
    ``record_function`` spans of ``maskrcnn_simple_test`` swapped for a
    synchronising timer), which gives each stage's wall time with its own
    host work and device work and nothing of its neighbours'.

    Under ``torch.profiler``: per stage the device time of the kernels
    launched inside its span, the device's busy time (union of kernel and
    copy intervals), and the kernels that take most device time. The busy
    share is that busy time over the unprofiled wall time: the profiler
    stretches the host's side of a request, not its device time."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import iif_torch.detection.detector as detector_mod
    from iif_torch.detection.inference import inference_detector

    n = REQUESTS // 2
    inference_detector(det, image, masks=False)
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        inference_detector(det, image, masks=False)
        walls.append((time.perf_counter() - t0) * 1e3)
    stage_walls = {k: [] for k in STAGES}

    @contextlib.contextmanager
    def synced_span(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stage_walls[name].append((time.perf_counter() - t0) * 1e3)

    record_function_orig = detector_mod.record_function
    detector_mod.record_function = synced_span
    try:
        for _ in range(n):
            inference_detector(det, image, masks=False)
    finally:
        detector_mod.record_function = record_function_orig

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_detector(det, image, masks=False)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    stages = {k: {"synced_wall_ms": statistics.median(stage_walls[k]),
                  "profiled_host_ms": 0.0, "kernel_ms": 0.0} for k in STAGES}
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.name in stages and e.device_type == DeviceType.CPU:
            stages[e.name]["profiled_host_ms"] += (e.time_range.elapsed_us()
                                                   / 1e3)
            stages[e.name]["kernel_ms"] += e.device_time_total / 1e3
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
    # K1 is launched through ctypes, outside any aten op, so the profiler
    # does not charge it to a stage span; it is read by its kernel name
    k1 = [v for k, v in by_kernel.items() if "roi_align_ml" in k]
    return {"wall_ms": spread(walls), "profiled_wall_ms": profiled_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "roi_align_ml_kernel_ms": sum(t for t, _ in k1),
            "roi_align_ml_kernel_launches": sum(k for _, k in k1),
            "stages": stages,
            "top_kernels": [(k[:70], t, c) for k, (t, c) in top]}


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card", card)
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda, "ninja", shutil.which("ninja"))
    t0 = time.time()
    reports = build.build_all()
    log(f"kernel build s {time.time() - t0:.3f}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    kern = kernel_phase(torch, np)
    serve = serving_phase(torch, np)
    log("serving", json.dumps({k: v for k, v in serve.items()
                               if k not in ("detector", "image")}),
        "card", card)
    prof = profile_phase(torch, serve.pop("detector"), serve.pop("image"))
    log("profile b1", json.dumps(prof))

    kernels = []
    for o in (7, 14):
        row = kern[(o, "bfloat16")]
        kernels.append({
            "name": f"roi_align_ml_{o}x{o}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": sum(c.get(o, 0)
                            for c in serve["launches"].values()),
            "launches_by_path": {p: c.get(o, 0)
                                 for p, c in serve["launches"].items()},
            "max_abs_err": row["max_abs_err"],
            "max_err_ulps": row["max_err_ulps"],
            "tolerance": row["tolerance"],
            "f32_max_abs_err": kern[(o, "float32")]["max_abs_err"],
            "f32_tolerance": F32_TOL,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"R={row['R']} bf16 LVIS levels B=2 C=256"})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
