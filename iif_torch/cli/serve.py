"""Model server: port of ``iif_tpu/cli/serve.py``, the analog of the
reference's TorchServe deployment (``tools/deployment/mmdet_handler.py`` is
the request handler). One command on top of the inference API:

    python -m iif_torch.cli.serve CONFIG [CHECKPOINT] --port 8080 \
        [--device cuda]

Endpoints (TorchServe-compatible shapes, ``mmdet_handler.py:31-70``):

    GET  /ping                 -> {"status": "Healthy"}
    POST /predictions/<name>   -> [{"class_name", "bbox", "score"}, ...]

The POST body is raw image bytes (PNG, decoded without cv2, or any other
cv2-decodable format) or JSON ``{"data": "<base64>"}`` — the two
encodings the reference handler's ``preprocess`` accepts. Detections below ``--score-thr`` (handler
default 0.5) are dropped. Requests are serialized through a lock; the
first forward runs once at startup as a warmup call.
"""
from __future__ import annotations

import argparse
import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


def format_predictions(result, classes, score_thr: float = 0.5
                       ) -> List[dict]:
    """mmdet_handler ``postprocess`` output shape: one dict per kept
    detection with xyxy bbox, score, and class name."""
    out = []
    keep = result["valid"] & (result["scores"] >= score_thr)
    for i in np.flatnonzero(keep):
        label = int(result["labels"][i])
        out.append({
            "class_name": (classes[label] if classes is not None
                           and label < len(classes) else str(label)),
            "bbox": [float(v) for v in result["boxes"][i]],
            "score": float(result["scores"][i]),
        })
    return out


class _Batcher:
    """Dynamic micro-batching: concurrent requests landing within
    ``window_ms`` of each other ride one device program of a fixed
    ``max_batch`` shape (padding rows repeat the last canvas and are
    dropped): the answer to TorchServe's ``batch_size`` config."""

    def __init__(self, detector, max_batch: int, window_ms: float = 5.0):
        import queue

        self.detector = detector
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        t = threading.Thread(target=self._worker, daemon=True)
        t.start()

    def _worker(self):
        import queue
        import time

        from iif_torch.detection.inference import inference_detector_batch

        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                results = inference_detector_batch(
                    self.detector, [b["img"] for b in batch],
                    pad_to=self.max_batch, masks=False)
                for slot, res in zip(batch, results):
                    slot["result"] = res
            except Exception as exc:  # noqa: BLE001 — fail the batch
                for slot in batch:
                    slot["error"] = exc
            for slot in batch:
                slot["event"].set()

    def infer(self, img):
        slot = {"img": img, "event": threading.Event()}
        self.q.put(slot)
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]


def make_server(detector, classes=None, score_thr: float = 0.5,
                port: int = 8080, host: str = "127.0.0.1",
                max_batch: int = 1, batch_window_ms: float = 5.0
                ) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server bound to ``detector``.
    ``max_batch > 1`` turns on dynamic micro-batching."""
    from iif_torch.detection.image_io import decode_image
    from iif_torch.detection.inference import inference_detector

    lock = threading.Lock()
    batcher = (_Batcher(detector, max_batch, batch_window_ms)
               if max_batch > 1 else None)
    cls = classes if classes is not None else getattr(
        detector, "CLASSES", None)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet by default
            pass

        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ping":
                self._reply(200, {"status": "Healthy"})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if not self.path.startswith("/predictions"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    raw = base64.b64decode(json.loads(raw)["data"])
                try:
                    img = decode_image(raw, "request body")
                except ValueError:
                    self._reply(400, {"error": "undecodable image"})
                    return
                if batcher is not None:
                    result = batcher.infer(img)
                else:
                    with lock:
                        # masks=False: the handler response is
                        # class/bbox/score only — skip the full-res
                        # mask paste + readback
                        result = inference_detector(detector, img,
                                                    masks=False)
                self._reply(200, format_predictions(result, cls, score_thr))
            except Exception as exc:   # noqa: BLE001 — report to client
                self._reply(500, {"error": str(exc)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Serve a detector over HTTP (TorchServe-handler "
                    "compatible request/response shapes)")
    parser.add_argument("config")
    parser.add_argument("checkpoint", nargs="?", default=None)
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--score-thr", type=float, default=0.5,
                        help="mmdet_handler.py threshold (default 0.5)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--max-batch", type=int, default=1,
                        help=">1 turns on dynamic micro-batching: "
                             "concurrent requests share one device "
                             "program of this batch size")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="how long to wait for batch companions")
    args = parser.parse_args(argv)

    from iif_torch.detection.inference import (
        inference_detector,
        inference_detector_batch,
        init_detector,
    )
    detector = init_detector(args.config, args.checkpoint,
                             device=args.device)
    # warmup: run the forward once before accepting traffic
    canvas = detector.pipeline.canvas
    if args.max_batch > 1:
        inference_detector_batch(detector,
                                 [np.zeros(canvas + (3,), np.uint8)],
                                 pad_to=args.max_batch)
    else:
        inference_detector(detector,
                           np.zeros(canvas + (3,), np.uint8))
    server = make_server(detector, score_thr=args.score_thr,
                         port=args.port, host=args.host,
                         max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /predictions/model, GET /ping)")
    server.serve_forever()


if __name__ == "__main__":
    main()
