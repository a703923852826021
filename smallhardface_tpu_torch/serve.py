"""HTTP detection service: one ``TorchDetector`` behind a threaded HTTP
server.

Counterpart of ``smallhardface_tpu/serve.py`` (:35-284): the ``detect``
pipeline (the whole pyramid, flip TTA, the vote) as an endpoint,

  POST /detect?thresh=0.05   body: JPEG/PNG bytes
      → {"count": N, "detections": [[x1, y1, x2, y2, score], ...]}
  GET  /healthz              → {"status": "ok", "backend": "cuda", ...}

Concurrent requests overlap: a request's device work is enqueued under a
short lock and its readback and host work run outside it, so one
request's host work overlaps the next one's device work. With
``batch_window_ms`` > 0 the requests that arrive within the window are
grouped by threshold and run through ``detect_many``, whose images of one
bucket key share one batch on the device.

Usage (the service runs on the CUDA card unless ``--device cpu``; it
raises when there is no card):

  python -m smallhardface_tpu_torch.serve --conf \
      smallhardface_tpu/configs/smallhardface.toml --model final.npz \
      [--device cpu] [--port 8400] [--host 127.0.0.1] \
      [--batch-window-ms 20 --max-batch 4] [--amend KEY VALUE ...]

``--model`` takes an ``.npz`` checkpoint of either package or a
``.caffemodel``; ``--amend`` sets config keys as the main command line's
does (``--amend TPU.PRECISION bfloat16`` serves the bf16 mode). The int8
serving mode (``--conf smallhardface_tpu/configs/smallhardface-int8.toml``)
calibrates at start-up on ``--calib-images a.jpg b.jpg ...``; without
them it serves the dynamic int8 mode, with a warning.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.detect import TorchDetector

logger = logging.getLogger(__name__)


class DetectorService:
    """Thread-safe wrapper over ``TorchDetector``'s async pipeline on
    ``device`` (the CUDA card when None; "cpu" only when asked).

    batch_window_ms > 0 turns on cross-client micro-batching: requests
    arriving within the window are grouped, by threshold, into
    ``detect_many`` calls of at most max_batch images, whose detections
    equal the per-request path's within float rounding. A failure reaches
    the callers of its group only.

    calib_images: image paths for the one-time int8 calibration under
    TPU.PRECISION = "int8" (``TorchDetector.calibrate_int8``); without
    them the int8 service runs the dynamic mode, with a warning."""

    # a request waits at most this long for the batch thread, so that a
    # dead thread surfaces as an error instead of a client blocked forever
    REQUEST_TIMEOUT_S = 30 * 60

    def __init__(self, params, spec, batch_window_ms=0, max_batch=4,
                 calib_images=(), device=None):
        if int(cfg.TPU.SPATIAL_DEVICES) > 1:
            raise NotImplementedError(
                f"TPU.SPATIAL_DEVICES={cfg.TPU.SPATIAL_DEVICES}: spatial "
                "sharding is not ported yet (ROADMAP queue 1 item 14, "
                "'Spatial H-sharding')")
        self.det = TorchDetector(params, spec, device)
        if self.det.precision == "int8":
            if calib_images:
                self.det.calibrate_int8(list(calib_images))
            else:
                logger.warning(
                    "TPU.PRECISION='int8' without --calib-images: serving "
                    "with dynamic per-tensor scales; pass representative "
                    "images to calibrate the int8 chain at start-up")
        self._dispatch_lock = threading.Lock()
        self.batch_window = float(batch_window_ms) / 1e3
        self.max_batch = int(max_batch)
        self._queue = None
        if self.batch_window > 0:
            self._queue = queue.Queue()
            threading.Thread(target=self._batch_loop, daemon=True).start()

    def warmup(self, shape=(480, 640)):
        import cv2      # image encoding on the host only
        im = np.zeros((*shape, 3), np.uint8)
        self.detect(cv2.imencode(".jpg", im)[1].tobytes())

    def detect(self, image_bytes, thresh=0.05):
        """(N, 5) detections of one encoded image; ValueError when the
        bytes do not decode."""
        import cv2      # decoding on the host only, as detect._imread
        im = cv2.imdecode(np.frombuffer(image_bytes, np.uint8),
                          cv2.IMREAD_COLOR)
        if im is None:
            raise ValueError("could not decode image")
        if self._queue is not None:
            ev, slot = threading.Event(), {}
            self._queue.put((im, float(thresh), ev, slot))
            if not ev.wait(self.REQUEST_TIMEOUT_S):
                raise RuntimeError(
                    "detection service unavailable: batched request not "
                    f"served within {self.REQUEST_TIMEOUT_S}s")
            if "error" in slot:
                raise slot["error"]
            return slot["dets"]
        if self.det.host_preproc:
            # the reference-exact parity path: detect() honours
            # HOST_PREPROC, detect_async would run the device path
            with self._dispatch_lock:
                return self.det.detect(im, thresh)[0][0]
        with self._dispatch_lock:
            handle = self.det.detect_async(im, thresh)
        return self.det.finalize_async(handle, thresh)[0]

    def _collect(self):
        """The next batch of queued requests: the first one, then what
        arrives within the window, up to max_batch."""
        batch = [self._queue.get()]
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _batch_loop(self):
        while True:
            batch = self._collect()
            by_thresh = {}
            for item in batch:
                by_thresh.setdefault(item[1], []).append(item)
            for thresh, items in by_thresh.items():
                try:
                    with self._dispatch_lock:
                        results = self.det.detect_many(
                            [it[0] for it in items], thresh,
                            max_batch=self.max_batch)
                    for (_, _, ev, slot), dets in zip(items, results):
                        slot["dets"] = dets[0]
                        ev.set()
                except Exception as e:      # to this group's callers
                    for _, _, ev, slot in items:
                        if not ev.is_set():
                            slot["error"] = e
                            ev.set()


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        # bounds body reads, so that a client declaring a longer
        # Content-Length than it sends cannot hold a thread forever
        timeout = 60

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if not self.path.startswith("/healthz"):
                self._json(404, {"error": "unknown path"})
                return
            dev = service.det.device
            self._json(200, {"status": "ok", "backend": dev.type,
                             "devices": (torch.cuda.device_count()
                                         if dev.type == "cuda" else 1)})

        def do_POST(self):
            if not self.path.startswith("/detect"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                qs = parse_qs(urlparse(self.path).query)
                thresh = float(qs.get("thresh", ["0.05"])[0])
                if "chunked" in (self.headers.get("Transfer-Encoding")
                                 or "").lower():
                    self._json(411, {"error": "Content-Length required"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                data = self.rfile.read(length)
                if len(data) < length:
                    self._json(400, {"error": "truncated body"})
                    return
                dets = service.detect(data, thresh)
                self._json(200, {"count": int(dets.shape[0]),
                                 "detections": np.round(dets, 3).tolist()})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                logger.exception("detect failed")
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

    return Handler


def serve(service, host="127.0.0.1", port=8400):
    """A ThreadingHTTPServer for the service (port 0: any free port); the
    caller runs its serve_forever()."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    logger.info("serving on %s:%d", *server.server_address[:2])
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="HTTP face detection service")
    p.add_argument("--conf", default="")
    p.add_argument("--model", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the detector runs (default: the CUDA card; "
                        "raises without one)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--batch-window-ms", type=float, default=0,
                   help="cross-client micro-batch window; 0 = per-request")
    p.add_argument("--max-batch", type=int, default=4,
                   help="images per batched dispatch")
    p.add_argument("--calib-images", nargs="*", default=[],
                   help="representative images for the one-time int8 "
                        "calibration (TPU.PRECISION='int8'); without them "
                        "the int8 service runs the dynamic mode")
    p.add_argument("--amend", nargs="+", default=[], metavar="KEY VALUE",
                   help="config keys to set after --conf, as key/value "
                        "pairs (e.g. TPU.PRECISION bfloat16)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from smallhardface_tpu_torch.config import cfg_from_file, cfg_from_list
    from smallhardface_tpu_torch.models import detector as detector_mod
    from smallhardface_tpu_torch.test_runner import _load_params
    if args.conf:
        cfg_from_file(args.conf)
    if args.amend:
        cfg_from_list(args.amend)
    if args.model:
        cfg.TEST.MODEL = args.model
    spec = detector_mod.build_spec(cfg)
    service = DetectorService(_load_params(spec), spec,
                              batch_window_ms=args.batch_window_ms,
                              max_batch=args.max_batch,
                              calib_images=args.calib_images,
                              device=args.device)
    logger.info("warming up...")
    service.warmup()
    serve(service, args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
