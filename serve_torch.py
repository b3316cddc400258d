#!/usr/bin/env python3
"""HTTP anomaly-scoring server of the PyTorch port, with micro-batching.

The counterpart of ``serve.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  * requests are queued and coalesced into micro-batches (``--max-batch``,
    ``--max-wait-ms``), so concurrent clients share one forward;
  * a batch is padded up to a bucket size (1, 2, 4, 8, 16), every bucket up
    to ``--max-batch`` is warmed at boot in both variants (score, and score
    with the reconstruction), so no request meets a first call's set-up
    (cuDNN's algorithm choice, the int8 kernel's build);
  * the score is the offline pipeline's math: x = x_u8 / 255, x_hat =
    forward(x), eps = sum over pixels and channels of (x - x_hat)^2, z-scored
    against ``--stats`` (the ``{"meu", "sigma"}`` of the offline pass 1) when
    given.

All device work runs on the batcher's thread, on the model's device; the
handler threads decode PNGs and wait. ``--quantize`` serves the ``w8a8``
forward (``ops/quant.py``: the two large Dense layers through the int8 GEMM
kernel on the card): from ``<model_dir>/quantized`` when that sidecar exists
(the float weights are then never read), else from a tree quantized at boot.
A failed batch (a malformed image, a kernel that fails to build or launch)
fails that batch's requests with HTTP 500; the server goes on.

Endpoints:
  GET  /healthz      -> {"ok": true, "model_input": [H, W, C], "max_batch": n}
  GET  /metrics      -> request counts, latency window, batcher occupancy
  POST /score        -> {"reconstruction_error": eps, "z": z?, "anomalous": ?}
                        ("error" appears only in failure payloads)
  POST /reconstruct  -> PNG bytes of the reconstruction
  (body: PNG bytes, or any image PIL decodes; resized to the model's input)

Usage:
  python serve_torch.py -m <logdir> [--port 8000] [--stats stats.json]
                        [--threshold 3.0] [--max-batch 8] [--max-wait-ms 5]
                        [--quantize] [--device cuda]

It serves from one CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.models.cvae import normalize_image_input


class MicroBatcher:
    """Coalesces scoring requests into bucket-padded device batches."""

    BUCKETS = (1, 2, 4, 8, 16)

    def __init__(self, model, config, max_batch: int = 8, max_wait_ms: float = 5.0,
                 quantize: bool = False, qparams=None):
        from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward

        self.model = model
        self.device = torch.device(model.device)
        self.max_batch = self._clamp_to_bucket(max_batch)
        self.max_wait_s = max_wait_ms / 1000.0
        size = config["data"]["image_size"]
        self.hwc = (int(size[0]), int(size[1]), int(size[2]))
        self.queue: queue.Queue = queue.Queue()
        self._stop = False
        # serializes submit() against close(): a submit racing shutdown fails
        # fast instead of enqueueing into a queue nothing drains again
        self._submit_lock = threading.Lock()
        # read by /metrics; the worker inserts bucket_counts keys while
        # handler threads read them, hence the lock
        self._stats_lock = threading.Lock()
        self.batches_dispatched = 0
        self.items_scored = 0
        self.batch_errors = 0
        self.bucket_counts: dict = {}

        self.quantized = bool(quantize) or qparams is not None
        self._forward, self._serve_params = serving_forward(
            model.core, getattr(model, "params", None), quantize=self.quantized,
            qparams=qparams)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    @classmethod
    def _clamp_to_bucket(cls, max_batch: int) -> int:
        """Round max_batch up to a bucket: ``_run`` pads a coalesced group of
        n <= max_batch to the bucket that covers it, so max_batch itself must
        be a warmed bucket."""
        max_batch = min(max(1, max_batch), cls.BUCKETS[-1])
        return next(b for b in cls.BUCKETS if b >= max_batch)

    def _device_context(self):
        """Inference mode and the current device. Both are thread-local, so
        the batcher's thread enters them itself."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def _dispatch(self, batch: np.ndarray, want_rec: bool):
        """One bucket batch (uint8, (bucket, H, W, C)) through the forward:
        one upload, then the per-frame eps fetched to the host and, with
        ``want_rec``, the uint8 reconstruction. Returns (eps, rec or None)."""
        x = normalize_image_input(torch.from_numpy(batch).to(self.device))
        x_hat = self._forward(self._serve_params, x)
        eps = ((x - x_hat) ** 2).sum(dim=3).sum(dim=(1, 2))  # per frame
        if not want_rec:
            return eps.cpu().numpy(), None
        rec = torch.clamp(torch.round(255.0 * x_hat), 0, 255).to(torch.uint8)
        return eps.cpu().numpy(), rec.cpu().numpy()

    def warmup(self, buckets=None) -> None:
        """One call of both variants at every bucket up to ``max_batch``
        (first-call costs off the request path)."""
        with self._device_context():
            for b in buckets or [x for x in self.BUCKETS if x <= self.max_batch]:
                batch = np.zeros((b, *self.hwc), np.uint8)
                self._dispatch(batch, False)
                self._dispatch(batch, True)

    def submit(self, img_u8, want_rec: bool = False) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._stop:
                fut.set_exception(RuntimeError("server shutting down"))
                return fut
            self.queue.put((img_u8, want_rec, fut))
        return fut

    def close(self):
        with self._submit_lock:
            self._stop = True
        self.thread.join(timeout=2)
        # fail what is still queued (or in flight past the join's timeout):
        # submit() can no longer enqueue, so this is the queue's last reader
        while True:
            try:
                _img, _want_rec, fut = self.queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("server shutting down"))

    def _run(self):
        with self._device_context():
            while not self._stop:
                try:
                    first = self.queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                items = [first]
                deadline = time.monotonic() + self.max_wait_s
                while len(items) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        items.append(self.queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                n = len(items)
                bucket = next(b for b in self.BUCKETS if b >= n)
                with self._stats_lock:
                    self.batches_dispatched += 1
                    self.items_scored += n
                    self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
                # everything a batch does is inside the try: a bad image or a
                # failed launch fails this batch's futures, not the thread
                try:
                    batch = np.zeros((bucket, *self.hwc), np.uint8)
                    for i, (img, _wr, _f) in enumerate(items):
                        batch[i] = img
                    eps, rec = self._dispatch(batch, any(wr for _img, wr, _f in items))
                    for i, (_img, wr, fut) in enumerate(items):
                        fut.set_result((float(eps[i]), rec[i] if wr else None))
                except Exception as e:  # noqa: BLE001 - handed to each client as a 500
                    with self._stats_lock:
                        self.batch_errors += 1
                    for _img, _wr, fut in items:
                        if not fut.done():
                            fut.set_exception(e)


def _decode_to_model_size(body: bytes, hwc):
    """The image of a request body as uint8 (H, W, C) at the model's size
    (PIL bilinear); a 1-channel model gets greyscale (H, W, 1)."""
    from PIL import Image

    h, w, c = hwc
    img = Image.open(io.BytesIO(body)).convert("L" if c == 1 else "RGB")
    if img.size != (w, h):
        img = img.resize((w, h), Image.BILINEAR)
    arr = np.asarray(img, np.uint8)
    if c == 1:
        arr = arr[..., None]
    return arr


class ServerMetrics:
    """Request counters and a bounded window of latencies for /metrics: a
    long-lived server keeps no host state per request."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests = {}  # path -> count
        self.failures = {}  # path -> count
        self._lat_ms = deque(maxlen=window)

    def record(self, path: str, ms: float, ok: bool) -> None:
        with self._lock:
            self.requests[path] = self.requests.get(path, 0) + 1
            if not ok:
                self.failures[path] = self.failures.get(path, 0) + 1
            self._lat_ms.append(ms)

    def snapshot(self, batcher: MicroBatcher) -> dict:
        with self._lock:
            lat = list(self._lat_ms)
            out = {
                "uptime_s": round(time.time() - self.started, 1),
                "requests": dict(self.requests),
                "failures": dict(self.failures),
            }
        if lat:
            out["latency_ms"] = {
                "window": len(lat),
                "p50": round(float(np.percentile(lat, 50)), 2),
                "p95": round(float(np.percentile(lat, 95)), 2),
                "p99": round(float(np.percentile(lat, 99)), 2),
            }
        # items and batches read at one instant, under the batcher's lock
        with batcher._stats_lock:
            dispatched = batcher.batches_dispatched
            scored = batcher.items_scored
            errors = batcher.batch_errors
            buckets = dict(batcher.bucket_counts)
        out["batcher"] = {
            "batches_dispatched": dispatched,
            "items_scored": scored,
            "batch_errors": errors,
            "bucket_counts": buckets,
            "mean_batch_fill": round(scored / dispatched, 3) if dispatched else None,
            "queue_depth": batcher.queue.qsize(),
            "quantized": batcher.quantized,
        }
        return out


def _validate_stats(stats: dict) -> None:
    """Reject a malformed --stats payload at boot, not per request."""
    for key in ("meu", "sigma"):
        if not isinstance(stats.get(key), (int, float)):
            raise ValueError(
                f"stats JSON must contain numeric '{key}' "
                f"(got {stats.get(key)!r}); expected the offline pass-1 "
                "format {'meu': ..., 'sigma': ...}")
    if stats["sigma"] == 0:
        raise ValueError("stats sigma must be nonzero (z = (eps - meu) / sigma)")


def make_handler(batcher: MicroBatcher, stats, threshold: float,
                 metrics: ServerMetrics | None = None):
    metrics = metrics or ServerMetrics()
    if stats is not None:
        _validate_stats(stats)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "model_input": list(batcher.hwc),
                                 "max_batch": batcher.max_batch})
            elif self.path == "/metrics":
                self._json(200, metrics.snapshot(batcher))
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/score", "/reconstruct"):
                self._json(404, {"error": "unknown path"})
                return
            t0 = time.perf_counter()

            def done(ok: bool) -> None:
                metrics.record(self.path, 1000 * (time.perf_counter() - t0), ok)

            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                img = _decode_to_model_size(body, batcher.hwc)
            except Exception as e:  # noqa: BLE001 - any decode failure is the client's
                done(False)
                self._json(400, {"error": f"undecodable image: {e}"})
                return
            try:
                want_rec = self.path == "/reconstruct"
                eps, rec = batcher.submit(img, want_rec=want_rec).result(timeout=120)
            except Exception as e:  # noqa: BLE001 - the batch failed: a 500 with its reason
                done(False)
                self._json(500, {"error": str(e)})
                return
            done(True)
            if self.path == "/reconstruct":
                from PIL import Image

                buf = io.BytesIO()
                if rec.shape[-1] == 1:
                    Image.fromarray(rec[..., 0], mode="L").save(buf, format="PNG")
                else:
                    Image.fromarray(rec, mode="RGB").save(buf, format="PNG")
                png = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
                return
            # "error" is reserved for failure payloads
            out = {"reconstruction_error": eps}
            if stats is not None:
                z = (eps - stats["meu"]) / stats["sigma"]
                out["z"] = z
                out["anomalous"] = bool(z > threshold)
            self._json(200, out)

    return Handler


class ScoringHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for a burst of clients.
    socketserver's default backlog of 5 drops the connections of a larger
    burst, and their clients retry only after the kernel's 1 s SYN timeout
    (``serve.py`` keeps that default)."""

    request_queue_size = 128


def build_server(model_dir: str, port: int = 8000, stats_path: str | None = None,
                 threshold: float = 3.0, max_batch: int = 8, max_wait_ms: float = 5.0,
                 warmup: bool = True, quantize: bool = False, device="cuda"):
    """A ``ScoringHTTPServer`` on ``port`` (0: any free port) serving the
    model of ``model_dir``; its ``batcher`` attribute is the MicroBatcher and
    its ``metrics`` the ServerMetrics that /metrics reports.
    With ``quantize`` it boots from ``<model_dir>/quantized`` when present
    (``stream/engine.py::boot_serving_model``). Raises when ``device`` is a
    CUDA device and there is none."""
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import boot_serving_model

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' / --device cpu to serve on the CPU)")
    model, config, qparams = boot_serving_model(
        model_dir, device, quantize=quantize, int8_checkpoint_boot=True,
        restore_optimizer=False)
    stats = None
    if stats_path:
        with open(stats_path) as f:
            stats = json.load(f)
    batcher = MicroBatcher(model, config, max_batch=max_batch, max_wait_ms=max_wait_ms,
                           quantize=quantize, qparams=qparams)
    metrics = ServerMetrics()
    try:
        if warmup:
            batcher.warmup()
        server = ScoringHTTPServer(("0.0.0.0", port),
                                   make_handler(batcher, stats, threshold, metrics))
    except BaseException:
        batcher.close()
        raise
    server.batcher, server.metrics = batcher, metrics
    return server


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", "-m", required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--stats", type=str, default=None,
                        help='JSON {"meu":..., "sigma":...} from the offline pass 1')
    parser.add_argument("--threshold", "-t", type=float, default=3.0)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--quantize", action="store_true",
                        help="int8-quantize the big dense kernels for serving (ops/quant.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; never falls back to cpu)")
    args = parser.parse_args(argv)
    server = build_server(args.model_dir, args.port, args.stats, args.threshold,
                          args.max_batch, args.max_wait_ms, quantize=args.quantize,
                          device=args.device)

    # SIGTERM, a supervisor's stop, shuts down as Ctrl-C does: stop accepting
    # and fail the queued requests at once. Installed before the ready line,
    # which a supervisor may answer with SIGTERM at once
    import signal

    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        print(f"serving on :{server.server_address[1]} (buckets warmed, "
              f"max_batch={server.batcher.max_batch}, device {args.device})", flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
