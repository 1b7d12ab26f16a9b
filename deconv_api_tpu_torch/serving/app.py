"""HTTP serving of the reference's request (counterpart of the ``POST /``
path of ``deconv_api_tpu/serving/app.py``).

Routes: ``GET /health-check`` -> ``{"healthy": "true"}``, ``GET /ready``,
and ``POST /`` with form fields ``file`` (a data-URL image) and ``layer``,
urlencoded or multipart, answered with the JSON-encoded
``data:image/webp;base64,...`` string of the 2x2 grid of the top-4
projections.

Request threads decode and preprocess on the host, then hand the image to
one dispatcher thread, which coalesces concurrent requests for the same
layer into one batch of up to ``max_batch`` within ``batch_window_ms`` and
runs it as one device program, so the device sees a single stream.  The
request thread encodes its own grid.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl

import numpy as np
import torch

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.models import ModelBundle

log = logging.getLogger(__name__)

# The reference serves the top 4 of its ranking as a 2x2 grid: computing
# only those 4 projections gives the same grid.
STITCH_K = 4
REQUEST_TIMEOUT_S = 60.0
MAX_BODY_BYTES = 64 * 1024 * 1024  # a form carrying one base64 image


@dataclasses.dataclass
class _Job:
    layer: str
    x: np.ndarray
    future: concurrent.futures.Future


class DeconvService:
    """The batching dispatcher and the ``POST /`` logic, independent of
    the HTTP server that drives it."""

    def __init__(self, bundle: ModelBundle, *, max_batch: int = 8, batch_window_ms: float = 3.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.bundle = bundle
        self.max_batch = max_batch
        self.window_s = batch_window_ms / 1000.0
        # images per dispatched batch, the most recent ones
        self.batch_sizes: collections.deque[int] = collections.deque(maxlen=1024)
        self.ready = False
        self._pending: collections.deque[_Job] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None

    # --- device work -----------------------------------------------------

    def visualize_batch(self, layer: str, xs: np.ndarray, fused_unpool: str = "auto"):
        """Preprocessed images (B, H, W, 3) -> {"grid": uint8 (B, 2H, 2W, 3),
        "valid": (B, K), "indices": (B, K)} as numpy, one device program
        with the reference's serving settings."""
        fn = self.bundle.batched_visualizer(
            layer, "all", STITCH_K, bug_compat=True, backward_dtype="bfloat16",
            post="grid", fused_unpool=fused_unpool,
        )
        batch = torch.from_numpy(np.ascontiguousarray(xs, dtype=np.float32))
        out = fn(self.bundle.params, batch.to(self.bundle.device))[layer]
        return {k: out[k].cpu().numpy() for k in ("grid", "valid", "indices")}

    def warmup(self) -> None:
        """Run one batch at the deepest conv layer (builds the kernels on
        first use), then mark the service ready."""
        layer = [l.name for l in self.bundle.spec.layers if l.kind == "conv"][-1]
        h, w, c = self.bundle.spec.input_shape
        gen = np.random.default_rng(0)
        self.visualize_batch(layer, gen.normal(0, 50, (1, h, w, c)).astype(np.float32))
        self.ready = True

    # --- dispatcher ------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="deconv-dispatch", daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def submit(self, layer: str, x: np.ndarray) -> concurrent.futures.Future:
        job = _Job(layer, x, concurrent.futures.Future())
        with self._cv:
            if self._closed:
                raise errors.ModelNotReady("service is shutting down")
            self._pending.append(job)
            self._cv.notify_all()
        return job.future

    def _next_batch(self) -> list[_Job] | None:
        """Block for the oldest job, then gather jobs for its layer until
        the batch is full or the window closes."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if not self._pending:
                return None
            layer = self._pending[0].layer
            deadline = time.monotonic() + self.window_s
            while True:
                same = [j for j in self._pending if j.layer == layer]
                left = deadline - time.monotonic()
                if len(same) >= self.max_batch or left <= 0 or self._closed:
                    break
                self._cv.wait(left)
            batch = same[: self.max_batch]
            for job in batch:
                self._pending.remove(job)
            return batch

    def _loop(self) -> None:
        while (batch := self._next_batch()) is not None:
            self.batch_sizes.append(len(batch))
            try:
                out = self.visualize_batch(batch[0].layer, np.stack([j.x for j in batch]))
            except Exception as e:  # the dispatcher must outlive a failed batch
                for job in batch:
                    job.future.set_exception(e)
                continue
            for i, job in enumerate(batch):
                job.future.set_result({"grid": out["grid"][i], "valid": out["valid"][i]})

    # --- POST / ----------------------------------------------------------

    def decode_preprocess(self, file_uri: str) -> np.ndarray:
        try:
            img = codec.decode_data_url(file_uri)
        except codec.CodecError as e:
            raise errors.InvalidImage(str(e)) from None
        size = self.bundle.image_size
        return codec.preprocess_vgg(codec.resize224(img, (size, size)))

    def compat(self, form: dict[str, str]) -> str:
        """``POST /``: form -> the data URL of the stitched grid."""
        if not self.ready:
            raise errors.ModelNotReady("the model is warming up; poll /ready")
        file_uri, layer = form.get("file"), form.get("layer")
        if not file_uri or not layer:
            raise errors.BadRequest("form fields 'file' and 'layer' are required")
        try:
            self.bundle.check_layer(layer)
        except ValueError as e:
            raise errors.UnknownLayer(str(e)) from None
        x = self.decode_preprocess(file_uri)
        try:
            result = self.submit(layer, x).result(timeout=REQUEST_TIMEOUT_S)
        except concurrent.futures.TimeoutError:
            raise errors.RequestTimeout(f"no result within {REQUEST_TIMEOUT_S} s") from None
        if not result["valid"].any():
            raise errors.NoActiveFilters(f"no filters fired for layer {layer!r}")
        return codec.encode_data_url(result["grid"])


# --- HTTP --------------------------------------------------------------------


def _parse_multipart(body: bytes, boundary: bytes) -> dict[str, str]:
    fields: dict[str, str] = {}
    delim = b"--" + boundary
    for part in body.split(delim):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, value = part.partition(b"\r\n\r\n")
        m = re.search(rb'name="([^"]*)"', head)
        if m:
            fields[m.group(1).decode()] = value.decode("utf-8", "replace")
    return fields


def parse_form(ctype: str, body: bytes) -> dict[str, str]:
    if ctype.startswith("application/x-www-form-urlencoded"):
        return dict(parse_qsl(body.decode("utf-8", "replace"), keep_blank_values=True))
    if ctype.startswith("multipart/form-data"):
        m = re.search(r'boundary="?([^";,]+)"?', ctype)
        if not m:
            raise errors.BadRequest("multipart body without boundary")
        return _parse_multipart(body, m.group(1).encode())
    raise errors.BadRequest(f"unsupported content-type {ctype!r}")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "DeconvHTTPServer"

    def _send_json(self, obj, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        service = self.server.service
        if self.path == "/health-check":
            self._send_json({"healthy": "true"})
        elif self.path == "/ready":
            self._send_json({"ready": service.ready}, 200 if service.ready else 503)
        else:
            self._send_json({"error": "not_found", "detail": self.path}, 404)

    def do_POST(self) -> None:  # noqa: N802
        try:
            length = int(self.headers.get("content-length") or 0)
        except ValueError:
            length = -1
        if not 0 <= length <= MAX_BODY_BYTES:
            self.close_connection = True
            self._send_json(errors.BadRequest(f"content-length must be 0..{MAX_BODY_BYTES}").payload(), 400)
            return
        body = self.rfile.read(length)
        if self.path != "/":
            self._send_json({"error": "not_found", "detail": self.path}, 404)
            return
        try:
            form = parse_form(self.headers.get("content-type", ""), body)
            self._send_json(self.server.service.compat(form))
        except errors.DeconvError as e:
            self._send_json(e.payload(), e.status)
        except Exception as e:  # a request must answer, not drop the socket
            log.exception("POST / failed")
            self._send_json({"error": "internal_error", "detail": repr(e)}, 500)

    def log_message(self, format, *args) -> None:  # noqa: A002
        pass  # no per-request access log on stderr


class DeconvHTTPServer(ThreadingHTTPServer):
    """HTTP in front of a started service; ``port=0`` picks a free port
    (``server.server_address[1]``)."""

    daemon_threads = True

    def __init__(self, service: DeconvService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        super().__init__((host, port), _Handler)
