"""HTTP serving of the reference's request and the JSON API (counterparts of
the ``POST /`` and ``POST /v1/deconv`` paths of
``deconv_api_tpu/serving/app.py``).

Routes: ``GET /health-check`` -> ``{"healthy": "true"}``, ``GET /ready``,
``POST /`` with form fields ``file`` (a data-URL image) and ``layer``,
urlencoded or multipart, answered with the JSON-encoded
``data:image/webp;base64,...`` string of the 2x2 grid of the top-4
projections, and ``POST /v1/deconv`` with ``file``, ``layer``, ``mode``
(all|max), ``top_k`` (1..64) and ``sweep``, answered with the data URLs of
the fired filters' tiles, one per filter (for every layer from ``layer``
down with ``sweep``).

Request threads decode and preprocess on the host, then hand the image to
one dispatcher thread, which coalesces concurrent requests for the same
program (layer, mode, top_k, presentation, sweep) into one batch of up to
``max_batch`` within ``batch_window_ms`` and runs it as one device program,
so the device sees a single stream.  The request thread encodes its own
images.  The service's ``lowc_kpack`` policy applies to every program.
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
from typing import NamedTuple
from urllib.parse import parse_qsl

import numpy as np
import torch

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.models import ModelBundle

log = logging.getLogger(__name__)

# The reference serves the top 4 of its ranking as a 2x2 grid: computing
# only those 4 projections gives the same grid.
STITCH_K = 4
DEFAULT_TOP_K = 8  # /v1/deconv's default
REQUEST_TIMEOUT_S = 60.0
MAX_BODY_BYTES = 64 * 1024 * 1024  # a form carrying one base64 image
_TRUTHY = ("1", "true", "yes", "on")


class Program(NamedTuple):
    """What one device program computes: requests with equal programs
    share a batch."""

    layer: str
    mode: str = "all"
    top_k: int = STITCH_K
    post: str = "grid"  # "grid" for POST /, "tiles" for /v1/deconv
    sweep: bool = False


@dataclasses.dataclass
class _Job:
    program: Program
    x: np.ndarray
    future: concurrent.futures.Future


class DeconvService:
    """The batching dispatcher and the request logic, independent of the
    HTTP server that drives it.  ``lowc_kpack`` (off|auto|forced|<chan>)
    is validated here, at boot."""

    def __init__(
        self, bundle: ModelBundle, *, max_batch: int = 8, batch_window_ms: float = 3.0,
        lowc_kpack: str = "off",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        resolve_kpack_chan(lowc_kpack, DEFAULT_TOP_K)
        self.bundle = bundle
        self.max_batch = max_batch
        self.window_s = batch_window_ms / 1000.0
        self.lowc_kpack = lowc_kpack
        # images per dispatched batch, the most recent ones
        self.batch_sizes: collections.deque[int] = collections.deque(maxlen=1024)
        self.ready = False
        self._pending: collections.deque[_Job] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None

    # --- device work -----------------------------------------------------

    def run_program(
        self, program: Program, xs: np.ndarray, fused_unpool: str = FUSED_DEFAULT,
        lowc_kpack: str | None = None,
    ) -> dict[str, dict[str, np.ndarray]]:
        """Preprocessed images (B, H, W, 3) -> ``{layer: {post, "valid",
        "indices"}}`` as numpy, one device program with the reference's
        serving settings (bf16 backward, bug_compat; a DAG model ignores
        both and projects in fp32); ``post`` is ``program.post``, uint8
        (B, 2H, 2W, 3) grids or (B, K, H, W, 3) tiles.  ``lowc_kpack``
        defaults to the service's policy."""
        fn = self.bundle.batched_visualizer(
            program.layer, program.mode, program.top_k, bug_compat=True,
            backward_dtype="bfloat16", post=program.post, fused_unpool=fused_unpool,
            sweep=program.sweep,
            lowc_kpack=self.lowc_kpack if lowc_kpack is None else lowc_kpack,
        )
        batch = torch.from_numpy(np.ascontiguousarray(xs, dtype=np.float32))
        out = fn(self.bundle.params, batch.to(self.bundle.device))
        return {
            name: {k: entry[k].cpu().numpy() for k in (program.post, "valid", "indices")}
            for name, entry in out.items()
        }

    def visualize_batch(self, layer: str, xs: np.ndarray, fused_unpool: str = FUSED_DEFAULT):
        """The ``POST /`` program on a batch: ``{"grid", "valid", "indices"}``."""
        return self.run_program(Program(layer), xs, fused_unpool)[layer]

    def warmup(self) -> None:
        """Run one batch at the bundle's deepest layer (builds the kernels
        on first use), then mark the service ready."""
        size = self.bundle.image_size
        gen = np.random.default_rng(0)
        self.visualize_batch(
            self.bundle.deepest_layer(), gen.normal(0, 50, (1, size, size, 3)).astype(np.float32)
        )
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

    def submit(self, program: Program, x: np.ndarray) -> concurrent.futures.Future:
        job = _Job(program, x, concurrent.futures.Future())
        with self._cv:
            if self._closed:
                raise errors.ModelNotReady("service is shutting down")
            self._pending.append(job)
            self._cv.notify_all()
        return job.future

    def _next_batch(self) -> list[_Job] | None:
        """Block for the oldest job, then gather jobs for its program
        until the batch is full or the window closes."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if not self._pending:
                return None
            program = self._pending[0].program
            deadline = time.monotonic() + self.window_s
            while True:
                same = [j for j in self._pending if j.program == program]
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
                out = self.run_program(batch[0].program, np.stack([j.x for j in batch]))
            except Exception as e:  # the dispatcher must outlive a failed batch
                for job in batch:
                    job.future.set_exception(e)
                continue
            for i, job in enumerate(batch):
                job.future.set_result(
                    {name: {k: v[i] for k, v in entry.items()} for name, entry in out.items()}
                )

    # --- requests --------------------------------------------------------

    def decode_preprocess(self, file_uri: str) -> np.ndarray:
        try:
            img = codec.decode_data_url(file_uri)
        except codec.CodecError as e:
            raise errors.InvalidImage(str(e)) from None
        size = self.bundle.image_size
        return self.bundle.preprocess(codec.resize224(img, (size, size)))

    def _project(self, form: dict[str, str], **program) -> dict:
        """Check readiness and the form's image and layer, then run the
        image through the dispatcher in ``Program(layer, **program)``:
        ``{layer: {...}}`` of one image."""
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
            return self.submit(Program(layer, **program), x).result(timeout=REQUEST_TIMEOUT_S)
        except concurrent.futures.TimeoutError:
            raise errors.RequestTimeout(f"no result within {REQUEST_TIMEOUT_S} s") from None

    def compat(self, form: dict[str, str]) -> str:
        """``POST /``: form -> the data URL of the stitched grid."""
        result = self._project(form)[form["layer"]]
        if not result["valid"].any():
            raise errors.NoActiveFilters(f"no filters fired for layer {form['layer']!r}")
        return codec.encode_data_url(result["grid"])

    def deconv_v1(self, form: dict[str, str]) -> dict:
        """``POST /v1/deconv``: form -> ``{"layer", "mode", "filters",
        "images"}`` for the fired filters (a prefix of the ranking), or
        ``{"layer", "mode", "sweep": true, "layers": {name: {"filters",
        "images"}}}`` with ``sweep``."""
        mode = form.get("mode", "all")
        if mode not in ("all", "max"):
            raise errors.IllegalMode(f"mode must be 'all' or 'max', got {mode!r}")
        try:
            top_k = int(form.get("top_k", DEFAULT_TOP_K))
        except ValueError:
            raise errors.BadRequest(f"top_k must be an integer, got {form['top_k']!r}") from None
        if not 1 <= top_k <= 64:
            raise errors.BadRequest("top_k must be in [1, 64]")
        sweep = form.get("sweep", "").lower() in _TRUTHY
        result = self._project(form, mode=mode, top_k=top_k, post="tiles", sweep=sweep)
        if sweep:
            layers = {name: _encode_tiles(entry) for name, entry in result.items()}
            return {"layer": form["layer"], "mode": mode, "sweep": True, "layers": layers}
        return {"layer": form["layer"], "mode": mode, **_encode_tiles(result[form["layer"]])}


def _encode_tiles(entry: dict) -> dict:
    """``{"filters", "images"}`` of one projected layer's fired prefix."""
    n_valid = int(entry["valid"].sum())
    return {
        "filters": [int(i) for i in entry["indices"][:n_valid]],
        "images": [codec.encode_data_url(entry["tiles"][k]) for k in range(n_valid)],
    }


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
        service = self.server.service
        route = {"/": service.compat, "/v1/deconv": service.deconv_v1}.get(self.path)
        if route is None:
            self._send_json({"error": "not_found", "detail": self.path}, 404)
            return
        try:
            form = parse_form(self.headers.get("content-type", ""), body)
            self._send_json(route(form))
        except errors.DeconvError as e:
            self._send_json(e.payload(), e.status)
        except Exception as e:  # a request must answer, not drop the socket
            log.exception("POST %s failed", self.path)
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
