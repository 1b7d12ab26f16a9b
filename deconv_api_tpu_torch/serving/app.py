"""HTTP serving of the reference's request, the JSON API and DeepDream
(counterparts of the ``POST /``, ``POST /v1/deconv`` and ``POST /v1/dream``
paths of ``deconv_api_tpu/serving/app.py``).

Routes: ``GET /health-check`` -> ``{"healthy": "true"}``, ``GET /ready``,
``POST /`` with form fields ``file`` (a data-URL image) and ``layer``,
urlencoded or multipart, answered with the JSON-encoded
``data:image/webp;base64,...`` string of the 2x2 grid of the top-4
projections; ``POST /v1/deconv`` with ``file``, ``layer``, ``mode``
(all|max), ``top_k`` (1..64) and ``sweep``, answered with the data URLs of
the fired filters' tiles, one per filter (for every layer from ``layer``
down with ``sweep``); and ``POST /v1/dream`` with ``file`` and optional
``layers`` (comma list; default the model's dream layers), ``steps``
(1..100), ``octaves`` (1..16, steps x octaves <= 500) and ``lr`` (0, 1],
answered with ``{"layers", "loss", "image"}``.  Every POST also takes
``model`` (form field, else the ``x-model`` header): empty or the served
model's name, else 422 ``unknown_model``.

Request threads decode and preprocess on the host, then hand the image to
a dispatcher thread, which coalesces concurrent requests for the same
program into one batch of up to ``max_batch`` within a window and runs it
on the device as the captured program of its power-of-two bucket
(``serving/batcher.py``, ``engine/capture.py``).  Deconv programs (layer, mode, top_k, presentation, sweep)
and dreams (layers, steps, octaves, lr) have a dispatcher each, so a dream
that runs for seconds never holds a ``POST /`` back.  The request thread
encodes its own images.  The service's ``lowc_kpack`` policy applies to
every deconv program.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Hashable, NamedTuple
from urllib.parse import parse_qsl

import numpy as np
import torch

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.engine.deepdream import octave_shapes, run_dream_programs
from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.batcher import buckets, pad_bucket, pad_to_bucket
from deconv_api_tpu_torch.serving.models import ModelBundle

log = logging.getLogger(__name__)

# The reference serves the top 4 of its ranking as a 2x2 grid: computing
# only those 4 projections gives the same grid.
STITCH_K = 4
DEFAULT_TOP_K = 8  # /v1/deconv's default
REQUEST_TIMEOUT_S = 60.0
# /v1/dream's defaults and its own dispatcher's (deconv_api_tpu/config.py)
DREAM_DEFAULTS = {"steps": 10, "octaves": 10, "lr": 0.01}
DREAM_MAX_BATCH = 4
DREAM_WINDOW_MS = 50.0
DREAM_TIMEOUT_S = 300.0
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


class Dream(NamedTuple):
    """What one dream computes: requests with equal dreams share a batch."""

    layers: tuple[str, ...]
    steps: int = DREAM_DEFAULTS["steps"]
    octaves: int = DREAM_DEFAULTS["octaves"]
    lr: float = DREAM_DEFAULTS["lr"]


@dataclasses.dataclass
class _Job:
    key: Hashable
    x: np.ndarray
    future: concurrent.futures.Future


class Dispatcher:
    """One thread that coalesces jobs of equal key: it takes the oldest job,
    gathers jobs with its key until ``max_batch`` or the window closes, and
    runs ``run_batch(key, xs)`` on the stacked images, whose result holds
    one entry per image."""

    def __init__(
        self, run_batch: Callable[[Hashable, np.ndarray], list], *, max_batch: int,
        window_ms: float, name: str,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.name = name
        # images per dispatched batch, the most recent ones
        self.batch_sizes: collections.deque[int] = collections.deque(maxlen=1024)
        self._pending: collections.deque[_Job] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name=self.name, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def submit(self, key: Hashable, x: np.ndarray) -> concurrent.futures.Future:
        job = _Job(key, x, concurrent.futures.Future())
        with self._cv:
            if self._closed:
                raise errors.ModelNotReady("service is shutting down")
            self._pending.append(job)
            self._cv.notify_all()
        return job.future

    def _next_batch(self) -> list[_Job] | None:
        """Block for the oldest job, then gather jobs for its key until the
        batch is full or the window closes."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if not self._pending:
                return None
            key = self._pending[0].key
            deadline = time.monotonic() + self.window_s
            while True:
                same = [j for j in self._pending if j.key == key]
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
                out = self.run_batch(batch[0].key, np.stack([j.x for j in batch]))
            except Exception as e:  # the dispatcher must outlive a failed batch
                for job in batch:
                    job.future.set_exception(e)
                continue
            for job, result in zip(batch, out):
                job.future.set_result(result)


class DeconvService:
    """The batching dispatchers and the request logic, independent of the
    HTTP server that drives them.  ``lowc_kpack`` (off|auto|forced|<chan>)
    is validated here, at boot."""

    def __init__(
        self, bundle: ModelBundle, *, max_batch: int = 8, batch_window_ms: float = 3.0,
        lowc_kpack: str = "off",
    ):
        resolve_kpack_chan(lowc_kpack, DEFAULT_TOP_K)
        self.bundle = bundle
        self.lowc_kpack = lowc_kpack
        self.max_batch = max_batch
        self.ready = False
        self.warmup_wall_s: float | None = None
        self.dispatcher = Dispatcher(
            self._run_deconv_batch, max_batch=max_batch, window_ms=batch_window_ms,
            name="deconv-dispatch",
        )
        self.dream_dispatcher = Dispatcher(
            self._run_dream_batch, max_batch=DREAM_MAX_BATCH, window_ms=DREAM_WINDOW_MS,
            name="dream-dispatch",
        )

    @property
    def batch_sizes(self) -> collections.deque:
        """Images per dispatched deconv batch, the most recent ones."""
        return self.dispatcher.batch_sizes

    @property
    def dream_batch_sizes(self) -> collections.deque:
        """Images per dispatched dream batch, the most recent ones."""
        return self.dream_dispatcher.batch_sizes

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
        defaults to the service's policy.  The batch runs as the captured
        program of its bucket (``pad_bucket`` of ``max_batch``), its tail
        padded with the last image; only the B real rows come back."""
        n = len(xs)
        bucket = pad_bucket(n, self.max_batch)
        batch = torch.from_numpy(pad_to_bucket(xs, bucket))
        prog = self.bundle.program(
            program.layer, program.mode, program.top_k, bucket, bug_compat=True,
            backward_dtype="bfloat16", post=program.post, fused_unpool=fused_unpool,
            sweep=program.sweep, lowc_kpack=self.lowc_kpack if lowc_kpack is None else lowc_kpack,
        )
        with self.bundle.programs.replaying():
            out = prog(batch)
            # copied out before the next replay overwrites the outputs
            return {
                name: {k: _host(entry[k][:n]) for k in (program.post, "valid", "indices")}
                for name, entry in out.items()
            }

    def _run_deconv_batch(self, program: Program, xs: np.ndarray) -> list[dict]:
        out = self.run_program(program, xs)
        return [
            {name: {k: v[i] for k, v in entry.items()} for name, entry in out.items()}
            for i in range(len(xs))
        ]

    def run_dream(self, dream: Dream, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Preprocessed images (B, H, W, 3) -> (dreamed images (B, H, W, 3)
        fp32 in model-input space, final losses (B,)) as numpy, the whole
        batch on one octave ladder of the bundle's ``min_dream_size``,
        through the captured programs of its bucket (``pad_bucket`` of
        ``DREAM_MAX_BATCH``), its tail padded with the last image."""
        bundle = self.bundle
        n = len(xs)
        bucket = pad_bucket(n, DREAM_MAX_BATCH)
        base = torch.from_numpy(pad_to_bucket(xs, bucket))
        ladder = octave_shapes(*base.shape[1:3], dream.octaves, 1.4, bundle.min_dream_size)
        rungs = bundle.dream_program(dream.layers, ladder, bucket)
        with bundle.dream_programs.replaying():
            out, losses = run_dream_programs(rungs, base.to(bundle.device), dream.steps, dream.lr)
            return _host(out[:n]), _host(losses[:n])

    def _run_dream_batch(self, dream: Dream, xs: np.ndarray) -> list[dict]:
        out, losses = self.run_dream(dream, xs)
        return [{"image": out[i], "loss": float(losses[i])} for i in range(len(xs))]

    def visualize_batch(self, layer: str, xs: np.ndarray, fused_unpool: str = FUSED_DEFAULT):
        """The ``POST /`` program on a batch: ``{"grid", "valid", "indices"}``."""
        return self.run_program(Program(layer), xs, fused_unpool)[layer]

    def warmup_programs(self) -> list[tuple[Program | Dream, int]]:
        """What the card's warmup captures, as (program, bucket): the grid
        and the tiles programs at the bundle's deepest layer at every
        deconv bucket, and the default dream at every dream bucket where
        the model has dream layers (the reference's
        ``warmup_all_buckets``)."""
        layer = self.bundle.deepest_layer()
        out = [(p, b) for b in buckets(self.max_batch)
               for p in (Program(layer), Program(layer, top_k=DEFAULT_TOP_K, post="tiles"))]
        if self.bundle.dream_layers:
            out += [(Dream(self.bundle.dream_layers), b) for b in buckets(DREAM_MAX_BATCH)]
        return out

    def warm(self, program: Program | Dream, bucket: int) -> None:
        """Run ``program`` once on a zero batch of ``bucket`` images, which
        captures it on the card."""
        size = self.bundle.image_size
        xs = np.zeros((bucket, size, size, 3), np.float32)
        if isinstance(program, Dream):
            self.run_dream(program, xs)
        else:
            self.run_program(program, xs)

    def warmup(self) -> None:
        """Make the programs a first request would wait for, then mark the
        service ready (the reference's warmup).  On the card: ``warm``
        every entry of ``warmup_programs``.  On the CPU, where nothing is
        captured and boots stay fast: one batch-1 grid.  ``warmup_wall_s``
        is the time it took."""
        t0 = time.perf_counter()
        bundle = self.bundle
        if bundle.device.type == "cuda":
            for program, bucket in self.warmup_programs():
                self.warm(program, bucket)
        else:
            size = bundle.image_size
            gen = np.random.default_rng(0)
            self.visualize_batch(bundle.deepest_layer(), gen.normal(0, 50, (1, size, size, 3)).astype(np.float32))
        self.warmup_wall_s = time.perf_counter() - t0
        self.ready = True

    # --- dispatchers -----------------------------------------------------

    def start(self) -> None:
        self.dispatcher.start()
        self.dream_dispatcher.start()

    def close(self, timeout: float = 10.0) -> None:
        self.dispatcher.close(timeout)
        self.dream_dispatcher.close(timeout)

    def submit(self, program: Program, x: np.ndarray) -> concurrent.futures.Future:
        return self.dispatcher.submit(program, x)

    # --- requests --------------------------------------------------------

    def resolve_model(self, form: dict[str, str], headers=None) -> str:
        """The request's model: the ``model`` form field, else the
        ``x-model`` header; empty names the served model.  Any other name
        than the served model's is a 422 ``unknown_model``."""
        name = (form.get("model") or (headers or {}).get("x-model", "")).strip()
        if name and name != self.bundle.name:
            raise errors.UnknownModel(
                f"unknown or unserved model {name!r}; serving: {[self.bundle.name]}"
            )
        return self.bundle.name

    def _check_ready(self) -> None:
        if not self.ready:
            raise errors.ModelNotReady("the model is warming up; poll /ready")

    def decode_preprocess(self, file_uri: str) -> np.ndarray:
        try:
            img = codec.decode_data_url(file_uri)
        except codec.CodecError as e:
            raise errors.InvalidImage(str(e)) from None
        size = self.bundle.image_size
        return self.bundle.preprocess(codec.resize224(img, (size, size)))

    def _project(self, form: dict[str, str], headers=None, **program) -> dict:
        """Check readiness, the model, and the form's image and layer, then
        run the image through the dispatcher in ``Program(layer,
        **program)``: ``{layer: {...}}`` of one image."""
        self._check_ready()
        self.resolve_model(form, headers)
        file_uri, layer = form.get("file"), form.get("layer")
        if not file_uri or not layer:
            raise errors.BadRequest("form fields 'file' and 'layer' are required")
        try:
            self.bundle.check_layer(layer)
        except ValueError as e:
            raise errors.UnknownLayer(str(e)) from None
        x = self.decode_preprocess(file_uri)
        return _wait(self.submit(Program(layer, **program), x), REQUEST_TIMEOUT_S)

    def compat(self, form: dict[str, str], headers=None) -> str:
        """``POST /``: form -> the data URL of the stitched grid."""
        result = self._project(form, headers)[form["layer"]]
        if not result["valid"].any():
            raise errors.NoActiveFilters(f"no filters fired for layer {form['layer']!r}")
        return codec.encode_data_url(result["grid"])

    def deconv_v1(self, form: dict[str, str], headers=None) -> dict:
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
        result = self._project(form, headers, mode=mode, top_k=top_k, post="tiles", sweep=sweep)
        if sweep:
            layers = {name: _encode_tiles(entry) for name, entry in result.items()}
            return {"layer": form["layer"], "mode": mode, "sweep": True, "layers": layers}
        return {"layer": form["layer"], "mode": mode, **_encode_tiles(result[form["layer"]])}

    def dream_params(self, form: dict[str, str]) -> Dream:
        """A dream request's knobs, validated as the reference's
        ``_dream_params``: ``layers`` (default the model's dream layers),
        ``steps`` in [1, 100], ``octaves`` in [1, 16], steps x octaves <= 500,
        ``lr`` in (0, 1]; a 400 ``bad_request`` otherwise."""
        layers = tuple(s for s in form.get("layers", "").split(",") if s) or self.bundle.dream_layers
        if not layers:
            raise errors.BadRequest(
                f"model {self.bundle.name!r} has no default dream layers; pass 'layers' explicitly"
            )
        try:
            steps = int(form.get("steps", DREAM_DEFAULTS["steps"]))
            octaves = int(form.get("octaves", DREAM_DEFAULTS["octaves"]))
            lr = float(form.get("lr", DREAM_DEFAULTS["lr"]))
        except ValueError as e:
            raise errors.BadRequest(str(e)) from None
        if not 1 <= steps <= 100 or not 1 <= octaves <= 16:
            raise errors.BadRequest("steps must be in [1,100], octaves in [1,16]")
        if steps * octaves > 500:
            raise errors.BadRequest("steps x octaves must be <= 500 (total ascent steps)")
        if not 0.0 < lr <= 1.0:  # also rejects NaN
            raise errors.BadRequest("lr must be a finite value in (0, 1]")
        return Dream(layers, steps, octaves, lr)

    def dream_v1(self, form: dict[str, str], headers=None) -> dict:
        """``POST /v1/dream``: form -> ``{"layers", "loss", "image"}``, the
        dreamed image as a data URL and its final loss (``None`` when it is
        not finite)."""
        self._check_ready()
        self.resolve_model(form, headers)
        file_uri = form.get("file")
        if not file_uri:
            raise errors.BadRequest("form field 'file' is required")
        dream = self.dream_params(form)
        try:
            self.bundle.dream_forward(dream.layers)
        except KeyError as e:
            raise errors.UnknownLayer(str(e)) from None
        x = self.decode_preprocess(file_uri)
        result = _wait(self.dream_dispatcher.submit(dream, x), DREAM_TIMEOUT_S)
        loss = result["loss"]
        return {
            "layers": list(dream.layers),
            "loss": loss if math.isfinite(loss) else None,  # NaN and inf are not JSON
            "image": codec.encode_data_url(self.bundle.unpreprocess(result["image"])),
        }


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host: never a view of a program's output,
    which its next replay overwrites (on the CPU ``.cpu()`` alone would
    be one)."""
    return t.to("cpu", copy=True).numpy()


def _wait(future: concurrent.futures.Future, timeout_s: float):
    try:
        return future.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        raise errors.RequestTimeout(f"no result within {timeout_s} s") from None


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
        route = {
            "/": service.compat, "/v1/deconv": service.deconv_v1, "/v1/dream": service.dream_v1,
        }.get(self.path)
        if route is None:
            self._send_json({"error": "not_found", "detail": self.path}, 404)
            return
        try:
            form = parse_form(self.headers.get("content-type", ""), body)
            self._send_json(route(form, self.headers))
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
