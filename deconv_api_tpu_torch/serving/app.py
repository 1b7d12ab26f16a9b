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
``model`` (form field, else the ``x-model`` header): empty (the default
model) or a served model's name, else 422 ``unknown_model``.

Control routes: ``GET /healthz`` (liveness), ``GET /readyz`` (readiness,
with each check named, and the residency block when several models are
served), ``GET /metrics`` and ``GET /v1/metrics`` (the Prometheus text of
the deconv and dream streams), ``GET /v1/config`` (the effective
configuration and the weight manager's residency) and ``GET /v1/models``
(the registry, with the default and the served models marked).

Several models are served from one card through a ``WeightManager``
(``serving/weight_manager.py``): each batch checks its model's weights out
(paging them in if cold) before its replay and releases them after its
outputs are on the host.

Request threads decode and preprocess on the host, then hand the image to
a dispatcher thread, which coalesces concurrent requests for the same
program into one batch of up to ``max_batch`` within a window and runs it
on the device as the captured program of its power-of-two bucket
(``serving/batcher.py``, ``engine/capture.py``); a batch holds one model.
Deconv programs (layer, mode, top_k, presentation, sweep)
and dreams (layers, steps, octaves, lr) have a dispatcher each, so a dream
that runs for seconds never holds a ``POST /`` back.  The request thread
encodes its own images.  The service's ``lowc_kpack`` policy applies to
every deconv program.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
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
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.engine.capture import DEVICE_LOCK
from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.engine.deepdream import octave_shapes, run_dream_programs
from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.batcher import buckets, pad_bucket, pad_to_bucket
from deconv_api_tpu_torch.serving.metrics import Metrics
from deconv_api_tpu_torch.serving.models import REGISTRY, ModelBundle, build_bundle, registry_info
from deconv_api_tpu_torch.serving.weight_manager import WEIGHT_DTYPES, WeightManager

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
    enqueued_at: float = dataclasses.field(default_factory=time.perf_counter)


class Dispatcher:
    """One thread that coalesces jobs of equal key: it takes the oldest job,
    gathers jobs with its key until ``max_batch`` or the window closes, and
    runs ``run_batch(key, xs)`` on the stacked images, whose result holds
    one entry per image.  Each batch is observed on ``metrics``: its size,
    its run's seconds and its oldest job's wait."""

    def __init__(
        self, run_batch: Callable[[Hashable, np.ndarray], list], *, max_batch: int,
        window_ms: float, name: str, metrics: Metrics | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.name = name
        self.metrics = metrics
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

    def alive(self) -> bool:
        """The dispatcher thread runs (the /readyz ``batcher_tasks`` check)."""
        return self._thread is not None and self._thread.is_alive()

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
            t0 = time.perf_counter()
            try:
                out = self.run_batch(batch[0].key, np.stack([j.x for j in batch]))
            except Exception as e:  # the dispatcher must outlive a failed batch
                for job in batch:
                    job.future.set_exception(e)
                continue
            if self.metrics is not None:
                self.metrics.observe_batch(len(batch), time.perf_counter() - t0,
                                           t0 - min(j.enqueued_at for j in batch))
            for job, result in zip(batch, out):
                job.future.set_result(result)


class DeconvService:
    """The batching dispatchers, the weight manager and the request logic,
    independent of the HTTP server that drives them (the counterpart of
    ``deconv_api_tpu/serving/app.py:DeconvService`` for what the port
    serves).  ``cfg`` (``config.ServerConfig``, its fields also given as
    keyword ``overrides``) is validated here, at boot, with the JAX
    package's messages.

    ``registry`` maps model name -> zero-arg ``ModelBundle`` factory; it
    defaults to ``serving/models.py:REGISTRY`` on ``device``.  An injected
    ``bundle`` is the default model and joins the served set under its own
    name (alone when no registry is given).  The served set
    (``cfg.serve_models``) and its residency on the card live in
    ``weights``, a ``WeightManager``; ``bundle`` is the default model's."""

    def __init__(
        self, bundle: ModelBundle | None = None, cfg: ServerConfig | None = None, *,
        registry: dict[str, Callable[[], ModelBundle]] | None = None, device=None, **overrides,
    ):
        self.cfg = cfg = dataclasses.replace(cfg or ServerConfig(), **overrides)
        resolve_kpack_chan(cfg.lowc_kpack, DEFAULT_TOP_K)
        if cfg.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, got {cfg.weight_dtype!r}")
        if registry is None and bundle is None:
            registry = {name: functools.partial(build_bundle, name, device) for name in REGISTRY}
        if bundle is not None:
            # an injected model serves alone, or beside an injected registry
            registry = {**(registry or {}), bundle.name: lambda: bundle}
            cfg.model = bundle.name
        elif cfg.model not in registry:
            raise errors.UnknownModel(f"unknown model {cfg.model!r}; available: {sorted(registry)}")
        self._registry = dict(registry)
        served = self._parse_model_list(cfg.serve_models, cfg.model, "serve_models")
        pinned = self._parse_model_list(cfg.pinned_models, cfg.model, "pinned_models")
        self.metrics = Metrics("deconv")
        self.dream_metrics = Metrics("dream")
        self.bundle = bundle if bundle is not None else self._registry[cfg.model]()
        self.weights = WeightManager(
            {name: self._registry[name] for name in served}, cfg.model, default_bundle=self.bundle,
            pinned=tuple(pinned), budget_bytes=cfg.hbm_budget_bytes, weight_dtype=cfg.weight_dtype,
            metrics=self.metrics,
        )
        self.lowc_kpack = cfg.lowc_kpack
        self.max_batch = cfg.max_batch
        self.ready = False
        # set when shutdown begins: /readyz turns 503 before the listener goes
        self.draining = False
        self.warmup_wall_s: float | None = None
        self.warmup_wall_s_by_model: dict[str, float] = {}
        self.dispatcher = Dispatcher(
            self._run_deconv_batch, max_batch=cfg.max_batch, window_ms=cfg.batch_window_ms,
            name="deconv-dispatch", metrics=self.metrics,
        )
        self.dream_dispatcher = Dispatcher(
            self._run_dream_batch, max_batch=DREAM_MAX_BATCH, window_ms=DREAM_WINDOW_MS,
            name="dream-dispatch", metrics=self.dream_metrics,
        )

    def _parse_model_list(self, raw: str, default: str, what: str) -> list[str]:
        """serve_models / pinned_models grammar: '' = just the default
        model, 'all' = every registry entry, else a comma list.  The
        default model is always a member.  Unknown names fail at boot."""
        raw = (raw or "").strip()
        if not raw:
            names = [default]
        elif raw == "all":
            names = sorted(self._registry)
        else:
            names = [s.strip() for s in raw.split(",") if s.strip()]
        unknown = [n for n in names if n not in self._registry]
        if unknown:
            raise ValueError(f"{what}: unknown model(s) {unknown}; available: {sorted(self._registry)}")
        if default not in names:
            names.insert(0, default)
        return list(dict.fromkeys(names))

    @property
    def batch_sizes(self) -> collections.deque:
        """Images per dispatched deconv batch, the most recent ones."""
        return self.dispatcher.batch_sizes

    @property
    def dream_batch_sizes(self) -> collections.deque:
        """Images per dispatched dream batch, the most recent ones."""
        return self.dream_dispatcher.batch_sizes

    # --- device work -----------------------------------------------------

    @contextlib.contextmanager
    def _checked_out(self, model: str | None):
        """The model's bundle with its weights resident on the device and
        pinned there for the block (``WeightManager.checkout``): the
        programs are fetched, replayed and their outputs copied to the
        host inside it, since outputs alias the programs' pool."""
        name = model or self.weights.default
        bundle = self.weights.bundle(name)
        self.weights.checkout(name)
        try:
            yield bundle
        finally:
            self.weights.release(name)

    def run_program(
        self, program: Program, xs: np.ndarray, fused_unpool: str = FUSED_DEFAULT,
        lowc_kpack: str | None = None, model: str | None = None,
    ) -> dict[str, dict[str, np.ndarray]]:
        """Preprocessed images (B, H, W, 3) of ``model`` (default: the
        default model) -> ``{layer: {post, "valid", "indices"}}`` as numpy,
        one device program with the reference's serving settings (bf16
        backward, bug_compat; a DAG model ignores both and projects in
        fp32); ``post`` is ``program.post``, uint8 (B, 2H, 2W, 3) grids or
        (B, K, H, W, 3) tiles.  ``lowc_kpack`` defaults to the service's
        policy.  The batch runs as the captured program of its bucket
        (``pad_bucket`` of ``max_batch``), its tail padded with the last
        image; only the B real rows come back."""
        n = len(xs)
        bucket = pad_bucket(n, self.max_batch)
        batch = torch.from_numpy(pad_to_bucket(xs, bucket))
        with self._checked_out(model) as bundle:
            prog = bundle.program(
                program.layer, program.mode, program.top_k, bucket, bug_compat=True,
                backward_dtype="bfloat16", post=program.post, fused_unpool=fused_unpool,
                sweep=program.sweep, lowc_kpack=self.lowc_kpack if lowc_kpack is None else lowc_kpack,
            )
            with bundle.programs.replaying():
                out = prog(batch)
                # copied out before the next replay overwrites the outputs
                return {
                    name: {k: _host(entry[k][:n]) for k in (program.post, "valid", "indices")}
                    for name, entry in out.items()
                }

    def _run_deconv_batch(self, key: tuple[str, Program], xs: np.ndarray) -> list[dict]:
        model, program = key
        out = self.run_program(program, xs, model=model)
        return [
            {name: {k: v[i] for k, v in entry.items()} for name, entry in out.items()}
            for i in range(len(xs))
        ]

    def run_dream(
        self, dream: Dream, xs: np.ndarray, model: str | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Preprocessed images (B, H, W, 3) -> (dreamed images (B, H, W, 3)
        fp32 in model-input space, final losses (B,)) as numpy, the whole
        batch on one octave ladder of the bundle's ``min_dream_size``,
        through the captured programs of its bucket (``pad_bucket`` of
        ``DREAM_MAX_BATCH``), its tail padded with the last image."""
        n = len(xs)
        bucket = pad_bucket(n, DREAM_MAX_BATCH)
        base = torch.from_numpy(pad_to_bucket(xs, bucket))
        with self._checked_out(model) as bundle:
            ladder = octave_shapes(*base.shape[1:3], dream.octaves, 1.4, bundle.min_dream_size)
            rungs = bundle.dream_program(dream.layers, ladder, bucket)
            with bundle.dream_programs.replaying():
                out, losses = run_dream_programs(rungs, base.to(bundle.device), dream.steps, dream.lr)
                return _host(out[:n]), _host(losses[:n])

    def _run_dream_batch(self, key: tuple[str, Dream], xs: np.ndarray) -> list[dict]:
        model, dream = key
        out, losses = self.run_dream(dream, xs, model)
        return [{"image": out[i], "loss": float(losses[i])} for i in range(len(xs))]

    def visualize_batch(
        self, layer: str, xs: np.ndarray, fused_unpool: str = FUSED_DEFAULT, model: str | None = None,
    ):
        """The ``POST /`` program on a batch: ``{"grid", "valid", "indices"}``."""
        return self.run_program(Program(layer), xs, fused_unpool, model=model)[layer]

    def warmup_programs(self, model: str | None = None) -> list[tuple[Program | Dream, int]]:
        """What the card's warmup captures for ``model`` (default: the
        default model), as (program, bucket): the grid and the tiles
        programs at its deepest layer at every deconv bucket, and the
        default dream at every dream bucket where the model has dream
        layers (the reference's ``warmup_all_buckets``)."""
        bundle = self.weights.bundle(model or self.weights.default)
        layer = bundle.deepest_layer()
        out = [(p, b) for b in buckets(self.max_batch)
               for p in (Program(layer), Program(layer, top_k=DEFAULT_TOP_K, post="tiles"))]
        if bundle.dream_layers:
            out += [(Dream(bundle.dream_layers), b) for b in buckets(DREAM_MAX_BATCH)]
        return out

    def warm(self, program: Program | Dream, bucket: int, model: str | None = None) -> None:
        """Run ``program`` once on a zero batch of ``bucket`` images, which
        captures it on the card."""
        size = self.weights.bundle(model or self.weights.default).image_size
        xs = np.zeros((bucket, size, size, 3), np.float32)
        if isinstance(program, Dream):
            self.run_dream(program, xs, model)
        else:
            self.run_program(program, xs, model=model)

    def warmup(self) -> None:
        """Make the programs a first request would wait for, for every
        pinned model (the default first), then mark the service ready (the
        reference's warmup).  On the card: ``warm`` every entry of each
        model's ``warmup_programs``.  On the CPU, where nothing is captured
        and boots stay fast: one batch-1 grid a model.  ``warmup_wall_s``
        is the time it took, ``warmup_wall_s_by_model`` each model's part
        (with its page-in)."""
        t0 = time.perf_counter()
        gen = np.random.default_rng(0)
        for name in self.weights.pinned:
            t_model = time.perf_counter()
            bundle = self.weights.bundle(name)
            if bundle.device.type == "cuda":
                for program, bucket in self.warmup_programs(name):
                    self.warm(program, bucket, name)
            else:
                size = bundle.image_size
                xs = gen.normal(0, 50, (1, size, size, 3)).astype(np.float32)
                self.visualize_batch(bundle.deepest_layer(), xs, model=name)
            self.warmup_wall_s_by_model[name] = time.perf_counter() - t_model
        self.warmup_wall_s = time.perf_counter() - t0
        self.metrics.set_gauge("warmup_seconds", self.warmup_wall_s)
        self.ready = True

    # --- dispatchers -----------------------------------------------------

    def start(self) -> None:
        self.dispatcher.start()
        self.dream_dispatcher.start()

    def close(self, timeout: float = 10.0) -> None:
        """Begin the drain (``/readyz`` answers 503 from here), then stop
        both dispatchers."""
        self.draining = True
        self.dispatcher.close(timeout)
        self.dream_dispatcher.close(timeout)

    def submit(self, program: Program, x: np.ndarray, model: str | None = None) -> concurrent.futures.Future:
        """Queue one image of ``model`` for ``program``: requests batch
        together only with the same model and program."""
        return self.dispatcher.submit((model or self.weights.default, program), x)

    # --- requests --------------------------------------------------------

    def resolve_model(self, form: dict[str, str], headers=None) -> str:
        """The request's model: the ``model`` form field (wins), else the
        ``x-model`` header, else the default model.  A name the server does
        not serve is a 422 ``unknown_model``."""
        name = (form.get("model") or (headers or {}).get("x-model", "")).strip()
        if not name:
            name = self.weights.default
        if name not in self.weights.served:
            raise errors.UnknownModel(
                f"unknown or unserved model {name!r}; serving: {sorted(self.weights.served)}"
            )
        return name

    def _check_ready(self) -> None:
        if not self.ready:
            raise errors.ModelNotReady("the model is warming up; poll /ready")

    def decode_preprocess(self, file_uri: str, bundle: ModelBundle | None = None) -> np.ndarray:
        """A data-URL image -> the input of ``bundle`` (default: the
        default model's): its size, its preprocessing."""
        bundle = bundle or self.bundle
        try:
            img = codec.decode_data_url(file_uri)
        except codec.CodecError as e:
            raise errors.InvalidImage(str(e)) from None
        size = bundle.image_size
        return bundle.preprocess(codec.resize224(img, (size, size)))

    def _project(self, form: dict[str, str], headers=None, **program) -> dict:
        """Check readiness, the model, and the form's image and layer, then
        run the image through the dispatcher in ``Program(layer,
        **program)``: ``{layer: {...}}`` of one image."""
        self._check_ready()
        model = self.resolve_model(form, headers)
        bundle = self.weights.bundle(model)
        file_uri, layer = form.get("file"), form.get("layer")
        if not file_uri or not layer:
            raise errors.BadRequest("form fields 'file' and 'layer' are required")
        try:
            bundle.check_layer(layer)
        except ValueError as e:
            raise errors.UnknownLayer(str(e)) from None
        x = self.decode_preprocess(file_uri, bundle)
        return _wait(self.submit(Program(layer, **program), x, model), REQUEST_TIMEOUT_S)

    def compat(self, form: dict[str, str], headers=None) -> str:
        """``POST /``: form -> the data URL of the stitched grid."""
        result = self._project(form, headers)[form["layer"]]
        if not result["valid"].any():
            raise errors.NoActiveFilters(f"no filters fired for layer {form['layer']!r}")
        t0 = time.perf_counter()
        url = codec.encode_data_url(result["grid"])
        self.metrics.observe_stage("encode", time.perf_counter() - t0)
        return url

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

    def dream_params(self, form: dict[str, str], bundle: ModelBundle | None = None) -> Dream:
        """A dream request's knobs, validated as the reference's
        ``_dream_params``: ``layers`` (default the model's dream layers),
        ``steps`` in [1, 100], ``octaves`` in [1, 16], steps x octaves <= 500,
        ``lr`` in (0, 1]; a 400 ``bad_request`` otherwise."""
        bundle = bundle or self.bundle
        layers = tuple(s for s in form.get("layers", "").split(",") if s) or bundle.dream_layers
        if not layers:
            raise errors.BadRequest(
                f"model {bundle.name!r} has no default dream layers; pass 'layers' explicitly"
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
        model = self.resolve_model(form, headers)
        bundle = self.weights.bundle(model)
        file_uri = form.get("file")
        if not file_uri:
            raise errors.BadRequest("form field 'file' is required")
        dream = self.dream_params(form, bundle)
        try:
            bundle.dream_forward(dream.layers)
        except KeyError as e:
            raise errors.UnknownLayer(str(e)) from None
        x = self.decode_preprocess(file_uri, bundle)
        result = _wait(self.dream_dispatcher.submit((model, dream), x), DREAM_TIMEOUT_S)
        loss = result["loss"]
        return {
            "layers": list(dream.layers),
            "loss": loss if math.isfinite(loss) else None,  # NaN and inf are not JSON
            "image": codec.encode_data_url(bundle.unpreprocess(result["image"])),
        }

    # --- control routes ----------------------------------------------------

    def readiness_checks(self) -> dict[str, bool]:
        """Each gate a load balancer should respect, named so a 503's body
        says which one failed."""
        return {
            "warmed": self.ready,  # pinned models paged in, programs captured
            "not_draining": not self.draining,  # stop routing before the listener dies
            "batcher_tasks": self.dispatcher.alive() and self.dream_dispatcher.alive(),
        }

    def readyz(self) -> tuple[dict, int]:
        """``GET /readyz``: ``({"ready", "checks"[, "models"]}, status)``."""
        checks = self.readiness_checks()
        ok = all(checks.values())
        body = {"ready": ok, "checks": checks}
        if len(self.weights.served) > 1:
            body["models"] = self.weights.ready_block()
        return body, 200 if ok else 503

    def metrics_text(self) -> str:
        """``GET /metrics``: the deconv and dream streams' expositions."""
        return self.metrics.prometheus() + self.dream_metrics.prometheus()

    def config(self) -> dict:
        """``GET /v1/config``: the effective configuration, the default
        model, the weight manager's live residency, and, under
        ``graph_pool_bytes``, the device memory each resident model's
        captured programs hold (their two pools)."""
        cfg = dataclasses.asdict(self.cfg)
        cfg["model_active"] = self.weights.default
        cfg["weights"] = self.weights.snapshot()
        # the allocator's snapshot, taken while no capture runs
        with DEVICE_LOCK.shared() if torch.cuda.is_available() else contextlib.nullcontext():
            cfg["graph_pool_bytes"] = {
                name: {"deconv": pool_bytes(b.programs.pool), "dream": pool_bytes(b.dream_programs.pool)}
                for name in self.weights.resident_models()
                if (b := self.weights.peek_bundle(name)) is not None
            }
        cfg["lowc_kpack_chan"] = resolve_kpack_chan(self.cfg.lowc_kpack) if self.bundle.spec is not None else 0
        cfg["warmup_wall_s"] = self.warmup_wall_s
        cfg["draining"] = self.draining
        return cfg

    def models(self) -> dict:
        """``GET /v1/models``: the registry's static metadata, each entry
        marked ``active`` (the default model) and ``served``; an injected
        default model that the registry lacks is listed from its bundle."""
        info = registry_info()
        for entry in info:
            entry["active"] = entry["model"] == self.bundle.name
            entry["served"] = entry["model"] in self.weights.served
        if not any(e["active"] for e in info):
            info.append({
                "model": self.bundle.name,
                "image_size": self.bundle.image_size,
                "engine": "switch-deconv (sequential spec)" if self.bundle.spec is not None
                else "autodiff-deconv (DAG)",
                "layers": list(self.bundle.layer_names),
                "dream_layers": list(self.bundle.dream_layers),
                "active": True,
                "served": True,
            })
        return {"models": info}


def pool_bytes(pool) -> int:
    """Device memory the caching allocator holds in the graph memory pool
    ``pool`` (its segments' sizes); 0 on the CPU, where nothing is
    captured."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


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
        elif self.path == "/healthz":
            # liveness: answering at all is the proof; it stays 200 through
            # warmup and drain, which a restart would not fix
            self._send_json({"status": "ok"})
        elif self.path == "/readyz":
            self._send_json(*service.readyz())
        elif self.path in ("/metrics", "/v1/metrics"):
            body = service.metrics_text().encode()
            self.send_response(200)
            self.send_header("content-type", "text/plain; version=0.0.4")
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/config":
            self._send_json(service.config())
        elif self.path == "/v1/models":
            self._send_json(service.models())
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
        route, metrics = {
            "/": (service.compat, service.metrics), "/v1/deconv": (service.deconv_v1, service.metrics),
            "/v1/dream": (service.dream_v1, service.dream_metrics),
        }.get(self.path, (None, None))
        if route is None:
            self._send_json({"error": "not_found", "detail": self.path}, 404)
            return
        t0 = time.perf_counter()
        try:
            form = parse_form(self.headers.get("content-type", ""), body)
            result = route(form, self.headers)
        except errors.DeconvError as e:
            metrics.observe_request(time.perf_counter() - t0, e.code)
            self._send_json(e.payload(), e.status)
            return
        except Exception as e:  # a request must answer, not drop the socket
            log.exception("POST %s failed", self.path)
            metrics.observe_request(time.perf_counter() - t0, "internal_error")
            self._send_json({"error": "internal_error", "detail": repr(e)}, 500)
            return
        metrics.observe_request(time.perf_counter() - t0)
        self._send_json(result)

    def log_message(self, format, *args) -> None:  # noqa: A002
        pass  # no per-request access log on stderr


class DeconvHTTPServer(ThreadingHTTPServer):
    """HTTP in front of a started service; ``port=0`` picks a free port
    (``server.server_address[1]``)."""

    daemon_threads = True

    def __init__(self, service: DeconvService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        super().__init__((host, port), _Handler)
