"""HTTP serving of the reference's request, the JSON API and DeepDream
(counterparts of the ``POST /``, ``POST /v1/deconv`` and ``POST /v1/dream``
paths of ``deconv_api_tpu/serving/app.py``).

Routes: ``GET /health-check`` -> ``{"healthy": "true"}``, ``GET /ready``,
``POST /`` with form fields ``file`` (a data-URL image) and ``layer``,
urlencoded, multipart or JSON, answered with the JSON-encoded
``data:image/webp;base64,...`` string of the 2x2 grid of the top-4
projections; ``POST /v1/deconv`` with ``file``, ``layer``, ``mode``
(all|max), ``top_k`` (1..64) and ``sweep``, answered with the data URLs of
the fired filters' tiles, one per filter (for every layer from ``layer``
down with ``sweep``); and ``POST /v1/dream`` with ``file`` and optional
``layers`` (comma list; default the model's dream layers), ``steps``
(1..100), ``octaves`` (1..16, steps x octaves <= 500) and ``lr`` (0, 1],
answered with ``{"layers", "loss", "image"}``.  Every POST also takes
``model`` (form field, else the ``x-model`` header): empty (the default
model) or a served model's name, else 422 ``unknown_model``, and
``x-deadline-ms``, the caller's budget: a request still queued when it
lapses is answered 504 ``deadline_expired`` before any device work.
Every POST also takes ``quality`` (form field, else the ``x-quality``
header): ``full``, ``bf16`` (the batch staged in bfloat16, so the forward
runs in bf16) or ``int8`` (the forward walk in int8 with int32
accumulation on the card's int8 kernel, with each model's calibrated
ranges from ``calibration_dir`` or else each example's own), anything else
422 ``illegal_quality``.  A request that names none takes its QoS class's
tier (``quality_by_class``) or ``quality_default``.  DAG models run
``int8`` as ``bf16``, and dreams run every tier as ``full``
(``_effective_quality``).

In front of each compute route, as in the JAX service (outermost first):
the observation wrap (the ``request_duration_seconds`` histogram and the
latency SLOs), the trace wrap, with ``qos`` on the tenant admission wrap
(``serving/qos.py``: identity from ``x-api-key`` or ``x-tenant``, a
device-time token bucket and an in-flight cap per tenant, 429
``tenant_over_quota``; the dispatchers' queues become deficit-round-robin
queues per tenant and class), and the response cache with singleflight
(``serving/cache.py``): a repeated request is answered from the cache
before any decode (``x-cache: hit``), identical requests in flight share
one device row (``coalesced``), a deterministic 4xx is cached for
``cache_negative_ttl_s`` (``hit-negative``), and with ``l2_dir`` the
answers outlive the process on disk (``l2``).

With ``jobs_dir`` (``serving/jobs.py``): ``POST /v1/jobs`` (``type`` dream,
deconv or sweep, with the fields of the matching route) answers 202 and a
job whose stages run on the same dispatchers, checkpointed to the
directory at each octave or layer: ``GET /v1/jobs``, ``GET
/v1/jobs/{id}[/result|/events]`` (the answer is the synchronous route's
bytes; the events are server-sent) and ``DELETE /v1/jobs/{id}``.

The server's settings (``config.ServerConfig``, the JAX package's fields
and ``DECONV_*`` variables): ``visualize_mode``, ``stitch_k`` and
``top_k`` are the routes' defaults, ``bug_compat``, ``backward_dtype``,
``dtype`` and ``fused_unpool`` pick the programs, ``strict_compat`` turns
fewer than ``stitch_k`` fired filters into 422 ``no_active_filters``, and
``image_size`` overrides every model's input size.  ``weights_path``
loads pretrained weights (``_load_weights``: a file for the default
model, a directory of ``<model>.h5``/``.npz`` for every served model, or
a ``train`` checkpoint directory for the default model) before any
archive, stored tier or program is made from them.

``POST /v1/profile`` (``batches``, 1..64, default 4) traces the next
device batches with ``torch.profiler`` into ``profile_dir`` (400 while it
is unset); a server with ``profile_dir`` traces its first
``DECONV_PROFILE_BATCHES`` (default 4) batches after warmup.

With ``aot_dir`` (``serving/aot.py``) the kernel libraries come from a
digest-verified store: on the card ``warmup`` resolves all four before
``/ready`` (a stored copy loaded, else its nvcc build stored), and
``/v1/config`` and ``/readyz`` carry an ``aot`` block.

Control routes: ``GET /healthz`` (liveness), ``GET /readyz`` (readiness,
with each check named, and the residency block when several models are
served; 503 while draining), ``GET /metrics`` and ``GET /v1/metrics`` (the
Prometheus text of the deconv, dream and sweep streams and of the request
traces), ``GET /v1/config`` (the effective configuration and the weight
manager's residency), ``GET /v1/models`` (the registry, with the default
and the served models marked) and ``GET /v1/debug/requests`` (the flight
recorder: recent, slow and error traces with their spans).  With ``tsdb``
on (or an ``alerts`` spec): ``GET /v1/metrics/history`` (the embedded
metric history, ``serving/tsdb.py``), ``GET /v1/alerts`` (the alert
rules' states, ``serving/alerts.py``) and, with ``incidents_dir``, ``GET
/v1/debug/incidents``; with fault injection on, ``POST /v1/debug/faults``.

The request pipeline (as the JAX service's): an asyncio HTTP server
(``serving/http.py``) on the service's event-loop thread; decode on the
codec worker pool (``serving/codec_pool.py``; small bodies inline); three
``BatchingDispatcher``s (``serving/batcher.py``: deconv, dream, sweep) on
one ``LanePool`` whose lane is the card, each coalescing requests of one
(model, program) into batches of its power-of-two bucket, shedding load,
dropping expired deadlines and failing fast while the breaker is open.

The fleet tier's backend half (``serving/fleet.py`` routes in front): with
``fleet_routers`` and ``fleet_token`` the server registers with each router
once its listener answers (``announce_to_routers``, from the entry point)
and announces its drain at shutdown, naming the ``drain_grace_s`` its
listener stays up; with ``fleet_peer_fill`` (and the cache on) a miss that
carries the router's ``x-peer-fill: host:port`` hint reads the finished
payload from that peer's ``GET /v1/internal/cache/{digest}`` before
computing (``x-cache: peer-fill``), and the server serves that route to
its own peers.  A server with no ``fleet_*`` setting has none of it.

Device work is pipelined.  A dispatcher's dispatch step (``_enqueue_*``,
on its lane's dispatch worker thread) checks the model's weights out,
assembles the padded batch in a pinned staging buffer, copies it into the
captured program's static input without blocking, replays the graph,
enqueues non-blocking copies of the real rows of every output into pinned
output buffers and records a CUDA event; it makes no host sync.  The fetch
(the thunk it returns, on a fetch thread) polls the event in short slices
holding ``DEVICE_LOCK`` shared, reads the host rows, JPEG-encodes the
grids, returns the buffers to their rings and only then releases the
checkout, so a page-out never frees a model with a batch in flight.
Stream order keeps the next replay from overwriting outputs whose copies
are queued before it.  On the CPU the dispatch step computes at once and
the fetch reads the copied rows: the same code path, not a fallback.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import re
import socket
import threading
import time
import urllib.parse
from typing import Callable, NamedTuple

import numpy as np
import torch

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.engine.capture import DEVICE_LOCK
from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.engine.deepdream import octave_shapes, run_dream_programs, run_dream_rung
from deconv_api_tpu_torch.engine import quant as quant_mod
from deconv_api_tpu_torch.engine.quant import QUALITY_TIERS
from deconv_api_tpu_torch.models.weights import load_model_weights
from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.ops.cuda_deconv import fused_engaged, resolve_fused_unpool
from deconv_api_tpu_torch.serving import codec, durable
from deconv_api_tpu_torch.serving import faults as faults_mod
from deconv_api_tpu_torch.serving import fleet as fleet_mod
from deconv_api_tpu_torch.serving import trace as trace_mod
from deconv_api_tpu_torch.serving import tsdb as tsdb_mod
from deconv_api_tpu_torch.serving.alerts import AlertEngine, IncidentStore, parse_alert_rules
from deconv_api_tpu_torch.serving.aot import ArtifactStore, KernelResolver
from deconv_api_tpu_torch.serving.batcher import BatchingDispatcher, CircuitBreaker, LanePool, buckets, pad_bucket
from deconv_api_tpu_torch.serving.cache import L2Store, ResponseCache, Singleflight, canonical_digest
from deconv_api_tpu_torch.serving.codec_pool import HostBufferRing, WorkerPool
from deconv_api_tpu_torch.serving.http import HttpServer, Request, Response
from deconv_api_tpu_torch.serving.jobs import Checkpoint, JobManager, Result
from deconv_api_tpu_torch.serving.metrics import Metrics, parse_slos, slo_prometheus
from deconv_api_tpu_torch.serving.models import REGISTRY, ModelBundle, build_bundle, registry_info
from deconv_api_tpu_torch.serving.qos import QosPolicy
from deconv_api_tpu_torch.serving.trace import FlightRecorder, RequestTrace
from deconv_api_tpu_torch.serving.weight_manager import WEIGHT_DTYPES, WeightManager
from deconv_api_tpu_torch.utils import slog
from deconv_api_tpu_torch.utils.tracing import prime_profiler, profile_trace

log = logging.getLogger(__name__)
_slog_app = slog.get_logger("deconv.app")

# The route defaults of a default-configured server (the service reads its
# own ``cfg``): the reference serves the top 4 of its ranking as a 2x2 grid,
# and computing only those 4 projections gives the same grid; /v1/deconv
# answers the top 8.
STITCH_K = ServerConfig.stitch_k
DEFAULT_TOP_K = ServerConfig.top_k
# /v1/dream's defaults (deconv_api_tpu/config.py)
DREAM_DEFAULTS = {"steps": 10, "octaves": 10, "lr": 0.01}
_TRUTHY = ("1", "true", "yes", "on")
# a fetch polls its batch's CUDA event at most this often, backing off
# from the first interval to the last
_POLL_S = (5e-5, 1e-3)
# the compute routes the observation wrap covers: an SLO scoped to any
# other route would never observe
COMPUTE_ROUTES = frozenset(("/", "/v1/deconv", "/v1/dream"))
QOS_CLASSES = ("interactive", "standard", "bulk")


class Program(NamedTuple):
    """What one device program computes: requests with equal programs
    share a batch."""

    layer: str
    mode: str = "all"
    top_k: int = STITCH_K
    post: str = "grid"  # "grid" for POST /, "tiles" for /v1/deconv
    sweep: bool = False
    quality: str = "full"  # the effective tier (``_effective_quality``)


class Dream(NamedTuple):
    """What one dream computes: requests with equal dreams share a batch."""

    layers: tuple[str, ...]
    steps: int = DREAM_DEFAULTS["steps"]
    octaves: int = DREAM_DEFAULTS["octaves"]
    lr: float = DREAM_DEFAULTS["lr"]


class DreamOctave(NamedTuple):
    """One checkpointable octave of a dream job (the JAX package's
    ``("__dream_octave__", layers, steps, lr, shapes, i)`` key): rung
    ``index`` of the ladder ``shapes``.  Jobs at the same octave of the
    same dream share a batch."""

    layers: tuple[str, ...]
    steps: int
    lr: float
    shapes: tuple[tuple[int, int], ...]
    index: int


@contextlib.contextmanager
def stage(metrics: Metrics, name: str):
    """Time a pipeline stage into ``metrics`` and onto the active request
    trace (``deconv_api_tpu/utils/tracing.py:stage``)."""
    tr = trace_mod.current_trace()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        metrics.observe_stage(name, dt)
        if tr is not None:
            tr.add_span(name, t0, dt)


class DeconvService:
    """The dispatchers, the weight manager, the codec pool and the routes
    (the counterpart of ``deconv_api_tpu/serving/app.py:DeconvService`` for
    what the port serves).  ``cfg`` (``config.ServerConfig``, its fields
    also given as keyword ``overrides``) is validated here, at boot, with
    the JAX package's messages.

    ``registry`` maps model name -> zero-arg ``ModelBundle`` factory; it
    defaults to ``serving/models.py:REGISTRY`` on ``device``.  An injected
    ``bundle`` is the default model and joins the served set under its own
    name (alone when no registry is given).  The served set
    (``cfg.serve_models``) and its residency on the card live in
    ``weights``, a ``WeightManager``; ``bundle`` is the default model's.

    The service runs an asyncio event loop on a thread of its own, made at
    the first ``start``, ``submit`` or route call: the dispatchers, the
    codec pool's callers and the HTTP server (``listen``) live on it.  The
    blocking methods (``compat``, ``deconv_v1``, ``dream_v1``, ``submit``)
    run their coroutines there from any other thread."""

    def __init__(
        self, bundle: ModelBundle | None = None, cfg: ServerConfig | None = None, *,
        registry: dict[str, Callable[[], ModelBundle]] | None = None, device=None, **overrides,
    ):
        self.cfg = cfg = dataclasses.replace(cfg or ServerConfig(), **overrides)
        # the settings, validated at boot: a typo fails the process, not the
        # first request, and a setting the card cannot run never starts
        resolve_kpack_chan(cfg.lowc_kpack, cfg.top_k)
        resolve_fused_unpool(cfg.fused_unpool)
        if cfg.visualize_mode not in ("all", "max"):
            raise ValueError(f"visualize_mode must be 'all' or 'max', got {cfg.visualize_mode!r}")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {cfg.dtype!r}")
        if cfg.backward_dtype not in ("", "float32", "bfloat16"):
            raise ValueError(f"backward_dtype must be '', 'float32' or 'bfloat16', got {cfg.backward_dtype!r}")
        if not 1 <= cfg.top_k <= 64 or not 1 <= cfg.stitch_k <= 64:
            raise ValueError(f"top_k and stitch_k must be in [1, 64], got {cfg.top_k} and {cfg.stitch_k}")
        if cfg.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, got {cfg.weight_dtype!r}")
        if cfg.fleet_capacity < 0:
            raise ValueError(f"fleet_capacity must be >= 0 (0 = auto), got {cfg.fleet_capacity}")
        # the quality tiers, validated at boot: a mistyped tier fails the
        # process, not the first bulk request
        if cfg.quality_default not in QUALITY_TIERS:
            raise ValueError(f"quality_default must be one of {QUALITY_TIERS}, got {cfg.quality_default!r}")
        self._class_quality: dict[str, str] = {}
        for part in (cfg.quality_by_class or "").split(","):
            part = part.strip()
            if not part:
                continue
            cls, _, tier = part.partition("=")
            cls, tier = cls.strip(), tier.strip()
            if cls not in QOS_CLASSES:
                raise ValueError(f"quality_by_class: unknown class {cls!r} (expected interactive|standard|bulk)")
            if tier not in QUALITY_TIERS:
                raise ValueError(f"quality_by_class: tier for {cls!r} must be one of {QUALITY_TIERS}, got {tier!r}")
            self._class_quality[cls] = tier
        # per model: (the int8 walk's quant spec, the tag in its cache key)
        self._calib_cache: dict[str, tuple] = {}
        # latency SLOs, metric history and alert rules, validated at boot
        # with the JAX package's messages: a malformed spec is a config
        # error, not a silently dropped objective
        try:
            self.slos = parse_slos(cfg.slos, observable_routes=COMPUTE_ROUTES)
        except ValueError as e:
            raise ValueError(f"invalid slos spec: {e}") from e
        if cfg.tsdb not in ("off", "on"):
            raise ValueError(f"tsdb must be 'off' or 'on', got {cfg.tsdb!r}")
        if cfg.tsdb_interval_s <= 0:
            raise ValueError(f"tsdb_interval_s must be > 0, got {cfg.tsdb_interval_s}")
        try:
            alert_rules = parse_alert_rules(cfg.alerts, known_slos=frozenset(t.name for t in self.slos))
        except ValueError as e:
            raise ValueError(f"invalid alerts spec: {e}") from e
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
        self.sweep_metrics = Metrics("sweep")
        # Multi-tenant QoS (serving/qos.py), built at boot so a mistyped
        # tenants spec or weights string fails the process; None keeps the
        # plain FIFOs and no admission wrap
        self.qos = None
        if cfg.qos:
            self.qos = QosPolicy(cfg.tenants, default_class=cfg.qos_default_class, weights=cfg.qos_weights,
                                 hit_cost_ms=cfg.qos_hit_cost_ms, metrics=self.metrics)
        # fault injection: a default-configured server pays one global load
        # and a None test per site consultation
        self.faults = None
        if cfg.fault_injection or cfg.faults:
            self.faults = faults_mod.FaultRegistry(seed=cfg.fault_seed, metrics=self.metrics)
            if cfg.faults:
                self.faults.arm_string(cfg.faults)
            faults_mod.install(self.faults)
        self.bundle = bundle if bundle is not None else self._registry[cfg.model]()
        # the default model's weights load before the manager archives them
        self._load_weights(cfg.model, self.bundle)
        # the operator's image size applies to every model; 0 means each
        # model's own, and reads back as the default model's
        self._image_size_override = max(0, cfg.image_size)
        if cfg.image_size <= 0:
            cfg.image_size = self.bundle.image_size
        self.weights = WeightManager(
            {name: self._registry[name] for name in served}, cfg.model, default_bundle=self.bundle,
            pinned=tuple(pinned), budget_bytes=cfg.hbm_budget_bytes, weight_dtype=cfg.weight_dtype,
            metrics=self.metrics, weights_loader=self._load_weights,
        )
        if cfg.calibration_dir:
            # the artifacts are read here (written by engine/quant.py's
            # save_calibration): the boot sweeps torn temporary files and
            # loads the served models' artifacts, so /readyz reports the
            # calibrated set from the first probe and no int8 dispatch
            # reads a file on a worker thread
            durable.sweep_tmp(cfg.calibration_dir)
            for name in sorted(self.weights.served):
                self._quant_spec(name)
        self.lowc_kpack = cfg.lowc_kpack
        self.max_batch = cfg.max_batch
        self.ready = False
        # set when shutdown begins: /readyz turns 503 before the listener goes
        self.draining = False
        # the drain is announced to the routers once
        self._drain_announced = False
        # (host, port) the listener bound, once it has
        self.bound: tuple[str, int] | None = None
        self.warmup_wall_s: float | None = None
        self.warmup_wall_s_by_model: dict[str, float] = {}
        # one lane, the card, shared by the three dispatchers: they fail
        # together, so one breaker opens for all of them
        self.lane_pool = LanePool(
            1,
            breaker_factory=lambda: (
                CircuitBreaker(cfg.breaker_threshold, cfg.breaker_cooldown_s)
                if cfg.breaker_threshold > 0 else None
            ),
            metrics=self.metrics,
        )
        self.breaker = self.lane_pool.lanes[0].breaker
        self.codec_pool = WorkerPool(cfg.codec_workers, max_pending=cfg.codec_queue_depth, metrics=self.metrics)
        # staging buffers of the padded inputs and of the outputs' host
        # rows: pinned on the card, where they are never freed while serving
        pinned_host = self.bundle.device.type == "cuda"
        self.input_ring = HostBufferRing(cfg.input_ring_depth, pin_memory=pinned_host)
        self.output_ring = HostBufferRing(cfg.input_ring_depth, pin_memory=pinned_host)
        self.recorder = (
            FlightRecorder(cfg.trace_ring, slow_ms=cfg.trace_slow_ms, sample=cfg.trace_sample)
            if cfg.trace_ring > 0 else None
        )
        # The content-addressed response cache and singleflight
        # (serving/cache.py): a hit answers before any decode and never
        # reaches a dispatcher; N identical requests in flight cost one
        # device row.  The key prefix folds in every setting that decides
        # the response bytes (``_model_prefix``).  The L2 disk tier is off
        # unless ``l2_dir`` is set.
        self.cache = (
            ResponseCache(cfg.cache_bytes, ttl_s=cfg.cache_ttl_s, negative_ttl_s=cfg.cache_negative_ttl_s,
                          shards=cfg.cache_shards, metrics=self.metrics)
            if cfg.cache_bytes > 0 else None
        )
        self.l2 = L2Store(cfg.l2_dir, cfg.l2_bytes, metrics=self.metrics) if cfg.l2_dir else None
        self.flights = Singleflight() if cfg.singleflight else None
        self._prefix_cache: dict[str, str] = {}
        # The warm boot (serving/aot.py): with aot_dir set, every kernel
        # library comes from a digest-verified store (its nvcc build,
        # stored, on a miss); on the card the boot resolves them all
        # before /ready, so no request waits on nvcc.  Empty: the libraries
        # build into the checkout at their first launch, as without it.
        self.aot = None
        if cfg.aot_dir:
            self.aot = KernelResolver(ArtifactStore(cfg.aot_dir, cfg.aot_bytes, metrics=self.metrics),
                                      metrics=self.metrics)
            _build.resolver = self.aot
        # Metric history and alerting (serving/tsdb.py, serving/alerts.py):
        # a self-scrape task samples the main registry into two ring tiers
        # and the alert engine evaluates its rules on the same tick.  'off'
        # with no alerts spec constructs nothing: no routes, no task.
        self.tsdb = self.alert_engine = self.incidents = None
        self._tsdb_task: asyncio.Task | None = None
        if cfg.tsdb == "on" or cfg.alerts:
            self.tsdb = tsdb_mod.Tsdb(cfg.tsdb_interval_s)
            if alert_rules:
                self.alert_engine = AlertEngine(alert_rules, self.tsdb, slos=self.slos)
            if cfg.incidents_dir:
                self.incidents = IncidentStore(cfg.incidents_dir, retention_s=cfg.incidents_retention_s,
                                               metrics=self.metrics)
        # torch.profiler traces (utils/tracing.py): with profile_dir set,
        # the first DECONV_PROFILE_BATCHES device batches after warmup, and
        # as many as each POST /v1/profile arms; one trace at a time across
        # the three dispatchers (the lock is taken without blocking)
        self._profile_remaining = int(os.environ.get("DECONV_PROFILE_BATCHES", "4")) if cfg.profile_dir else 0
        self._profile_lock = threading.Lock()
        if cfg.profile_dir:
            prime_profiler()
        # a fetch gives up on a batch that outlives the longest timeout
        self._fetch_wait_s = max(cfg.request_timeout_s, cfg.dream_timeout_s, cfg.sweep_timeout_s)
        self.dispatcher = self._dispatcher(self._dispatch_deconv, cfg.max_batch, cfg.batch_window_ms,
                                           cfg.request_timeout_s, self.metrics)
        self.dream_dispatcher = self._dispatcher(self._dispatch_dream, cfg.dream_max_batch, cfg.dream_window_ms,
                                                 cfg.dream_timeout_s, self.dream_metrics)
        self.sweep_dispatcher = self._dispatcher(self._dispatch_deconv, cfg.max_batch, cfg.batch_window_ms,
                                                 cfg.sweep_timeout_s, self.sweep_metrics)
        self.server = HttpServer(idle_timeout_s=cfg.conn_idle_timeout_s, body_timeout_s=cfg.body_read_timeout_s,
                                 max_connections=cfg.max_connections)
        # Durable async jobs (serving/jobs.py): long dreams and sweeps as
        # 202-accepted, journaled, checkpoint-resumed work on the three
        # dispatchers.  Only with a jobs_dir: a default server has no job
        # routes and no runner tasks.
        self.jobs = None
        if cfg.jobs_dir:
            self.jobs = JobManager(
                cfg.jobs_dir, self._execute_job, metrics=self.metrics, lane_pool=self.lane_pool,
                queue_depth=cfg.jobs_queue_depth, workers=cfg.jobs_workers, retention_s=cfg.jobs_retention_s,
                max_attempts=cfg.jobs_max_attempts,
            )
        self._add_routes()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._loop_lock = threading.Lock()
        self._listening = False
        self._closed = False

    def _dispatcher(self, dispatch, max_batch: int, window_ms: float, timeout_s: float,
                    metrics: Metrics) -> BatchingDispatcher:
        dispatch = self._profiled(dispatch)
        return BatchingDispatcher(
            lambda key, images: dispatch(key, images)(), max_batch=max_batch, window_ms=window_ms,
            request_timeout_s=timeout_s, metrics=metrics, shed_factor=self.cfg.shed_factor,
            dispatch_runner=dispatch, pipeline_depth=self.cfg.pipeline_depth, lane_pool=self.lane_pool,
            qos=self.qos,
        )

    def _profiled(self, dispatch):
        """The dispatch runner ``dispatch`` as the JAX package runs it while
        a profile budget is armed: the batch runs to its end inside the
        trace scope (``_profile_scope``) and its thunk returns the result,
        so the trace covers the replay and the copies, not the enqueue
        alone."""

        def run(key, images):
            if self._profile_remaining <= 0:
                return dispatch(key, images)
            with self._profile_scope():
                thunk = dispatch(key, images)
                result = thunk()

            def done():
                return result

            done.page_in_s = getattr(thunk, "page_in_s", None)
            done.page_model = getattr(thunk, "page_model", None)
            return done

        return run

    @contextlib.contextmanager
    def _profile_scope(self):
        """Trace this dispatch while the budget lasts (no-op without
        ``profile_dir``).  Warmup dispatches are excluded, and a dispatch
        that finds another dispatcher tracing runs untraced."""
        if self._profile_remaining <= 0 or not self.ready or not self._profile_lock.acquire(blocking=False):
            yield
            return
        try:
            if self._profile_remaining <= 0:
                yield
                return
            self._profile_remaining -= 1
            with profile_trace(self.cfg.profile_dir):
                yield
        finally:
            self._profile_lock.release()

    def _load_weights(self, name: str, bundle: ModelBundle) -> None:
        """``weights_path`` into one model's bundle (the JAX package's
        ``_load_weights``).  A FILE belongs to the default model only.  A
        DIRECTORY loads ``<dir>/<model>.h5`` (or ``.npz``) for each served
        model; a served model other than the default with no file there
        serves its init and says so once; the default with no file reads
        the directory itself as a checkpoint: the port's (``train``'s
        output, ``utils/checkpoint.py``) loads when its manifest names the
        default model, and any other is a boot error, the JAX package's
        orbax format included (``models/weights.py``)."""
        wp = self.cfg.weights_path
        if not wp:
            return
        path = wp
        if os.path.isdir(wp):
            for cand in (os.path.join(wp, f"{name}.h5"), os.path.join(wp, f"{name}.npz")):
                if os.path.exists(cand):
                    path = cand
                    break
            else:
                if name != self.cfg.model:
                    slog.event(_slog_app, "weights_missing", level=logging.WARNING, model=name, dir=True,
                               note="serving init weights; add <model>.h5 or <model>.npz to the weights dir")
                    return
        elif name != self.cfg.model:
            return  # a file is one model's weights: the default's
        bundle.params = load_model_weights(name, bundle.spec, path, bundle.params)

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
    def batch_sizes(self):
        """Images per executed deconv batch, the most recent ones."""
        return self.dispatcher.batch_sizes

    @property
    def dream_batch_sizes(self):
        """Images per executed dream batch, the most recent ones."""
        return self.dream_dispatcher.batch_sizes

    # --- device work: the dispatch step and its fetch -----------------------

    def _host_rows(self, device: torch.device, outputs: dict, n: int):
        """Enqueue non-blocking copies of the first ``n`` rows of every
        tensor of ``outputs`` (``{name: {key: tensor}}``) into output ring
        buffers of their bucket's shape, then record an event after them.
        Returns ``(slots, event)``; ``event`` is None on the CPU, where the
        copies are done."""
        slots = {}
        for name, entry in outputs.items():
            slots[name] = {}
            for key, t in entry.items():
                buf = self.output_ring.acquire(t.shape, t.dtype)
                buf[:n].copy_(t[:n], non_blocking=True)
                slots[name][key] = buf
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return slots, event

    def _fetch_rows(self, slots: dict, event, n: int) -> dict:
        """Wait for ``event`` (the batch's copies), then copy the ``n`` real
        rows out of the slots and hand the slots back to their ring.  The
        wait polls in short slices holding ``DEVICE_LOCK`` shared: an event
        query while another thread captures would invalidate the capture,
        and a slice never holds a capture back for long."""
        try:
            if event is not None:
                deadline = time.perf_counter() + self._fetch_wait_s
                pause = _POLL_S[0]
                while True:
                    with DEVICE_LOCK.shared():
                        if event.query():
                            break
                    if time.perf_counter() > deadline:
                        raise errors.Unavailable(f"device work did not finish within {self._fetch_wait_s:.0f} s")
                    time.sleep(pause)
                    pause = min(2 * pause, _POLL_S[1])
            return {name: {k: buf[:n].numpy().copy() for k, buf in entry.items()} for name, entry in slots.items()}
        finally:
            for entry in slots.values():
                for buf in entry.values():
                    self.output_ring.release(buf)

    def _enqueue_program(
        self, program: Program, images, fused_unpool: str | None = None, lowc_kpack: str | None = None,
        model: str | None = None,
    ) -> Callable[[], dict]:
        """The dispatch step of a deconv batch: ``images`` (B preprocessed
        (H, W, 3) images of ``model``, default the default model) through
        one device program with the server's settings (``bug_compat``,
        ``backward_dtype``, ``dtype``, ``fused_unpool``; a DAG model ignores
        the first two and projects in fp32), run as the captured program of
        its bucket (``pad_bucket`` of ``max_batch``), its tail padded with
        the last image.  Returns the fetch, ``() -> {layer: {post, "valid",
        "indices"}}`` of the B real rows as numpy; ``post`` is
        ``program.post``, uint8 (B, 2H, 2W, 3) grids or (B, K, H, W, 3)
        tiles.  ``fused_unpool`` and ``lowc_kpack`` default to the server's
        policies.  ``program.quality`` (an effective tier) picks the
        program: ``bf16`` (or ``dtype=bfloat16``) stages the batch in
        bfloat16, ``int8`` runs the int8 walk on the model's quant spec
        (``_quant_spec``).  The fetch carries ``page_in_s`` and
        ``page_model`` when the batch paged its weights in."""
        n = len(images)
        bucket = pad_bucket(n, self.max_batch)
        name = model or self.weights.default
        bundle = self.weights.bundle(name)
        quant = None
        if program.quality == "int8":
            quant = self._quant_spec(name)[0]
            self.metrics.inc_counter("quant_int8_batches_total")
        elif program.quality == "bf16":
            self.metrics.inc_counter("quant_bf16_batches_total")
        # dtype is the forward's (the engine follows the staged batch):
        # quality=bf16 is the per-request form of dtype=bfloat16
        bf16 = self.cfg.dtype == "bfloat16" or program.quality == "bf16"
        dtype = torch.bfloat16 if bf16 else torch.float32
        _, page_s = self.weights.checkout(name)
        staging = slots = None
        try:
            prog = bundle.program(
                program.layer, program.mode, program.top_k, bucket, bug_compat=self.cfg.bug_compat,
                backward_dtype=self.cfg.backward_dtype or None, post=program.post,
                fused_unpool=self.cfg.fused_unpool if fused_unpool is None else fused_unpool,
                sweep=program.sweep, lowc_kpack=self.lowc_kpack if lowc_kpack is None else lowc_kpack,
                quant=quant, dtype=dtype, image_size=self._model_image_size(bundle),
            )
            with bundle.programs.replaying():
                staging = self.input_ring.assemble(images, bucket)
                prog.load(staging, non_blocking=True)
                out = prog.replay()
                slots, event = self._host_rows(
                    bundle.device, {layer: {k: entry[k] for k in (program.post, "valid", "indices")}
                                    for layer, entry in out.items()}, n)
        except BaseException:
            if staging is not None:
                self.input_ring.release(staging)
            self.weights.release(name)
            raise

        def fetch() -> dict:
            try:
                return self._fetch_rows(slots, event, n)
            finally:
                self.input_ring.release(staging)
                self.weights.release(name)  # the batch's outputs are on the host

        fetch.page_in_s, fetch.page_model = page_s, name
        return fetch

    def _enqueue_dream(self, dream: Dream, images, model: str | None = None) -> Callable[[], tuple]:
        """The dispatch step of a dream batch: ``images`` (B preprocessed
        images) dreamed on one octave ladder of the bundle's
        ``min_dream_size`` through the captured programs of its bucket
        (``pad_bucket`` of ``dream_max_batch``), its tail padded with the
        last image.  Returns the fetch, ``() -> (dreamed images (B, H, W, 3)
        fp32 in model-input space, final losses (B,))`` as numpy."""
        n = len(images)
        bucket = pad_bucket(n, self.cfg.dream_max_batch)
        name = model or self.weights.default
        bundle = self.weights.bundle(name)
        _, page_s = self.weights.checkout(name)
        staging = slots = None
        try:
            size = self._model_image_size(bundle)
            ladder = octave_shapes(size, size, dream.octaves, 1.4, bundle.min_dream_size)
            rungs = bundle.dream_program(dream.layers, ladder, bucket)
            with bundle.dream_programs.replaying():
                staging = self.input_ring.assemble(images, bucket)
                # every rung's pyramid step reads the base: it lives on the
                # card until the fetch
                base = staging.to(bundle.device, non_blocking=True)
                out, losses = run_dream_programs(rungs, base, dream.steps, dream.lr)
                slots, event = self._host_rows(bundle.device, {"dream": {"image": out, "loss": losses}}, n)
        except BaseException:
            if staging is not None:
                self.input_ring.release(staging)
            self.weights.release(name)
            raise

        def fetch() -> tuple:
            try:
                rows = self._fetch_rows(slots, event, n)["dream"]
                return rows["image"], rows["loss"]
            finally:
                self.input_ring.release(staging)
                self.weights.release(name)

        fetch.base = base  # read by the queued rungs until the event
        fetch.page_in_s, fetch.page_model = page_s, name
        return fetch

    def _enqueue_dream_octave(self, octave: DreamOctave, pairs: list, model: str | None = None) -> Callable[[], tuple]:
        """The dispatch step of one dream octave of a batch of jobs (the
        JAX package's ``_dispatch_dream_octave``): ``pairs`` are (x, base),
        the dream at the previous rung's size (ignored at rung 0) and the
        full-size input.  Rung ``octave.index`` of the captured programs of
        the whole dream (``ModelBundle.dream_program``, the same graphs at
        the same bucket) runs as ``run_dream_programs`` runs it: its
        pyramid step from x and the base, then ``steps`` ascent steps.  The
        fetch returns (x at the rung's size, losses (B,)) as numpy, so the
        walk's x round-trips the host exactly (float32) between octaves."""
        n = len(pairs)
        bucket = pad_bucket(n, self.cfg.dream_max_batch)
        name = model or self.weights.default
        bundle = self.weights.bundle(name)
        _, page_s = self.weights.checkout(name)
        staged = []
        slots = None
        try:
            rungs = bundle.dream_program(octave.layers, octave.shapes, bucket)
            with bundle.dream_programs.replaying():
                # the pyramid steps read their inputs on the card: they live
                # there until the fetch
                inputs = [[b for _, b in pairs]] + ([[x for x, _ in pairs]] if octave.index else [])
                for rows in inputs:
                    staged.append(self.input_ring.assemble(rows, bucket))
                base, *prev = [t.to(bundle.device, non_blocking=True) for t in staged]
                x, losses = run_dream_rung(rungs, octave.index, prev[0] if prev else None, base, octave.steps,
                                           octave.lr)
                slots, event = self._host_rows(bundle.device, {"dream": {"image": x, "loss": losses}}, n)
        except BaseException:
            for buf in staged:
                self.input_ring.release(buf)
            self.weights.release(name)
            raise

        def fetch() -> tuple:
            try:
                rows = self._fetch_rows(slots, event, n)["dream"]
                return rows["image"], rows["loss"]
            finally:
                for buf in staged:
                    self.input_ring.release(buf)
                self.weights.release(name)

        fetch.inputs = (base, *prev)  # read by the queued rung until the event
        fetch.page_in_s, fetch.page_model = page_s, name
        return fetch

    def _device_faults(self) -> None:
        """The device fault sites of a dispatch (``device.dispatch_delay_ms``,
        ``device.dispatch_error`` on lane 0), on the dispatch worker."""
        act = faults_mod.check("device.dispatch_delay_ms")
        if act is not None:
            time.sleep((act.param or 100.0) / 1e3)
        faults_mod.raise_if_armed("device.dispatch_error", where=0)

    def _dispatch_deconv(self, key: tuple[str, Program], images: list) -> Callable[[], list]:
        """The deconv and sweep dispatchers' dispatch runner: enqueue the
        batch and return its materialise thunk, which fetches the rows,
        JPEG-encodes the fired grids on the codec pool (one failed encode
        costs its own request a retry on the route, not the batch) and
        splits the rows per request: ``{layer: {post, "valid", "indices"[,
        "data_url"]}}``."""
        model, program = key
        self._device_faults()
        fetch = self._enqueue_program(program, images, model=model)
        n = len(images)

        def materialise() -> list:
            out = fetch()
            if program.post == "grid":
                t_enc = time.perf_counter()
                for entry in out.values():
                    fired = [i for i in range(n) if entry["valid"][i].any()]
                    encoded = self.codec_pool.map_sync_settle(codec.encode_data_url, [entry["grid"][i] for i in fired])
                    urls = [None] * n
                    for i, url in zip(fired, encoded):
                        urls[i] = None if isinstance(url, BaseException) else url
                    entry["data_url"] = urls
                self.metrics.observe_stage("encode", time.perf_counter() - t_enc)
            return [{layer: {k: v[i] for k, v in entry.items()} for layer, entry in out.items()} for i in range(n)]

        if fetch.page_in_s:
            materialise.page_in_s, materialise.page_model = fetch.page_in_s, fetch.page_model
        return materialise

    def _dispatch_dream(self, key: tuple[str, Dream | DreamOctave], images: list) -> Callable[[], list]:
        """The dream dispatcher's dispatch runner: a whole dream, or with a
        ``DreamOctave`` key one octave of dream jobs (``images`` are then
        (x, base) pairs)."""
        model, dream = key
        self._device_faults()
        if isinstance(dream, DreamOctave):
            fetch = self._enqueue_dream_octave(dream, images, model)
        else:
            fetch = self._enqueue_dream(dream, images, model)

        def materialise() -> list:
            out, losses = fetch()
            return [{"image": out[i], "loss": float(losses[i])} for i in range(len(images))]

        if fetch.page_in_s:
            materialise.page_in_s, materialise.page_model = fetch.page_in_s, fetch.page_model
        return materialise

    def run_program(
        self, program: Program, xs, fused_unpool: str | None = None, lowc_kpack: str | None = None,
        model: str | None = None,
    ) -> dict[str, dict[str, np.ndarray]]:
        """``_enqueue_program`` and its fetch, on the calling thread:
        preprocessed images (B, H, W, 3) -> ``{layer: {post, "valid",
        "indices"}}`` as numpy."""
        return self._enqueue_program(program, xs, fused_unpool, lowc_kpack, model)()

    def run_dream(self, dream: Dream, xs, model: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        """``_enqueue_dream`` and its fetch, on the calling thread:
        preprocessed images (B, H, W, 3) -> (dreamed images, final losses)
        as numpy."""
        return self._enqueue_dream(dream, xs, model)()

    def visualize_batch(
        self, layer: str, xs: np.ndarray, fused_unpool: str | None = None, model: str | None = None,
    ):
        """The ``POST /`` program on a batch: ``{"grid", "valid", "indices"}``."""
        return self.run_program(self._grid_program(layer), xs, fused_unpool, model=model)[layer]

    def _grid_program(self, layer: str) -> Program:
        """``POST /``'s program at ``layer``: the server's visualize mode and
        stitch k."""
        return Program(layer, self.cfg.visualize_mode, self.cfg.stitch_k)

    def _model_image_size(self, bundle: ModelBundle) -> int:
        """The size a model's requests resize to: the operator's
        ``image_size`` when one was configured, else the model's own."""
        return self._image_size_override or bundle.image_size

    def warmup_programs(self, model: str | None = None) -> list[tuple[Program | Dream, int]]:
        """What the card's warmup captures for ``model`` (default: the
        default model), as (program, bucket), as the JAX package's warmup
        runs them: both route defaults at its deepest layer (``POST /``'s
        grid at ``stitch_k``, ``/v1/deconv``'s tiles at ``top_k``, in the
        server's ``visualize_mode``) at every deconv bucket, or only the
        first without ``warmup_all_buckets``; for the default model, with
        ``warmup_sweep`` the sweep at bucket 1 and with ``warmup_dream`` the
        default dream at every dream bucket (or the first) where the model
        has dream layers."""
        name = model or self.weights.default
        bundle = self.weights.bundle(name)
        layer, mode, is_default = bundle.deepest_layer(), self.cfg.visualize_mode, name == self.weights.default
        first = not self.cfg.warmup_all_buckets
        sizes = buckets(self.max_batch)[:1] if first else buckets(self.max_batch)
        out = [(p, b) for b in sizes
               for p in (self._grid_program(layer), Program(layer, mode, self.cfg.top_k, "tiles"))]
        if self.cfg.warmup_sweep and is_default:
            out.append((Program(layer, mode, self.cfg.top_k, "tiles", True), sizes[0]))
        if self.cfg.warmup_dream and is_default and bundle.dream_layers:
            dream_sizes = buckets(self.cfg.dream_max_batch)
            out += [(Dream(bundle.dream_layers), b) for b in (dream_sizes[:1] if first else dream_sizes)]
        return out

    def warm(self, program: Program | Dream, bucket: int, model: str | None = None) -> None:
        """Run ``program`` once on a zero batch of ``bucket`` images, which
        captures it on the card (and fills the staging rings)."""
        size = self._model_image_size(self.weights.bundle(model or self.weights.default))
        xs = np.zeros((bucket, size, size, 3), np.float32)
        if isinstance(program, Dream):
            self.run_dream(program, xs, model)
        else:
            self.run_program(program, xs, model=model)

    def warmup(self) -> None:
        """Make the programs a first request would wait for, for every
        pinned model (the default first), then mark the service ready (the
        reference's warmup).  On the card: with ``aot_dir``, resolve every
        kernel library first, then ``warm`` every entry of each model's
        ``warmup_programs``.  On the CPU, where nothing is captured
        and boots stay fast: one batch-1 grid a model.  ``warmup_wall_s``
        is the time it took, ``warmup_wall_s_by_model`` each model's part
        (with its page-in)."""
        t0 = time.perf_counter()
        if self.aot is not None and self.bundle.device.type == "cuda":
            self.aot.resolve(_build.KERNELS)
        gen = np.random.default_rng(0)
        for name in self.weights.pinned:
            t_model = time.perf_counter()
            bundle = self.weights.bundle(name)
            if bundle.device.type == "cuda":
                for program, bucket in self.warmup_programs(name):
                    self.warm(program, bucket, name)
            else:
                size = self._model_image_size(bundle)
                xs = gen.normal(0, 50, (1, size, size, 3)).astype(np.float32)
                self.visualize_batch(bundle.deepest_layer(), xs, model=name)
            self.warmup_wall_s_by_model[name] = time.perf_counter() - t_model
        self.warmup_wall_s = time.perf_counter() - t0
        self.metrics.set_gauge("warmup_seconds", self.warmup_wall_s)
        self.ready = True

    # --- the event loop and the dispatchers ---------------------------------

    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        with self._loop_lock:
            if self._loop is None:
                loop = asyncio.new_event_loop()
                thread = threading.Thread(target=loop.run_forever, name="deconv-loop", daemon=True)
                thread.start()
                self._loop, self._loop_thread = loop, thread
            return self._loop

    def on_loop(self, coro, timeout: float | None = None):
        """Run ``coro`` on the service's event loop and wait for its result
        (from any other thread)."""
        return asyncio.run_coroutine_threadsafe(coro, self._ensure_loop()).result(timeout)

    def start(self) -> None:
        """Start the three dispatchers, then with ``jobs_dir`` the job
        runners (their stages ride the dispatchers; the boot already
        re-queued reclaimed jobs), and with ``tsdb`` on the self-scrape
        task (and the codec pool and the L2 writer anew after a ``close``:
        the L2's entries outlive it)."""
        if self.codec_pool.closed:
            self.codec_pool = WorkerPool(self.cfg.codec_workers, max_pending=self.cfg.codec_queue_depth,
                                         metrics=self.metrics)
        if self.l2 is not None and self.l2.closed:
            self.l2 = L2Store(self.cfg.l2_dir, self.cfg.l2_bytes, metrics=self.metrics)
        if self.aot is not None:
            _build.resolver = self.aot
        self._closed = False

        async def start():
            for d in (self.dispatcher, self.dream_dispatcher, self.sweep_dispatcher):
                await d.start()
            if self.jobs is not None:
                self.jobs.start()
            if self.tsdb is not None and self._tsdb_task is None:
                self._tsdb_task = asyncio.get_running_loop().create_task(self._tsdb_loop(), name="tsdb-scrape")

        self.on_loop(start())

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind the HTTP server on the event loop; returns the bound port."""
        bound = self.on_loop(self.server.start(host, port))
        self._listening = True
        self.bound = (host, bound)
        return bound

    def stop_listening(self, grace_s: float = 5.0) -> None:
        """Close the listener (open connections get ``grace_s``); the event
        loop ends once the dispatchers are closed too."""
        if self._listening:
            self._listening = False
            self.on_loop(self.server.stop(grace_s))
        self._maybe_end_loop()

    def begin_drain(self) -> None:
        """Flip into draining before the listener closes: ``/readyz``
        answers 503 so load balancers stop routing, and every response on
        a live keep-alive connection carries ``connection: close``.  Queued
        jobs park now (journaled: the next boot reclaims them), running
        jobs at their next checkpoint boundary."""
        self.draining = True
        self.server.draining = True
        if self.jobs is not None and not self.jobs.draining:
            if self._loop is None or threading.current_thread() is self._loop_thread:
                self.jobs.begin_drain()
            else:  # the manager's state lives on the event loop
                async def park():
                    self.jobs.begin_drain()

                self.on_loop(park())

    def close(self, timeout: float = 10.0) -> None:
        """Begin the drain (``/readyz`` answers 503 and every response
        carries ``connection: close`` from here), hold it ``drain_grace_s``
        so load balancers see the flip, then stop the job runners (running
        jobs park at their next checkpoint, cancelled mid-octave past 5 s),
        the three dispatchers within one shared grace of ``timeout``
        seconds, the codec pool, the scrape task, the L2 writer (its queued
        writes flushed) and the fault hook.  The listener, if any, stays up
        until ``stop_listening``."""
        self.begin_drain()
        if self._loop is not None and not self._closed:
            async def stop():
                # the routers learn of the drain now, not at their next
                # probe, and keep the listener's grace as a peer-fill window
                await self.announce_to_routers("drain")
                if self.cfg.drain_grace_s > 0:
                    await asyncio.sleep(self.cfg.drain_grace_s)
                if self._tsdb_task is not None:
                    self._tsdb_task.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await self._tsdb_task
                    self._tsdb_task = None
                if self.jobs is not None:
                    # before the dispatchers: a runner parking mid-octave
                    # journals from its cancellation handler, and its
                    # in-flight item is dropped at the reap boundary
                    await self.jobs.stop()
                deadline = time.perf_counter() + timeout
                for d in (self.dispatcher, self.dream_dispatcher, self.sweep_dispatcher):
                    await d.stop(grace_s=max(0.0, deadline - time.perf_counter()))

            self.on_loop(stop())
        self._closed = True
        self.codec_pool.close()
        if self.jobs is not None:
            self.jobs.journal.close()
        if self.l2 is not None:
            self.l2.close()
        if self.faults is not None:
            faults_mod.uninstall(self.faults)
        if self.aot is not None and _build.resolver is self.aot:
            _build.resolver = None
        self._maybe_end_loop()

    def _maybe_end_loop(self) -> None:
        with self._loop_lock:
            if self._loop is None or self._listening or not self._closed:
                return
            loop, thread = self._loop, self._loop_thread
            self._loop = self._loop_thread = None
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
        # the pinned buffers go now, while no capture can run
        with DEVICE_LOCK.exclusive() if self.bundle.device.type == "cuda" else contextlib.nullcontext():
            self.input_ring.clear()
            self.output_ring.clear()

    def _advertise_name(self) -> str:
        """The host:port this backend registers as: ``fleet_advertise``, else
        '<hostname>:<bound port>' (a 0.0.0.0 bind is no address a peer can
        dial)."""
        if self.cfg.fleet_advertise:
            return self.cfg.fleet_advertise
        port = self.bound[1] if self.bound else 0
        return f"{socket.gethostname()}:{port}"

    def fleet_capacity(self) -> int:
        """The capacity this member advertises on registration:
        ``fleet_capacity`` when set, else 1 (the port runs no pod)."""
        return self.cfg.fleet_capacity if self.cfg.fleet_capacity > 0 else 1

    async def announce_to_routers(self, action: str) -> int:
        """``POST /v1/internal/register`` (with the shared fleet token) to
        every router of ``fleet_routers``: ``register`` once the listener
        answers, with this member's capacity; ``drain`` at shutdown (once),
        with ``grace_s``, the seconds the listener stays up, in which the
        router still hints peer fills at this backend.  Best effort: a
        router that is not reached learns the same from its probes.
        Returns how many routers acknowledged."""
        if not self.cfg.fleet_routers:
            return 0
        if action == "drain":
            if self._drain_announced:
                return 0
            self._drain_announced = True
        adv = self._advertise_name()
        fields = {"backend": adv, "action": action}
        if action == "register":
            fields["capacity"] = str(self.fleet_capacity())
        else:
            fields["grace_s"] = repr(float(self.cfg.drain_grace_s))
        body = urllib.parse.urlencode(fields).encode()
        headers = {"content-type": "application/x-www-form-urlencoded", "x-fleet-token": self.cfg.fleet_token}
        routers = [r.strip() for r in self.cfg.fleet_routers.split(",") if r.strip()]
        acks = 0
        for router in routers:
            host, _, port = router.rpartition(":")
            if not host or not port.isdigit():
                slog.event(_slog_app, "announce_bad_router", level=logging.WARNING, router=router)
                continue
            try:
                status, _h, rbody = await fleet_mod.raw_request(host, int(port), "POST", "/v1/internal/register",
                                                                headers, body, 5.0)
            except Exception as e:  # noqa: BLE001 — best effort
                slog.event(_slog_app, "announce_failed", level=logging.WARNING, router=router, action=action,
                           error=f"{type(e).__name__}: {e}")
                continue
            if status == 200:
                acks += 1
            else:
                slog.event(_slog_app, "announce_rejected", level=logging.ERROR, router=router, action=action,
                           status=status, body=rbody[:200].decode("utf-8", "replace"))
        slog.event(_slog_app, "announce_done", backend=adv, action=action, acks=acks, routers=len(routers))
        return acks

    def submit(self, program: Program, x: np.ndarray, model: str | None = None, tenant: str = "",
               tclass: str = "") -> concurrent.futures.Future:
        """Queue one image of ``model`` for ``program`` on its dispatcher (a
        sweep on the sweep dispatcher): requests batch together only with
        the same model and program.  Returns a future of the image's
        ``{layer: {...}}``."""
        dispatcher = self.sweep_dispatcher if program.sweep else self.dispatcher
        key = (model or self.weights.default, program)
        return asyncio.run_coroutine_threadsafe(dispatcher.submit(x, key, tenant=tenant, tclass=tclass),
                                                self._ensure_loop())

    # --- requests ----------------------------------------------------------

    def resolve_request_model(self, req: Request) -> str:
        """``resolve_model`` of the request's form (an unparseable body
        leaves the default: its handler answers 400), memoized on the
        request so the cache wrap, the route and the trace agree on one
        resolution."""
        if not req.model:
            try:
                form = req.form()
            except Exception:  # noqa: BLE001 — any parse error: the handler 400s it
                form = {}
            req.model = self.resolve_model(form, req.headers)
        return req.model

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

    def resolve_quality(self, form: dict[str, str], headers=None, tclass: str = "") -> str:
        """The request's precision tier: the ``quality`` form field (wins),
        else the ``x-quality`` header, else the QoS class's tier
        (``quality_by_class``), else ``quality_default``.  Anything but
        full|bf16|int8 is a 422 ``illegal_quality``."""
        raw = (form.get("quality") or (headers or {}).get("x-quality", "")).strip().lower()
        if not raw:
            raw = self._class_quality.get(tclass, "") or self.cfg.quality_default
        if raw not in QUALITY_TIERS:
            raise errors.IllegalQuality(f"quality must be one of {QUALITY_TIERS}, got {raw!r}")
        return raw

    def _resolve_quality(self, req: Request | None, form: dict[str, str] | None = None, headers=None) -> str:
        """``resolve_quality`` of the request, memoized on it so the cache
        wrap and the route agree on one resolution (an unparseable body
        takes the default: its handler answers 400).  Without a request
        (the blocking helpers) it reads ``form`` and ``headers``."""
        if req is None:
            return self.resolve_quality(form or {}, headers)
        if not req.quality:
            if form is None:
                try:
                    form = req.form()
                except Exception:  # noqa: BLE001 — any parse error: the handler 400s it
                    form = {}
            req.quality = self.resolve_quality(form, req.headers, req.tclass)
            tr = trace_mod.current_trace()
            if tr is not None and req.quality != "full":
                tr.annotate(quality=req.quality)
        return req.quality

    def _effective_quality(self, quality: str, bundle: ModelBundle | None, route: str = "") -> str:
        """The tier a (model, route) pair runs, which is also the one its
        cache key carries: dreams have no quantized form (every tier runs
        as full); a DAG model has no int8 walk (int8 runs as bf16); a
        server whose forward is already bfloat16 runs bf16 as full."""
        if quality == "full" or route == "/v1/dream":
            return "full"
        if quality == "int8" and bundle is not None and bundle.spec is None:
            quality = "bf16"
        if quality == "bf16" and self.cfg.dtype == "bfloat16":
            return "full"
        return quality

    def _quality_prefix(self, eq: str, model: str) -> str:
        """What an effective tier adds to the cache-key prefix: nothing for
        full (the key stays the one without tiers), the tier's name for
        bf16, and for int8 the tier and the model's calibration tag, so a
        recalibration invalidates exactly the int8 entries."""
        if eq == "int8":
            return f"|q=int8:{self._quant_spec(model)[1]}"
        if eq != "full":
            return f"|q={eq}"
        return ""

    def _quant_spec(self, model: str) -> tuple:
        """The int8 walk's scales for ``model``: ``(quant, tag)``, the
        calibrated (entry, amax) pairs of its artifact in
        ``calibration_dir`` with the artifact's digest, or ``("dynamic",
        "dynamic")`` when there is no valid artifact.  Cached per model."""
        got = self._calib_cache.get(model)
        if got is None:
            got = ("dynamic", "dynamic")
            if self.cfg.calibration_dir:
                payload = quant_mod.load_calibration(self.cfg.calibration_dir, model)
                if payload is not None:
                    got = (quant_mod.quant_spec(payload["ranges"]), payload["digest"])
            self._calib_cache[model] = got
        return got

    @staticmethod
    def _quality_key(program: Program, quality: str) -> Program:
        """The dispatcher key of ``program`` at an effective tier: batches
        group within one tier only (an int8 batch never shares a program
        with a full one), and a full key stays the key without tiers."""
        return program if quality == "full" else program._replace(quality=quality)

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
        size = self._model_image_size(bundle)
        return bundle.preprocess(codec.resize224(img, (size, size)))

    async def _prepare(self, metrics: Metrics, parse: Callable[[], dict], size: int, headers, validate):
        """Parse the form, resolve the model, then ``validate(form, model)``
        (which checks the fields and decodes the image) on the codec pool;
        a body of ``codec_inline_bytes`` or less whose model is built runs
        inline, where the pool's handoff would cost more than the work."""
        with stage(metrics, "decode"):
            if size <= self.cfg.codec_inline_bytes:
                form = parse()
                model = self.resolve_model(form, headers)
                if self.weights.peek_bundle(model) is not None:
                    return validate(form, model)
                return await self.codec_pool.run(validate, form, model)

            def job():
                form = parse()
                return validate(form, self.resolve_model(form, headers))

            return await self.codec_pool.run(job)

    def _projection_input(self, form: dict, model: str) -> tuple[ModelBundle, str, np.ndarray]:
        bundle = self.weights.bundle(model)
        file_uri, layer = form.get("file"), form.get("layer")
        if not file_uri or not layer:
            raise errors.BadRequest("form fields 'file' and 'layer' are required")
        try:
            bundle.check_layer(layer)
        except ValueError as e:
            raise errors.UnknownLayer(str(e)) from None
        return bundle, layer, self.decode_preprocess(file_uri, bundle)

    async def _compat(self, parse: Callable[[], dict], size: int, headers=None, deadline=None,
                      req: Request | None = None) -> str:
        """``POST /``: the data URL of the stitched grid."""
        self._check_ready()

        def validate(form, model):
            if not form.get("file") or not form.get("layer"):
                raise errors.BadRequest("form fields 'file' and 'layer' are required")
            quality = self._resolve_quality(req, form, headers)
            bundle, layer, x = self._projection_input(form, model)
            return model, self._quality_key(self._grid_program(layer), self._effective_quality(quality, bundle)), x

        model, program, x = await self._prepare(self.metrics, parse, size, headers, validate)
        _annotate_model(model)
        layer = program.layer
        with stage(self.metrics, "compute"):
            result = (await self.dispatcher.submit(x, (model, program), deadline=deadline, **_tenancy(req)))[layer]
        n_valid = int(result["valid"].sum())
        if n_valid == 0:
            raise errors.NoActiveFilters(f"no filters fired for layer {layer!r}")
        if self.cfg.strict_compat and n_valid < self.cfg.stitch_k:
            raise errors.NoActiveFilters(f"only {n_valid} filters fired; need {self.cfg.stitch_k}")
        # encoded in the fetch thread; a failed encode there is retried here
        return result["data_url"] or await self.codec_pool.run(codec.encode_data_url, result["grid"])

    def _deconv_params(self, form: dict[str, str]) -> tuple[str, int, bool]:
        """A deconv request's (mode, top_k, sweep), the server's
        ``visualize_mode`` and ``top_k`` where the form names none: the one
        rule set of ``/v1/deconv`` and of ``POST /v1/jobs``."""
        mode = form.get("mode", self.cfg.visualize_mode)
        if mode not in ("all", "max"):
            raise errors.IllegalMode(f"mode must be 'all' or 'max', got {mode!r}")
        try:
            top_k = int(form.get("top_k", self.cfg.top_k))
        except ValueError:
            raise errors.BadRequest(f"top_k must be an integer, got {form['top_k']!r}") from None
        if not 1 <= top_k <= 64:
            raise errors.BadRequest("top_k must be in [1, 64]")
        return mode, top_k, form.get("sweep", "").lower() in _TRUTHY

    async def _deconv_v1(self, parse: Callable[[], dict], size: int, headers=None, deadline=None,
                         req: Request | None = None) -> dict:
        """``POST /v1/deconv``: ``{"layer", "mode", "filters", "images"}``
        for the fired filters (a prefix of the ranking), or ``{"layer",
        "mode", "sweep": true, "layers": {name: {"filters", "images"}}}``
        with ``sweep``, which runs on the sweep dispatcher."""

        def validate(form, model):
            quality = self._resolve_quality(req, form, headers)
            mode, top_k, sweep = self._deconv_params(form)
            self._check_ready()
            bundle, layer, x = self._projection_input(form, model)
            program = Program(layer, mode, top_k, "tiles", sweep)
            return model, self._quality_key(program, self._effective_quality(quality, bundle)), x

        model, program, x = await self._prepare(self.metrics, parse, size, headers, validate)
        _annotate_model(model)
        dispatcher, metrics = (self.sweep_dispatcher, self.sweep_metrics) if program.sweep else (
            self.dispatcher, self.metrics)
        with stage(metrics, "compute"):
            result = await dispatcher.submit(x, (model, program), deadline=deadline, **_tenancy(req))
        with stage(self.metrics, "encode"):
            names = list(result)
            encoded = await asyncio.gather(*(self._encode_tiles(result[name]) for name in names))
        if program.sweep:
            return {"layer": program.layer, "mode": program.mode, "sweep": True,
                    "layers": dict(zip(names, encoded))}
        return {"layer": program.layer, "mode": program.mode, **encoded[0]}

    async def _encode_tiles(self, entry: dict) -> dict:
        """``{"filters", "images"}`` of one projected layer's fired prefix,
        the tiles encoded across the codec pool."""
        n_valid = int(entry["valid"].sum())
        images = await self.codec_pool.map(codec.encode_data_url, [entry["tiles"][k] for k in range(n_valid)])
        return {"filters": [int(i) for i in entry["indices"][:n_valid]], "images": images}

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

    async def _dream_v1(self, parse: Callable[[], dict], size: int, headers=None, deadline=None,
                        req: Request | None = None) -> dict:
        """``POST /v1/dream``: ``{"layers", "loss", "image"}``, the dreamed
        image as a data URL and its final loss (``None`` when it is not
        finite)."""
        self._check_ready()

        def validate(form, model):
            # validated for the 422, then run as full: a dream has no
            # quantized or bf16-staged form (``_effective_quality``)
            self._resolve_quality(req, form, headers)
            bundle = self.weights.bundle(model)
            file_uri = form.get("file")
            if not file_uri:
                raise errors.BadRequest("form field 'file' is required")
            dream = self.dream_params(form, bundle)
            try:
                bundle.dream_forward(dream.layers)
            except KeyError as e:
                raise errors.UnknownLayer(str(e)) from None
            return model, bundle, dream, self.decode_preprocess(file_uri, bundle)

        model, bundle, dream, x = await self._prepare(self.dream_metrics, parse, size, headers, validate)
        _annotate_model(model)
        with stage(self.dream_metrics, "compute"):
            result = await self.dream_dispatcher.submit(x, (model, dream), deadline=deadline, **_tenancy(req))
        with stage(self.dream_metrics, "encode"):
            image = await self.codec_pool.run(lambda: codec.encode_data_url(bundle.unpreprocess(result["image"])))
        loss = result["loss"]
        return {
            "layers": list(dream.layers),
            "loss": loss if math.isfinite(loss) else None,  # NaN and inf are not JSON
            "image": image,
        }

    def compat(self, form: dict[str, str], headers=None) -> str:
        """``POST /`` from a parsed form, on the calling thread."""
        return self.on_loop(self._compat(lambda: form, len(form.get("file", "")), headers))

    def deconv_v1(self, form: dict[str, str], headers=None) -> dict:
        """``POST /v1/deconv`` from a parsed form, on the calling thread."""
        return self.on_loop(self._deconv_v1(lambda: form, len(form.get("file", "")), headers))

    def dream_v1(self, form: dict[str, str], headers=None) -> dict:
        """``POST /v1/dream`` from a parsed form, on the calling thread."""
        return self.on_loop(self._dream_v1(lambda: form, len(form.get("file", "")), headers))

    # --- durable async jobs (serving/jobs.py) ------------------------------

    def _job_deadline_pc(self, job) -> float | None:
        """A job's wall-clock completion deadline (it survives restarts) as
        the perf_counter deadline the dispatchers' reap boundaries use."""
        if job.deadline_ts is None:
            return None
        return time.perf_counter() + (job.deadline_ts - time.time())

    async def _job_dispatch(self, job, dispatcher: BatchingDispatcher, payload, key):
        """One device stage of a job on a shared dispatcher, cancellable:
        the submit rides its own task, which DELETE cancels.  A stage still
        queued is then dropped at the dispatcher's reap boundary and never
        reaches the card; one already dispatched runs to its end (a
        dream's octave: its pyramid and every step) and its answer is
        dropped.  The job's tenant (from its journal) queues and pays for
        it, also after a restart."""
        tr = job._trace
        token = trace_mod.activate(tr) if tr is not None else None
        try:
            tclass = self.qos.class_of(job.tenant) if self.qos is not None else ""
            fut = asyncio.ensure_future(dispatcher.submit(payload, key, deadline=self._job_deadline_pc(job),
                                                          tenant=job.tenant, tclass=tclass))
            job._inflight = fut
            try:
                return await fut
            finally:
                job._inflight = None
                if not fut.done():
                    # the await was interrupted (a runner's teardown): the
                    # submit must not keep the item queued
                    fut.cancel()
        finally:
            if token is not None:
                trace_mod.deactivate(token)

    async def _execute_job(self, job, ckpts, load):
        """The executor the ``JobManager`` drives: by job kind, with a
        trace per attempt filed in the flight recorder, so a job's stages
        show in ``/v1/debug/requests`` as a request's spans do."""
        tr = None
        if self.recorder is not None:
            tr = job._trace = RequestTrace(f"{job.id}-a{job.attempts}", f"job:{job.kind}")
        try:
            run = {"dream": self._job_dream, "sweep": self._job_sweep}.get(job.kind, self._job_deconv)
            async for step in run(job, ckpts, load):
                yield step
        except GeneratorExit:
            # the manager stopped after the Result (done), or at a
            # checkpoint where it parked or cancelled the job
            if tr is not None:
                done = job.state == "done"
                tr.finish(status=200 if done else 503, error=None if done else job.state)
                self.recorder.record(tr)
                tr = None
            raise
        except BaseException as e:
            if tr is not None:
                tr.finish(status=500, error=type(e).__name__)
                self.recorder.record(tr)
                tr = None
            raise
        else:
            # ending without a Result is the manager's no_result failure
            if tr is not None:
                tr.finish(status=500, error="no_result")
                self.recorder.record(tr)
                tr = None
        finally:
            job._trace = None

    def _job_model(self, job) -> tuple[str, ModelBundle]:
        """The (model, bundle) a journaled job targets: a resume after a
        restart runs on the same model, and a model no longer served is a
        deterministic failure."""
        name = job.params.get("model") or self.weights.default
        if name not in self.weights.served:
            raise errors.DeconvError(
                f"job {job.id} targets model {name!r}, no longer in the served set {sorted(self.weights.served)}")
        return name, self.weights.bundle(name)

    @staticmethod
    def _job_input(ckpts, load) -> np.ndarray:
        """The decoded input out of a job's checkpoints (spilled at submit,
        so a resume never decodes again).  A missing or corrupt input spill
        is a deterministic failure, not a crash to retry."""
        for rec in ckpts:
            if rec.get("stage") == "input":
                arrs = load(rec)
                if arrs is not None and "input" in arrs:
                    return arrs["input"]
        raise errors.DeconvError("job input checkpoint missing or corrupt in the spill dir")

    async def _job_dream(self, job, ckpts, load):
        """An octave-by-octave dream: one dispatch per rung on the dream
        dispatcher, each rung's float32 host array a checkpoint.  A resume
        starts after the last durable octave; x round-trips the host
        exactly, so a resumed dream's answer is byte-identical to an
        uninterrupted one."""
        p = job.params
        model, bundle = self._job_model(job)
        layers = tuple(s for s in p.get("layers", "").split(",") if s) or bundle.dream_layers
        steps = int(p.get("steps", DREAM_DEFAULTS["steps"]))
        octaves = int(p.get("octaves", DREAM_DEFAULTS["octaves"]))
        lr = float(p.get("lr", DREAM_DEFAULTS["lr"]))
        base = self._job_input(ckpts, load)
        shapes = octave_shapes(*base.shape[:2], octaves, 1.4, bundle.min_dream_size)
        start, x, loss = 0, base, None
        last = next((rec for rec in reversed(ckpts) if rec.get("stage") == "octave"), None)
        if last is not None and int(last.get("index", -1)) < len(shapes):
            arrs = load(last)
            if arrs is not None and "x" in arrs:
                start, x, loss = int(last["index"]) + 1, arrs["x"], (last.get("meta") or {}).get("loss")
        for i in range(start, len(shapes)):
            faults_mod.raise_if_armed("jobs.runner_crash")
            try:
                res = await self._job_dispatch(job, self.dream_dispatcher, (x, base),
                                               (model, DreamOctave(layers, steps, lr, shapes, i)))
            except KeyError as e:  # an unknown dream activation: deterministic
                raise errors.UnknownLayer(str(e)) from e
            x, loss = np.asarray(res["image"]), res["loss"]
            yield Checkpoint(stage="octave", index=i, total=len(shapes), arrays={"x": x},
                             meta={"loss": loss, "hw": list(shapes[i])})
        image = await self.codec_pool.run(lambda: codec.encode_data_url(bundle.unpreprocess(np.asarray(x))))
        body = {"layers": list(layers), "loss": loss if loss is not None and math.isfinite(loss) else None,
                "image": image}
        yield Result(200, "application/json", json.dumps(body).encode())

    async def _job_sweep(self, job, ckpts, load):
        """A layer-by-layer sweep: one single-layer tiles dispatch per swept
        layer on the sweep dispatcher (the program ``POST /v1/deconv`` runs
        at that layer), each layer's encoded entry a checkpoint; a resume
        projects only the layers with no durable checkpoint."""
        p = job.params
        model, bundle = self._job_model(job)
        layer, mode = p["layer"], p.get("mode", self.cfg.visualize_mode)
        top_k, quality = int(p.get("top_k", self.cfg.top_k)), p.get("quality", "full")
        x = self._job_input(ckpts, load)
        done: dict[str, dict] = {}
        for rec in ckpts:
            if rec.get("stage") == "layer":
                payload = load(rec)
                if payload is not None and "name" in payload:
                    done[payload["name"]] = payload["entry"]
        names = bundle.sweep_layers(layer)
        for i, name in enumerate(names):
            if name in done:
                continue
            faults_mod.raise_if_armed("jobs.runner_crash")
            program = self._quality_key(Program(name, mode, top_k, "tiles"), quality)
            result = await self._job_dispatch(job, self.sweep_dispatcher, x, (model, program))
            done[name] = entry = await self._encode_tiles(result[name])
            yield Checkpoint(stage="layer", index=i, total=len(names), data={"name": name, "entry": entry},
                             meta={"layer": name})
        # in ladder order whichever layers a resume ran: byte-identical
        body = {"layer": layer, "mode": mode, "sweep": True, "layers": {name: done[name] for name in names}}
        yield Result(200, "application/json", json.dumps(body).encode())

    async def _job_deconv(self, job, ckpts, load):
        """A single-layer deconv as a job: one dispatch of ``POST
        /v1/deconv``'s program on the deconv dispatcher (the input spill
        already made the submit durable)."""
        p = job.params
        model, _ = self._job_model(job)
        layer, mode = p["layer"], p.get("mode", self.cfg.visualize_mode)
        top_k = int(p.get("top_k", self.cfg.top_k))
        x = self._job_input(ckpts, load)
        faults_mod.raise_if_armed("jobs.runner_crash")
        program = self._quality_key(Program(layer, mode, top_k, "tiles"), p.get("quality", "full"))
        result = await self._job_dispatch(job, self.dispatcher, x, (model, program))
        body = {"layer": layer, "mode": mode, **await self._encode_tiles(result[layer])}
        yield Result(200, "application/json", json.dumps(body).encode())

    async def _jobs_submit(self, req: Request) -> Response:
        """``POST /v1/jobs``: 202 and the job's document.  ``type`` is
        dream (default), deconv or sweep, with the fields of the matching
        synchronous route, validated now (a bad request is answered at
        submit); the image is decoded once and spilled as the job's input
        checkpoint, and the runner does the device work.  Retry-safe: an
        ``x-idempotency-key`` (default: the canonical digest of the body
        under the model's prefix and the effective tier) dedups onto the
        live or completed job; with QoS, per tenant."""
        try:
            self._check_ready()
            form = _parse_form(req)
            kind = form.get("type", "dream")
            if kind not in ("deconv", "dream", "sweep"):
                raise errors.BadRequest(f"type must be deconv, dream or sweep, got {kind!r}")
            model = req.model = self.resolve_model(form, req.headers)
            bundle = self.weights.peek_bundle(model) or await asyncio.to_thread(self.weights.bundle, model)
            # the jobs route has no admission wrap: the class default tier
            # needs the tenant's class here
            if self.qos is not None and not req.tclass:
                req.tclass = self.qos.class_of(self.qos.tenant_of(req.headers))
            quality = self._resolve_quality(req, form, req.headers)
            # the effective tier is journaled, so a resume runs it whatever
            # the restarted server's config; dreams run full
            eq = "full" if kind == "dream" else self._effective_quality(quality, bundle)
            file_uri = form.get("file")
            if not file_uri:
                raise errors.BadRequest("form field 'file' is required")
            if kind == "dream":
                dream = self.dream_params(form, bundle)
                params = {"layers": ",".join(dream.layers), "steps": str(dream.steps),
                          "octaves": str(dream.octaves), "lr": repr(dream.lr), "model": model}
            else:
                layer = form.get("layer")
                if not layer:
                    raise errors.BadRequest("form field 'layer' is required")
                try:
                    bundle.check_layer(layer)
                except ValueError as e:
                    raise errors.UnknownLayer(str(e)) from None
                mode, top_k, _ = self._deconv_params(form)
                params = {"layer": layer, "mode": mode, "top_k": str(top_k), "model": model}
                if eq != "full":
                    params["quality"] = eq
            idem = req.headers.get("x-idempotency-key", "")
            if idem and not trace_mod.RID_RE.match(idem):
                raise errors.BadRequest("x-idempotency-key must match [A-Za-z0-9._-]{1,64}")
            if not idem:
                # the model's own prefix and the effective tier: identical
                # bodies for two models, or two tiers, never share a job
                idem = canonical_digest(f"{self._model_prefix(model)}|jobs{self._quality_prefix(eq, model)}",
                                        req.headers.get("content-type", ""), req.body, req=req,
                                        exclude=("model", "quality"))
            tenant = ""
            if self.qos is not None:
                # the index is per tenant: two tenants' identical bodies
                # never dedup onto one job (or one budget)
                tenant = req.tenant = self.qos.tenant_of(req.headers)
                idem = f"{tenant}|{idem}"
            # dedup and capacity before the decode: a retried submit and a
            # 429 cost no codec-pool slot
            job = self.jobs.lookup(idem)
            deduped = job is not None
            if job is None:
                self.jobs.ensure_capacity()
                budget = 0
                if self.qos is not None:
                    budget = self.qos.job_budget(tenant)
                    try:
                        self.jobs.ensure_tenant_capacity(tenant, budget)
                    except errors.TenantOverQuota:
                        self.qos.record_shed(tenant)
                        raise
                with stage(self.metrics, "decode"):
                    x = await self.codec_pool.run(self.decode_preprocess, file_uri, bundle)
                deadline_ts = None
                if req.deadline is not None:
                    # x-deadline-ms on a submit is the job's completion
                    # deadline, on the wall clock so it survives a restart
                    deadline_ts = time.time() + max(0.0, req.deadline - time.perf_counter())
                # the submit's one large fsync'd write, off the loop
                spilled = await asyncio.to_thread(self.jobs.spill_input, {"input": np.asarray(x, np.float32)})
                try:
                    # submit re-checks the tenant budget with no await
                    # between the check and the job's registration
                    job, deduped = self.jobs.submit(kind, params, idem, input_spilled=spilled,
                                                    deadline_ts=deadline_ts, tenant=tenant, tenant_budget=budget)
                except errors.TenantOverQuota:
                    if self.qos is not None:
                        self.qos.record_shed(tenant)
                    raise
        except errors.DeconvError as e:
            return _error_response(e, req.id)
        except ValueError as e:
            return _error_response(errors.BadRequest(str(e)), req.id)
        doc = self.jobs.describe(job)
        doc["deduped"] = deduped
        resp = Response.json(doc, status=202)
        resp.headers["location"] = f"/v1/jobs/{job.id}"
        return resp

    async def _jobs_collection(self, _req: Request) -> Response:
        """``GET /v1/jobs``: every known job (newest last) and the counts."""
        return Response.json({"jobs": self.jobs.jobs_snapshot(), "counts": self.jobs.counts(),
                              "queue_depth": self.jobs.queue_depth})

    async def _jobs_entity(self, req: Request) -> Response:
        """``GET /v1/jobs/{id}[/result|/events]``: the job's document, its
        answer (the synchronous route's bytes), or its SSE progress stream
        (``Last-Event-ID`` or ``?last_event_id=`` replays what was missed)."""
        parts = [p for p in req.path[len("/v1/jobs/"):].split("/") if p]
        if not parts:
            return await self._jobs_collection(req)
        try:
            job = self.jobs.get(parts[0])
        except errors.DeconvError as e:
            return _error_response(e, req.id)
        if len(parts) == 1:
            return Response.json(self.jobs.describe(job))
        if parts[1] == "result":
            if job.state != "done" or job.result is None:
                return _error_response(errors.BadRequest(f"job {job.id} is {job.state!r}; no result yet"), req.id)
            body = self.jobs.result_body(job)
            if body is None:
                return _error_response(errors.DeconvError("job result spill unreadable"), req.id)
            return Response(status=job.result["status"], body=body,
                            headers={"content-type": job.result["content_type"], "x-job-id": job.id})
        if parts[1] == "events":
            last = -1
            raw = req.headers.get("last-event-id") or req.query.get("last_event_id")
            if raw:
                try:
                    last = int(raw)
                except ValueError:
                    return _error_response(errors.BadRequest("Last-Event-ID must be an int"), req.id)
            return Response(status=200, headers={"content-type": "text/event-stream"},
                            stream=self.jobs.event_stream(job, last))
        return _error_response(errors.BadRequest(f"unknown job subresource {parts[1]!r}"), req.id)

    async def _jobs_delete(self, req: Request) -> Response:
        """``DELETE /v1/jobs/{id}``: cancel.  A terminal job answers its
        state; a running job's in-flight octave is reaped before dispatch."""
        try:
            job = self.jobs.cancel(req.path[len("/v1/jobs/"):].strip("/"))
        except errors.DeconvError as e:
            return _error_response(e, req.id)
        return Response.json(self.jobs.describe(job))

    # --- HTTP routes -------------------------------------------------------

    def _add_routes(self) -> None:
        r = self.server.route
        r("GET", "/health-check")(self._health)
        r("GET", "/ready")(self._ready)
        r("GET", "/healthz")(self._healthz)
        r("GET", "/readyz")(self._readyz)
        r("GET", "/metrics")(self._metrics)
        r("GET", "/v1/metrics")(self._metrics)
        r("GET", "/v1/config")(self._config)
        r("GET", "/v1/models")(self._models)
        r("GET", "/v1/debug/requests")(self._debug_requests)
        r("POST", "/v1/profile")(self._profile)
        if self.faults is not None:
            # routed only with fault injection on: a default server 404s it
            r("POST", "/v1/debug/faults")(self._debug_faults)
        if self.jobs is not None:
            # routed only with a jobs_dir: a default server 404s them
            r("POST", "/v1/jobs")(self._jobs_submit)
            r("GET", "/v1/jobs")(self._jobs_collection)
            self.server.route_prefix("GET", "/v1/jobs/")(self._jobs_entity)
            self.server.route_prefix("DELETE", "/v1/jobs/")(self._jobs_delete)
        if self.cache is not None and self.cfg.fleet_peer_fill:
            # the peer cache-fill read surface this backend serves to its
            # ring peers: only with fleet_peer_fill on (a trusted mesh); a
            # default server exposes no internal route
            self.server.route_prefix("GET", "/v1/internal/cache/")(self._internal_cache)
        if self.tsdb is not None:
            r("GET", "/v1/metrics/history")(self._metrics_history)
            r("GET", "/v1/alerts")(self._alerts)
            if self.incidents is not None:
                r("GET", "/v1/debug/incidents")(self._debug_incidents)
        # the JAX package's wrap order: observation (outermost: its
        # histogram and SLOs see every outcome) -> trace -> QoS admission
        # (identity and budget before any decode; a cache hit refunds the
        # provisional debit) -> cache -> route
        for path, core, metrics in (("/", self._compat, self.metrics),
                                    ("/v1/deconv", self._deconv_v1, self.metrics),
                                    ("/v1/dream", self._dream_v1, self.dream_metrics)):
            handler = self._cache_wrap(path, self._compute_route(core, metrics), metrics)
            r("POST", path)(self._obs_wrap(path, self._trace_wrap(path, self._qos_wrap(handler, metrics))))

    def _compute_route(self, core, metrics: Metrics):
        """A compute route: ``core(parse, size, headers, deadline, req)``'s
        result as JSON, a taxonomy error as its status and payload (with
        ``Retry-After`` where it carries one), each observed on
        ``metrics``."""

        async def handler(req: Request) -> Response:
            t0 = time.perf_counter()
            try:
                result = await core(functools.partial(_parse_form, req), len(req.body), req.headers, req.deadline,
                                    req)
            except errors.DeconvError as e:
                metrics.observe_request(time.perf_counter() - t0, e.code)
                return _error_response(e, req.id)
            except ValueError as e:
                metrics.observe_request(time.perf_counter() - t0, "bad_request")
                return _error_response(errors.BadRequest(str(e)), req.id)
            metrics.observe_request(time.perf_counter() - t0)
            return Response.json(result)

        return handler

    def _qos_wrap(self, handler, metrics: Metrics):
        """Tenant admission in front of a compute route
        (``serving/qos.py``): resolve the identity from ``x-api-key`` /
        ``x-tenant``, enforce the in-flight cap and the device-time token
        bucket (429 ``tenant_over_quota`` with a ``Retry-After`` from the
        bucket's refill), stamp the tenant and class on the request (the
        access log, the queue, ``quality_by_class``), the trace and the
        grant (the cache's refund), and release the in-flight slot on every
        exit.  An admission crash fails open to the default tenant inside
        ``QosPolicy.admit``.  The handler itself while QoS is off."""
        if self.qos is None:
            return handler
        qos = self.qos

        async def admitted(req: Request) -> Response:
            t0 = time.perf_counter()
            tr = trace_mod.current_trace()
            try:
                grant = qos.admit(req.headers)
            except errors.TenantOverQuota as e:
                req.tenant = e.tenant or ""
                metrics.observe_request(time.perf_counter() - t0, e.code)
                if tr is not None:
                    tr.annotate(tenant=e.tenant, quota=True)
                return _error_response(e, req.id)
            req.tenant, req.tclass, req._qos_grant = grant.tenant, grant.tclass, grant
            if tr is not None:
                tr.annotate(tenant=grant.tenant, tclass=grant.tclass)
            try:
                return await handler(req)
            finally:
                qos.release(grant)

        return admitted

    def _charge_hit(self, req: Request) -> None:
        """Refund the request's provisional QoS debit down to the fixed hit
        cost: no device work ran for it (a cache hit, a coalesced waiter, an
        L2 read)."""
        if self.qos is not None and req._qos_grant is not None:
            self.qos.charge_hit(req._qos_grant)

    def _trace_wrap(self, route: str, handler):
        """Give every request on a compute route a span-structured trace,
        active on the request's task (the dispatcher's submit and the codec
        pool's handoff pick it up), then file the finished trace in the
        flight recorder.  Inert when tracing is off (``trace_ring=0``)."""
        if self.recorder is None:
            return handler
        recorder = self.recorder

        async def traced(req: Request) -> Response:
            tr = RequestTrace(req.id, route)
            if req.hop is not None:
                tr.annotate(hop=req.hop[0], hop_purpose=req.hop[1])
            token = trace_mod.activate(tr)
            try:
                resp = await handler(req)
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                tr.finish(status=500, error=type(e).__name__)
                recorder.record(tr)
                raise
            finally:
                trace_mod.deactivate(token)
            code = errors.code_from_body(resp.body) if resp.status >= 400 else None
            tr.finish(status=resp.status, error=code, cache=resp.headers.get("x-cache"))
            recorder.record(tr)
            return resp

        return traced

    def _obs_wrap(self, route: str, handler):
        """Per-route latency observation: every completed request (hit,
        miss, 4xx, shed, a crash's 500) lands one sample in the
        ``request_duration_seconds{route,qos_class}`` histogram, its
        request id as the bucket's exemplar, and in every SLO that matches
        the route.  A cancelled request (client gone, shutdown) produced no
        response and observes nothing.  ``qos_class`` is the class the QoS
        admission wrap stamped on the request, ``default`` with QoS off."""
        slos = [t for t in self.slos if t.matches(route)]

        def observe(req: Request, dt: float, status: int) -> None:
            self.metrics.observe_hist("request_duration_seconds", ("route", "qos_class"),
                                      (route, req.tclass or "default"), dt, exemplar=req.id)
            for t in slos:
                t.observe(dt, status)

        async def observed(req: Request) -> Response:
            t0 = time.perf_counter()
            try:
                resp = await handler(req)
            except asyncio.CancelledError:
                raise
            except BaseException:
                observe(req, time.perf_counter() - t0, 500)
                raise
            observe(req, time.perf_counter() - t0, resp.status)
            return resp

        return observed

    def _model_prefix(self, model: str) -> str:
        """The response-cache key prefix of one served model: every
        setting that decides its response bytes, in the JAX package's
        order (model, image size, visualize mode, stitch k, top k,
        bug_compat, strict_compat, dtype, backward dtype, lowc_kpack,
        fused_unpool, weight dtype, ``weights_path``, so a restart on other
        weights misses in the L2, and the JAX package's bf16 low-channel
        forward knob, which the port does not have: "0"), then the device
        type: the card's bytes and the CPU's
        differ in their last bits, and one ``l2_dir`` may outlive a device.
        Builds the model's bundle at its first use (called off the event
        loop)."""
        p = self._prefix_cache.get(model)
        if p is None:
            bundle, c = self.weights.bundle(model), self.cfg
            p = "|".join(str(x) for x in (
                model, self._model_image_size(bundle), c.visualize_mode, c.stitch_k, c.top_k, c.bug_compat,
                c.strict_compat, c.dtype, c.backward_dtype, c.lowc_kpack, c.fused_unpool, c.weight_dtype,
                c.weights_path, "0", bundle.device.type,
            ))
            self._prefix_cache[model] = p
        return p

    def _request_key(self, req: Request, route: str) -> str:
        """The request's cache and singleflight key: ``canonical_digest``
        of the memoized form (the same parse the route consumes on a miss)
        under the resolved model's prefix and its effective tier's
        (``_quality_prefix``: nothing for full), without the ``model`` and
        ``quality`` fields.  Raises ``UnknownModel`` and
        ``IllegalQuality``."""
        model = self.resolve_request_model(req)
        quality = self._resolve_quality(req)
        prefix = f"{self._model_prefix(model)}|{route}"
        prefix += self._quality_prefix(self._effective_quality(quality, self.weights.peek_bundle(model), route),
                                       model)
        return canonical_digest(prefix, req.headers.get("content-type", ""), req.body, req=req,
                                exclude=("model", "quality"))

    async def _internal_cache(self, req: Request) -> Response:
        """``GET /v1/internal/cache/{digest}``: the peer cache-fill read
        surface.  Serves a positive cached payload verbatim (body and
        content type, ``x-cache: peer``) to a peer that just inherited this
        digest's slice of the ring, else 404 ``cache_miss`` (``no-store``:
        it speaks of this instant).  Reads through ``ResponseCache.peek``:
        a peer's read counts as no hit or miss here and promotes nothing.
        Negative entries are not served."""
        digest = req.path[len("/v1/internal/cache/"):]
        if not re.fullmatch(r"[0-9a-f]{16,64}", digest):
            return _error_response(errors.BadRequest("malformed cache digest"), req.id)
        entry = self.cache.peek(digest) if self.cache is not None else None
        if entry is None or entry.negative or entry.status != 200:
            resp = Response.json({"error": "cache_miss", "request_id": req.id}, 404)
            resp.headers["cache-control"] = "no-store"
            return resp
        self.metrics.inc_counter("cache_peer_reads_total")
        return Response(status=200, body=entry.body, headers={"content-type": entry.content_type, "x-cache": "peer"})

    async def _peer_fill(self, req: Request, key: str, tr) -> Response | None:
        """Honour the router's ``x-peer-fill: host:port`` hint on a miss:
        fetch the finished payload for ``key`` from the key's previous ring
        owner before computing (``x-cache: peer-fill``, a ``peer_fill``
        span, ``cache_peer_fills_total``).  None on every failure (no hint,
        a malformed one, an unreachable or slow peer, a peer miss, counted
        in ``cache_peer_fill_misses_total``): the request then computes, so
        a fill only ever saves work."""
        peer = req.headers.get("x-peer-fill", "")
        if not peer or not self.cfg.fleet_peer_fill or self.cache is None:
            return None
        m = re.fullmatch(r"([A-Za-z0-9_.\-]+):(\d{1,5})", peer)
        if m is None:
            return None
        t0 = time.perf_counter()
        try:
            status, headers, body = await fleet_mod.raw_request(
                m.group(1), int(m.group(2)), "GET", f"/v1/internal/cache/{key}", {}, b"",
                self.cfg.peer_fill_timeout_s,
            )
        except Exception:  # noqa: BLE001 — any peer failure: compute instead
            status, headers, body = 0, {}, b""
        dt = time.perf_counter() - t0
        if tr is not None:
            tr.add_span("peer_fill", t0, dt, peer=peer, hit=status == 200)
        if status != 200:
            self.metrics.inc_counter("cache_peer_fill_misses_total")
            return None
        self.metrics.inc_counter("cache_peer_fills_total")
        return Response(status=200, body=body,
                        headers={"content-type": headers.get("content-type", "application/json"),
                                 "x-cache": "peer-fill"})

    async def _l2_lookup(self, key: str, tr) -> Response | None:
        """The durable L2 read on a memory miss, before compute: a
        verified disk hit answers without the codec pool, a dispatcher or
        the card; a corrupt entry reads as a miss."""
        if self.l2 is None:
            return None
        t0 = time.perf_counter()
        got = await asyncio.to_thread(self.l2.get, key)
        if tr is not None:
            tr.add_span("l2_lookup", t0, time.perf_counter() - t0, hit=got is not None)
        if got is None:
            return None
        status, body, content_type = got
        return Response(status=status, body=body, headers={"content-type": content_type, "x-cache": "l2"})

    def _cache_wrap(self, route: str, handler, metrics: Metrics):
        """The response cache and the singleflight table in front of a
        compute route (``deconv_api_tpu/serving/app.py:_cache_wrap``).

        The key (``_request_key``) comes from the raw body before any
        image decode: on the event loop for a body of
        ``codec_inline_bytes`` or less whose model prefix is known, else
        on the codec pool, where the form parse of a large body belongs.
        A hit answers with the stored payload (``x-cache: hit``, or
        ``hit-negative`` for a cached deterministic 4xx) and reaches no
        dispatcher.  On a miss the first request in flight leads: it
        fills from the peer the router's ``x-peer-fill`` hint names
        (``_peer_fill``), else reads the L2, else runs the route, and
        publishes its response to
        the identical requests that arrived meanwhile (``x-cache:
        coalesced``, each with its own ``x-request-id``).  A leader's own
        deadline answers its waiters 503 ``unavailable``, not a 504 that
        is not theirs; a cancelled leader fails them the same way; a
        waiter's deadline ends only its own wait.  ``Cache-Control:
        no-cache`` skips the cache read, the flight table, the peer fill
        and the L2 (a forced recompute, ``x-cache: bypass``) but refreshes the entry,
        unless ``no-store`` is also present, which skips the write too.
        With QoS on, a hit, a coalesced waiter, a peer fill and an L2 read
        refund their
        provisional device debit down to the fixed hit cost.

        Cache counters go to the main registry; per-request accounting to
        the route's own ``metrics``."""
        if self.cache is None and self.flights is None and self.l2 is None:
            return handler

        async def cached(req: Request) -> Response:
            t0 = time.perf_counter()
            tr = trace_mod.current_trace()
            cc = req.headers.get("cache-control", "").lower()
            bypass = "no-cache" in cc or "no-store" in cc
            try:
                if len(req.body) > self.cfg.codec_inline_bytes:
                    key = await self.codec_pool.run(self._request_key, req, route)
                elif self.resolve_request_model(req) in self._prefix_cache:
                    key = self._request_key(req, route)
                else:  # a model's first request builds its bundle, off the loop
                    key = await asyncio.to_thread(self._request_key, req, route)
            except errors.DeconvError as e:
                metrics.observe_request(time.perf_counter() - t0, e.code)
                return _error_response(e, req.id)
            _annotate_model(req.model)
            if self.cache is not None and not bypass:
                charge = None
                if self.qos is not None and req._qos_grant is not None:
                    charge = functools.partial(self._charge_hit, req)
                entry = self.cache.lookup(key, charge=charge)
                dt = time.perf_counter() - t0
                if entry is not None:
                    self.metrics.observe_stage("cache_hit", dt)
                    metrics.observe_request(dt, entry.error_code)
                    if tr is not None:
                        tr.add_span("cache_hit", t0, dt)
                    return entry.to_response()
                if tr is not None:
                    tr.add_span("cache_lookup", t0, dt, hit=False)
            if self.flights is not None and not bypass:
                leader, fut = self.flights.begin(key)
                if not leader:
                    return await self._coalesced(req, fut, t0, tr, metrics)
                # the awaits below run inside the flight: every exit must
                # finish it, or the key's future stays in the table and
                # every later identical request waits on it forever
                try:
                    filled = await self._peer_fill(req, key, tr)
                    if filled is None:
                        filled = await self._l2_lookup(key, tr)
                    resp = filled if filled is not None else await handler(req)
                except asyncio.CancelledError:
                    self.flights.finish(key, exc=errors.Unavailable("coalesced request's leader was cancelled"))
                    raise
                except errors.DeadlineExpired:
                    self.flights.finish(key, exc=errors.Unavailable(
                        "coalesced request's leader hit its own deadline"))
                    raise
                except BaseException as e:  # noqa: BLE001 — publish, re-raise
                    self.flights.finish(key, exc=e)
                    raise
                if filled is not None:
                    self._charge_hit(req)
                    metrics.observe_request(time.perf_counter() - t0)
                    self.flights.finish(key, resp)
                elif resp.status >= 400 and errors.code_from_body(resp.body) == "deadline_expired":
                    # the route answers the leader's own lapsed deadline as
                    # a 504 response: the work's waiters get a 503
                    self.flights.finish(key, exc=errors.Unavailable(
                        "coalesced request's leader hit its own deadline"))
                else:
                    self.flights.finish(key, resp)
            else:
                # a bypass is a forced recompute: no peer's cache, no L2
                resp = None if bypass else await self._peer_fill(req, key, tr)
                if resp is None and not bypass:
                    resp = await self._l2_lookup(key, tr)
                if resp is not None:
                    self._charge_hit(req)
                    metrics.observe_request(time.perf_counter() - t0)
                else:
                    resp = await handler(req)
            content_type = resp.headers.get("content-type", "application/json")
            if self.cache is not None and "no-store" not in cc:
                self.cache.store(key, resp.status, resp.body, content_type)
            if (self.l2 is not None and "no-store" not in cc and resp.status == 200
                    and resp.headers.get("x-cache") != "l2"):
                # positive write-through, asynchronous: the serving path
                # never waits on the disk; negative entries stay in memory
                self.l2.put_async(key, resp.status, resp.body, content_type)
            resp.headers.setdefault("x-cache", "bypass" if bypass else "miss")
            return resp

        return cached

    async def _coalesced(self, req: Request, fut, t0: float, tr, metrics: Metrics) -> Response:
        """A singleflight waiter: await the leader's published response
        under the waiter's own deadline (capped by the request timeout),
        answered with its own ``x-request-id`` and ``x-cache: coalesced``."""
        self.metrics.inc_counter("cache_coalesced_total")
        if tr is not None:
            tr.annotate(coalesced_into=getattr(fut, "leader_trace_id", None), flight=getattr(fut, "flight_id", None))
        t_wait = time.perf_counter()
        deadline = None if req.deadline is None else min(req.deadline, t0 + self.cfg.request_timeout_s)
        try:
            resp = await Singleflight.wait(fut, deadline)
        except errors.DeconvError as e:
            if isinstance(e, errors.DeadlineExpired):
                self.metrics.inc_counter("deadline_expired_total")
            metrics.observe_request(time.perf_counter() - t0, e.code)
            err = _error_response(e, req.id)
            err.headers["x-cache"] = "coalesced"
            return err
        finally:
            if tr is not None:
                tr.add_span("coalesce_wait", t_wait, time.perf_counter() - t_wait,
                            leader=getattr(fut, "leader_trace_id", None))
            # a waiter runs no device work (the leader's item is charged)
            self._charge_hit(req)
        metrics.observe_request(time.perf_counter() - t0, errors.code_from_body(resp.body) if resp.status >= 400 else None)
        # the leader's headers may already carry the leader's id
        return Response(status=resp.status, body=resp.body,
                        headers={**resp.headers, "x-cache": "coalesced", "x-request-id": req.id})

    async def _health(self, _req: Request) -> Response:
        return Response.json({"healthy": "true"})

    async def _ready(self, _req: Request) -> Response:
        return Response.json({"ready": self.ready}, 200 if self.ready else 503)

    async def _healthz(self, _req: Request) -> Response:
        # liveness: answering at all is the proof; it stays 200 through
        # warmup, drain and an open breaker, which a restart would not fix
        return Response.json({"status": "ok"})

    async def _readyz(self, _req: Request) -> Response:
        body, status = await asyncio.to_thread(self.readyz)
        return Response.json(body, status)

    async def _metrics(self, _req: Request) -> Response:
        return Response.text(self.metrics_text(), content_type="text/plain; version=0.0.4")

    async def _config(self, _req: Request) -> Response:
        return Response.json(await asyncio.to_thread(self.config))

    async def _models(self, _req: Request) -> Response:
        return Response.json(self.models())

    async def _debug_requests(self, req: Request) -> Response:
        """``GET /v1/debug/requests``: the flight recorder's traces, newest
        first: ``?slow=1`` / ``?error=1`` select the tail-sampled rings,
        ``?id=`` searches every ring for one request, ``?model=`` filters on
        the resolved model, ``?limit=N`` (default 50)."""
        if self.recorder is None:
            return _error_response(errors.BadRequest("tracing disabled: set trace_ring > 0"), req.id)
        try:
            args = trace_mod.debug_query_args(req.query, self.cfg.trace_ring)
        except ValueError:
            return _error_response(errors.BadRequest("limit must be an int"), req.id)
        traces = self.recorder.query(**args, model=req.query.get("model") or None)
        return Response.json({"requests": traces, "counts": self.recorder.counts(),
                              "slow_ms": self.cfg.trace_slow_ms, "sample": self.cfg.trace_sample})

    # --- control routes ----------------------------------------------------

    def readiness_checks(self) -> dict[str, bool]:
        """Each gate a load balancer should respect, named so a 503's body
        says which one failed."""
        return {
            "warmed": self.ready,  # pinned models paged in, programs captured
            "not_draining": not self.draining,  # stop routing before the listener dies
            # collect/dispatch tasks running on every dispatcher
            "batcher_tasks": all(d.tasks_alive() for d in (self.dispatcher, self.dream_dispatcher,
                                                           self.sweep_dispatcher)),
            # codec pool above half capacity
            "codec_pool_quorum": self.codec_pool.at_quorum,
            # the breaker would admit a request (or its recovery probe)
            "breaker_not_open": self.lane_pool.accepting(),
        }

    def readyz(self) -> tuple[dict, int]:
        """``GET /readyz``: ``({"ready", "checks"[, "models"]}, status)``."""
        checks = self.readiness_checks()
        ok = all(checks.values())
        body = {"ready": ok, "checks": checks}
        if len(self.weights.served) > 1:
            body["models"] = self.weights.ready_block()
        # the tiers, and which models carry a calibration artifact (the
        # snapshot first: dispatch threads insert into the cache)
        calib = dict(self._calib_cache)
        body["quality"] = {"default": self.cfg.quality_default, "by_class": dict(self._class_quality),
                           "calibrated": sorted(m for m, (_q, tag) in calib.items() if tag != "dynamic")}
        if self.aot is not None:
            # the store on the probe: an autoscaler's warm-boot gate reads
            # whether this boot hit it without /v1/config
            body["aot"] = {"entries": self.aot.store.entry_count,
                           "hits": self.metrics.counter("aot_cache_hits_total"),
                           "misses": self.metrics.counter("aot_cache_misses_total")}
        if self.jobs is not None:
            # the park and queue picture an operator's drain reads
            c = self.jobs.counts()
            body["jobs"] = {"running": c["running"], "parked": c["parked"], "queued": c["queued"]}
        if self.qos is not None:
            body["qos"] = self.qos.counts()
        # informational blocks: a burning SLO, a firing alert or a
        # degraded best-effort disk tier must not pull the server from
        # rotation (that turns a latency incident into an outage)
        if self.slos:
            body["slo"] = {t.name: {**t.snapshot(), "ok": t.burn_rates()["5m"] <= 1.0} for t in self.slos}
        if self.alert_engine is not None:
            snap = self.alert_engine.snapshot()
            body["alerts"] = {"firing": self.alert_engine.firing(), "pending": snap["pending"],
                              "eval_errors": snap["eval_errors_total"]}
        surfaces = {}
        if self.jobs is not None:
            surfaces["jobs.journal"] = self.jobs.journal.surface.snapshot()
            surfaces["jobs.spill"] = self.jobs.spill.surface.snapshot()
        if self.l2 is not None:
            surfaces["cache.l2"] = self.l2.surface.snapshot()
        if self.aot is not None:
            surfaces["aot.store"] = self.aot.store.surface.snapshot()
        if self.incidents is not None:
            surfaces["alerts.incidents"] = self.incidents.surface.snapshot()
        if surfaces:
            body["durability"] = {"ok": not any(v["degraded"] for v in surfaces.values()), "surfaces": surfaces}
        return body, 200 if ok else 503

    def metrics_text(self) -> str:
        """``GET /metrics``: the deconv, dream and sweep streams'
        expositions, the request traces' span totals, the SLOs' totals and
        burn rates and the alert rules' states."""
        text = self.metrics.prometheus() + self.dream_metrics.prometheus() + self.sweep_metrics.prometheus()
        if self.recorder is not None:
            text += self.recorder.prometheus("deconv")
        text += slo_prometheus(self.slos, "deconv")
        if self.alert_engine is not None:
            text += self.alert_engine.prometheus("deconv")
        return text

    # --- metric history and alerting ---------------------------------------

    def _tsdb_samples(self) -> dict:
        """One scrape tick's samples: the main registry flattened, plus
        the SLO burn rates as gauges (so threshold rules range over them)."""
        samples = tsdb_mod.flatten_snapshot(self.metrics.snapshot())
        for t in self.slos:
            for window, rate in t.burn_rates().items():
                samples[("slo_burn_rate", f"slo={t.name},window={window}")] = (tsdb_mod.KIND_GAUGE, rate)
        return samples

    def _incident_bundle(self, ctx: dict) -> dict:
        """What an incident freezes at fire time: the rule and its query
        window, the flight recorder's slow and error rings, the config."""
        rule = ctx.get("rule") or {}
        bundle = dict(ctx)
        if rule.get("kind") == "threshold":
            bundle["window"] = self.tsdb.query(rule.get("family", ""), rule.get("label") or None,
                                               range_s=rule.get("range_s", 60.0))
        else:
            bundle["window"] = self.tsdb.query("requests_total", None, range_s=120.0)
        if self.recorder is not None:
            bundle["slow"] = self.recorder.query(slow=True, limit=16)
            bundle["errors"] = self.recorder.query(error=True, limit=16)
        cfg = dataclasses.asdict(self.cfg)
        # the JAX package's masked paths, as configured or not; its
        # compilation_cache_dir has no field here (a CUDA graph is
        # captured per process, so there is no compile cache to point at)
        for key in ("weights_path", "profile_dir", "jobs_dir", "calibration_dir", "aot_dir", "incidents_dir"):
            cfg[key] = bool(cfg[key])
        bundle["config"] = cfg
        if self.alert_engine is not None:
            bundle["alerts"] = self.alert_engine.snapshot()
        return bundle

    def _tsdb_tick(self) -> None:
        """One scrape tick: ingest, evaluate the rules, record an incident
        for each rule that began firing (tests call it under a fake clock)."""
        self.tsdb.ingest(self._tsdb_samples())
        if self.alert_engine is None:
            return
        for ctx in self.alert_engine.evaluate():
            if self.incidents is None:
                continue
            rule_name = (ctx.get("rule") or {}).get("name", "rule")
            if self.incidents.record(rule_name, self._incident_bundle(ctx)) is not None:
                self.metrics.inc_counter("incidents_recorded_total")
            else:
                self.metrics.inc_counter("incident_write_errors_total")
                slog.event(slog.get_logger("deconv.app"), "incident_write_failed", level=logging.ERROR,
                           rule=rule_name)

    async def _tsdb_loop(self) -> None:
        """The self-scrape task on the event loop: a tick every
        ``tsdb_interval_s``, an incident sweep every minute; a failing
        tick is counted and logged, never fatal.  Its own cost accrues in
        ``scrape_seconds_total``."""
        interval = self.cfg.tsdb_interval_s
        sweep_every = max(1, int(60.0 / interval))
        tick = 0
        while True:
            await asyncio.sleep(interval)
            t0 = time.perf_counter()
            try:
                self._tsdb_tick()
                tick += 1
                if self.incidents is not None and tick % sweep_every == 0:
                    self.incidents.sweep()
            except Exception as e:  # noqa: BLE001 — the tick must not die
                self.metrics.inc_counter("tsdb_tick_errors_total")
                slog.event(slog.get_logger("deconv.app"), "tsdb_tick_error", level=logging.ERROR,
                           error=f"{type(e).__name__}: {e}")
            self.tsdb.scrapes_total += 1
            self.tsdb.scrape_seconds_total += time.perf_counter() - t0

    async def _metrics_history(self, req: Request) -> Response:
        """``GET /v1/metrics/history``: with no ``family`` the catalog and
        the rings' stats; with one, its series over the trailing
        ``range_s`` (default 60) at ``step_s`` resolution, nested under
        ``series[].points``."""
        q = req.query
        family = q.get("family", "")
        if not family:
            return Response.json({"families": self.tsdb.families(), "stats": self.tsdb.stats()})
        try:
            range_s = float(q.get("range_s", "60"))
            step_s = float(q["step_s"]) if q.get("step_s") else None
        except ValueError:
            return _error_response(errors.BadRequest("range_s/step_s must be numeric"), req.id)
        if range_s <= 0 or (step_s is not None and step_s <= 0):
            return _error_response(errors.BadRequest("range_s/step_s must be > 0"), req.id)
        series = self.tsdb.query(family, q.get("label"), range_s=range_s, step_s=step_s)
        return Response.json({"family": family, "range_s": range_s, "series": series})

    async def _alerts(self, _req: Request) -> Response:
        """``GET /v1/alerts``: the rules' states and lifecycle counters."""
        if self.alert_engine is None:
            return Response.json({"rules": [], "firing": 0, "pending": 0, "evals_total": 0,
                                  "eval_errors_total": 0})
        return Response.json(self.alert_engine.snapshot())

    async def _debug_incidents(self, req: Request) -> Response:
        """``GET /v1/debug/incidents``: the bundle list, or with ``?id=``
        one digest-verified bundle."""
        inc_id = req.query.get("id", "")
        if inc_id:
            doc = self.incidents.load(inc_id)
            if doc is None:
                return _error_response(errors.BadRequest(f"unknown incident {inc_id!r}"), req.id)
            return Response.json(doc)
        return Response.json({"incidents": self.incidents.list(), "writes_total": self.incidents.writes_total,
                              "corrupt_total": self.incidents.corrupt_total,
                              "swept_total": self.incidents.swept_total})

    async def _profile(self, req: Request) -> Response:
        """``POST /v1/profile`` ``batches=N``: re-arm the profile budget so
        the next N device batches are traced into ``profile_dir``."""
        if not self.cfg.profile_dir:
            return _error_response(errors.BadRequest("profiling disabled: set DECONV_PROFILE_DIR"), req.id)
        try:
            form = _parse_form(req) if req.body else {}
            batches = int(form.get("batches", 4))
        except errors.DeconvError as e:
            return _error_response(e, req.id)
        except ValueError:
            return _error_response(errors.BadRequest("batches must be an int"), req.id)
        if not 1 <= batches <= 64:
            return _error_response(errors.BadRequest("batches must be in [1, 64]"), req.id)
        # under the lock: a dispatch's decrement must not stomp the re-arm
        with self._profile_lock:
            self._profile_remaining = batches
        return Response.json({"armed": batches, "profile_dir": self.cfg.profile_dir})

    async def _debug_faults(self, req: Request) -> Response:
        """``POST /v1/debug/faults`` (routed only with fault injection
        on): ``arm`` = "site=spec,..." (the ``--fault`` grammar),
        ``disarm`` = "all" or one site; answers the registry's snapshot."""
        try:
            form = _parse_form(req) if req.body else {}
        except errors.DeconvError as e:
            return _error_response(e, req.id)
        try:
            disarm = form.get("disarm", "")
            if disarm:
                self.faults.disarm(None if disarm == "all" else disarm)
            if form.get("arm"):
                self.faults.arm_string(form["arm"])
        except ValueError as e:
            return _error_response(errors.BadRequest(str(e)), req.id)
        return Response.json({"faults": self.faults.snapshot()})

    def config(self) -> dict:
        """``GET /v1/config``: the effective configuration (``image_size``
        resolved to the default model's when unset; ``warmup_dream`` on by
        default, unlike the JAX package's: on the H100 a first default dream
        without it waits 0.4-0.5 s more, inside the request, for the
        captures a boot makes in 2-4 s before ``/ready``, PERF.md), the
        default model, the weight manager's live residency,
        the job tier's counts, and, under ``graph_pool_bytes``, the device
        memory each resident model's captured programs hold (their two
        pools)."""
        cfg = dataclasses.asdict(self.cfg)
        # paths: reported as configured or not
        for key in ("weights_path", "profile_dir", "jobs_dir", "calibration_dir", "aot_dir"):
            cfg[key] = bool(cfg[key])
        if cfg["fleet_token"]:
            cfg["fleet_token"] = "<set>"  # the shared secret stays unleaked
        cfg["model_active"] = self.weights.default
        cfg["weights"] = self.weights.snapshot()
        # the tiers and, per model whose int8 path was consulted, the
        # calibration its int8 keys are bound to (a digest, or 'dynamic')
        calib = dict(self._calib_cache)
        cfg["quality"] = {"default": self.cfg.quality_default, "by_class": dict(self._class_quality),
                          "calibration": {m: tag for m, (_q, tag) in sorted(calib.items())}}
        # the kernel-library store: did this boot load or build
        cfg["aot_active"] = self.aot is not None
        if self.aot is not None:
            cfg["aot"] = {"entries": self.aot.store.entry_count, "resident_bytes": self.aot.store.resident_bytes,
                          **{k: self.metrics.counter(f"aot_cache_{k}_total")
                             for k in ("hits", "misses", "stores", "corrupt")}}
        # the allocator's snapshot, taken while no capture runs
        with DEVICE_LOCK.shared() if torch.cuda.is_available() else contextlib.nullcontext():
            cfg["graph_pool_bytes"] = {
                name: {"deconv": pool_bytes(b.programs.pool), "dream": pool_bytes(b.dream_programs.pool)}
                for name in self.weights.resident_models()
                if (b := self.weights.peek_bundle(name)) is not None
            }
        cfg["lowc_kpack_chan"] = resolve_kpack_chan(self.cfg.lowc_kpack) if self.bundle.spec is not None else 0
        # where the fused tail engages: 'kernel' (K3 on the card), 'plain'
        # (forced on the CPU: its plain version) or 'off' (the policy, a
        # DAG model, or auto off the card)
        engaged = self.bundle.spec is not None and fused_engaged(resolve_fused_unpool(self.cfg.fused_unpool),
                                                                 self.bundle.device)
        cfg["fused_unpool_resolved"] = ("kernel" if self.bundle.device.type == "cuda" else "plain") if engaged else "off"
        cfg["trace_active"] = self.recorder is not None  # counts: /v1/debug/requests
        cfg["cache_active"] = self.cache is not None
        cfg["singleflight_active"] = self.flights is not None
        # the specs stay unleaked (an alerts spec may be a path)
        cfg["slos"] = bool(cfg["slos"])
        if self.slos:
            cfg["slo_state"] = {t.name: t.snapshot() for t in self.slos}
        cfg["alerts"] = bool(cfg["alerts"])
        cfg["incidents_dir"] = bool(cfg["incidents_dir"])
        cfg["tsdb_active"] = self.tsdb is not None
        if self.tsdb is not None:
            cfg["tsdb_state"] = self.tsdb.stats()
        if self.alert_engine is not None:
            snap = self.alert_engine.snapshot()
            cfg["alerts_state"] = {"rules": len(snap["rules"]), "firing": snap["firing"],
                                   "pending": snap["pending"], "eval_errors_total": snap["eval_errors_total"]}
        if self.incidents is not None:
            cfg["incidents_state"] = {"writes_total": self.incidents.writes_total,
                                      "corrupt_total": self.incidents.corrupt_total,
                                      "swept_total": self.incidents.swept_total}
        cfg["qos_active"] = self.qos is not None
        cfg["tenants"] = bool(cfg["tenants"])  # the spec may be a path: not leaked
        if self.qos is not None:
            cfg["qos_state"] = self.qos.snapshot()
            cfg["qos_state"]["queued_by_class"] = {
                name: d.queued_by_class()
                for name, d in (("deconv", self.dispatcher), ("dream", self.dream_dispatcher),
                                ("sweep", self.sweep_dispatcher))
            }
        cfg["breaker_active"] = self.cfg.breaker_threshold > 0
        if cfg["breaker_active"]:
            cfg["breaker_state"] = self.lane_pool.state_name()
        cfg["warmup_wall_s"] = self.warmup_wall_s
        cfg["jobs_active"] = self.jobs is not None
        if self.jobs is not None:
            cfg["jobs"] = {**self.jobs.counts(), "queue_depth": self.jobs.queue_depth, "workers": self.jobs.workers,
                           "reclaimed_on_boot": self.jobs.reclaimed, "torn_records_on_boot": self.jobs.torn_records}
        cfg["fault_injection_active"] = self.faults is not None
        if self.faults is not None:
            cfg["faults_state"] = self.faults.snapshot()
        cfg["draining"] = self.draining
        cfg["codec_workers_live"] = self.codec_pool.live_workers
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


def _tenancy(req: Request | None) -> dict:
    """The dispatcher's tenancy arguments of a request (its DRR queue with
    QoS on): none for a request that did not come over HTTP."""
    return {"tenant": req.tenant, "tclass": req.tclass} if req is not None else {}


def _annotate_model(model: str) -> None:
    tr = trace_mod.current_trace()
    if tr is not None:
        tr.annotate(model=model)


def _parse_form(req: Request) -> dict[str, str]:
    try:
        return req.form()
    except ValueError as e:  # json.JSONDecodeError is one
        raise errors.BadRequest(f"unparseable form body: {e}") from None


def _error_response(e: errors.DeconvError, request_id: str | None = None) -> Response:
    """A taxonomy error as its status and payload, with a ``Retry-After``
    where the error carries ``retry_after_s`` (a shed, an open breaker)."""
    resp = Response.json(errors.to_payload(e, request_id), e.status)
    retry = errors.retry_after_value(getattr(e, "retry_after_s", None))
    if retry is not None:
        resp.headers["retry-after"] = retry
    return resp


class DeconvHTTPServer:
    """The service's asyncio HTTP server bound on its event-loop thread,
    behind the ``http.server`` interface the callers use:
    ``server_address``, ``serve_forever()`` (blocks until ``shutdown()``),
    ``shutdown()`` and ``server_close()``.  ``port=0`` picks a free port."""

    def __init__(self, service: DeconvService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.server_address = (host, service.listen(host, port))
        self._shutdown = threading.Event()

    def serve_forever(self) -> None:
        self._shutdown.wait()

    def shutdown(self) -> None:
        self._shutdown.set()

    def server_close(self) -> None:
        self._shutdown.set()
        self.service.stop_listening()
