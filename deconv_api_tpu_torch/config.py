"""The server's configuration (counterpart of ``deconv_api_tpu/config.py``),
holding the fields the port honours, with the JAX package's names,
defaults and ``DECONV_<FIELD>`` environment variables
(``ServerConfig.from_env``).  ``DeconvService`` validates it at boot with
the JAX package's messages.

Left out, as they have no counterpart here: ``host`` and ``port`` (the
CLI's flags), ``donate_inputs`` (XLA buffer donation),
``compilation_cache_dir`` (a CUDA graph is captured per process),
``platform`` (a jax backend; the port's entry points take a device), the
mesh, lanes and pod fields (one card, one lane).  ``aot_dir`` stores
the built kernel libraries (``serving/aot.py``), the port's compiled
artifacts.  The fleet fields are here: a backend's
peer cache fill and its registration with the routers of
``serving/fleet.py``; with no pod, ``fleet_capacity`` 0 advertises 1.
``weights_path`` loads Keras ``.h5`` and ``.npz`` weights and the port's
checkpoint directories (``models/weights.py``, ``utils/checkpoint.py``;
the JAX package's orbax directories are refused with a conversion recipe), and
``profile_dir`` is where ``torch.profiler`` traces go
(``utils/tracing.py``).

One default differs from the JAX package's: ``warmup_dream`` is on, as the
H100's boot and first-dream times decide (``PERF.md``)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class ServerConfig:
    model: str = "vgg16"
    image_size: int = 0  # 0 = the model's native size (224 VGG/ResNet, 299 Inception)
    top_k: int = 8
    stitch_k: int = 4  # tiles in the response grid (reference: 4, 2x2)
    visualize_mode: str = "all"  # 'all' | 'max' (the reference hardcodes 'all')
    bug_compat: bool = True  # reproduce the reference's projection quirks for parity
    strict_compat: bool = False  # also reproduce the reference's <stitch_k-filters error
    # batching dispatcher (fixes the reference's 1-concurrency)
    max_batch: int = 8
    batch_window_ms: float = 3.0
    # Warm every power-of-two batch bucket at startup (the first concurrent
    # burst otherwise pays a per-bucket capture at request time); off =
    # warm only the smallest bucket (fast dev/test startup).
    warmup_all_buckets: bool = True
    # Also capture the sweep program at startup (bucket 1): its program is
    # ~15x a single-layer request and the first sweep request otherwise
    # pays its capture inside its own sweep_timeout_s window.  Off by
    # default: sweeps are an opt-in surface.
    warmup_sweep: bool = False
    # Also capture the default dream (every rung's pyramid and ascent step)
    # at startup, for the default model, so the first default dream is
    # served from graphs.  On by default in the port (the JAX package
    # defaults it off): on the H100 a first dream without it waits 0.4-0.5 s
    # more inside its request, for captures a boot makes in 2-4 s before
    # /ready (PERF.md).
    warmup_dream: bool = True
    request_timeout_s: float = 60.0
    dream_timeout_s: float = 300.0  # dreams run minutes; own queue + timeout
    # Layer sweeps project ~13x a single-layer request; they ride their own
    # dispatcher + metrics stream (like dreams) so interactive traffic is
    # never head-of-line blocked and the shed estimator's p50 stays clean.
    sweep_timeout_s: float = 300.0
    # Connection-level abuse hardening: a slowloris client may hold a
    # socket (and body buffer) only this long; idle keep-alive
    # connections are reaped on the same clock.  0 disables (tests).
    conn_idle_timeout_s: float = 30.0
    body_read_timeout_s: float = 20.0
    max_connections: int = 256  # concurrent sockets; excess get 503 + close
    # Load shedding: reject immediately (503) when the estimated queue
    # drain time exceeds this multiple of request_timeout_s (callers would
    # only wait out the timeout and 504 anyway).  0 disables shedding.
    shed_factor: float = 1.0
    # Batch pipelining: how many dispatched-but-unfetched device batches a
    # dispatcher may hold (serving/batcher.py).  2 overlaps batch N's
    # device-to-host copy, JPEG encode and resolve with batch N+1's replay;
    # 1 restores the serial dispatch->fetch loop.
    pipeline_depth: int = 2
    # Concurrent dreams with identical (layers, steps, octaves, lr) batch
    # into one octave pyramid; the window is wide because dreams run for
    # seconds anyway.
    dream_max_batch: int = 4
    dream_window_ms: float = 50.0
    # --- host I/O pipeline (serving/codec_pool.py) ---
    # Codec worker pool: decodes request payloads and encodes response
    # JPEGs off the event loop on persistent daemon threads.  0 workers =
    # auto (min(8, cpu/2)); codec_queue_depth bounds queued-or-running
    # codec jobs — the bound is the decode/encode stages' backpressure.
    codec_workers: int = 0
    codec_queue_depth: int = 256
    # Payloads at or under this many bytes decode INLINE on the event
    # loop: a pool handoff costs more than a small image's decode.  0
    # sends everything to the pool.
    codec_inline_bytes: int = 16384
    # Reusable host staging buffers per padded batch shape (pinned on the
    # card): batch N+1 assembles into a different buffer than in-flight
    # batch N.  >= 2; 3 leaves one spare for the fetch tail.
    input_ring_depth: int = 3
    # --- response cache + singleflight (serving/cache.py) ---
    # Content-addressed response cache: final encoded payloads keyed by a
    # digest of (model, route, canonical params, raw image bytes).  A hit
    # skips decode, device dispatch and encode entirely.  Byte budget for
    # resident payloads; 0 disables the cache (the escape hatch).
    cache_bytes: int = 256 * 1024 * 1024
    # Positive-entry TTL.  0 = entries live until LRU-evicted (responses
    # are pure functions of the key, so expiry is a freshness policy for
    # operators who hot-swap weights in place, not a correctness need).
    cache_ttl_s: float = 0.0
    # Deterministic 4xxs (unknown layer, bad knobs, undecodable image)
    # are negative-cached this long so retry loops stop paying the form
    # parse + validation walk.  0 disables negative caching.
    cache_negative_ttl_s: float = 2.0
    cache_shards: int = 8  # LRU shards (per-shard lock + budget slice)
    # Coalesce concurrent IDENTICAL misses onto one in-flight request:
    # N duplicates in flight -> exactly 1 decode/dispatch/encode, N
    # responses.  Works with or without the cache; off restores
    # independent execution.
    singleflight: bool = True
    # Durable L2 response cache: a disk tier behind the in-memory LRU
    # (serving/cache.py L2Store).  Positive entries write through
    # asynchronously under the l2_bytes budget and are looked up on a
    # memory miss BEFORE compute, digest-verified (corruption reads as a
    # miss, never an error).  Empty = DISABLED: the server touches no disk.
    l2_dir: str = ""
    # L2 byte budget; oldest entries (by last-read mtime, which survives
    # restarts) sweep when exceeded.  0 = unbounded.
    l2_bytes: int = 1024 * 1024 * 1024
    # --- per-request tracing (serving/trace.py) ---
    # Flight-recorder ring size: the last N completed traces, N
    # tail-sampled slow traces, and N error traces, served at
    # GET /v1/debug/requests.  0 disables tracing (responses still carry
    # x-request-id).
    trace_ring: int = 256
    # A completed request slower than this lands in the slow ring
    # regardless of trace_sample (tail sampling).
    trace_slow_ms: float = 100.0
    # Head-sample rate for the RECENT ring (1.0 = every request, 0 = only
    # slow/error traces are retained).
    trace_sample: float = 1.0
    # --- latency SLOs (serving/metrics.py SloTracker) ---
    # Comma-separated latency SLO objects,
    # 'name=<threshold_ms>:<objective_pct>[:<route>]' — e.g.
    # 'api=250:99,deconv=100:99.9:/v1/deconv'.  Each tracks the
    # fraction of its (optionally route-scoped) requests finishing
    # under the threshold (5xx always breaches) and publishes
    # multi-window burn-rate gauges (slo_burn_rate{slo=,window=}) plus
    # an `slo` block on /readyz.  Requests feed the
    # request_duration_seconds histogram either way; '' = no SLO
    # objects.  Validated at boot.
    slos: str = ""
    # --- metric history + alerting (serving/tsdb.py, serving/alerts.py) ---
    # Embedded TSDB master switch: 'on' starts a periodic self-scrape
    # task sampling Metrics.snapshot() into two fixed-size ring tiers
    # (raw 1×tsdb_interval_s × 600 slots, rolled min/mean/max at
    # 15×interval × 960 slots) and registers GET /v1/metrics/history.
    # 'off' = nothing registered, no task.  A non-empty `alerts` spec
    # implies 'on'.
    tsdb: str = "off"
    # Self-scrape cadence in seconds.  Both ring tiers scale with it
    # (the rollup interval is always 15× the raw interval).
    tsdb_interval_s: float = 1.0
    # Declarative alert rules: inline JSON ('{"rules": [...]}' or a
    # bare list) or a path to a JSON file — validated at boot (a typo'd
    # kind/key/SLO fails the process).  Rule kinds: threshold (aggregate
    # one TSDB series over a window and compare), burn (multi-window SLO
    # error-budget overspend), absence (series staleness).  Evaluated
    # every scrape tick with for_s hold-downs; surfaced at GET
    # /v1/alerts, as alert_state{rule=} gauges, and on /readyz.  Empty =
    # no engine.
    alerts: str = ""
    # Directory for digest-verified incident bundles written when a
    # rule transitions to firing.  Empty = alerts still evaluate but
    # nothing is recorded; /v1/debug/incidents 404s.
    incidents_dir: str = ""
    # Incident bundle retention: bundles older than this (or beyond the
    # newest 64) are swept on the scrape tick.
    incidents_retention_s: float = 86400.0
    # --- robustness (serving/faults.py, the batcher's breaker) ---
    # Fault injection master switch: enables the registry, the module
    # hook and the POST /v1/debug/faults arm route (404 while off).
    # Never enable on a server an untrusted party can reach.
    fault_injection: bool = False
    # Faults armed at startup: "site=spec,site=spec" (see serving/
    # faults.py for the grammar).  Non-empty implies fault_injection.
    faults: str = ""
    # Seed for the registry's deterministic RNG: probabilistic chaos
    # runs replay the same firing sequence.
    fault_seed: int = 0
    # Device circuit breaker: open after this many CONSECUTIVE batch
    # failures (fail-fast 503 breaker_open + Retry-After while open,
    # half-open single-probe recovery after the cooldown).  0 disables.
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 5.0
    # Seconds between /readyz flipping to 503 (drain begin) and the
    # dispatchers stopping on shutdown, so load balancers observe the flip
    # and stop routing before connections start dying; running jobs reach
    # their next checkpoint in it.  0 = immediate (tests, dev loops).
    drain_grace_s: float = 0.0
    # --- durable async jobs (serving/jobs.py) ---
    # Directory for the job tier's write-ahead journal (journal.jsonl) and
    # checkpoint/result spill files.  Empty = DISABLED: no /v1/jobs routes,
    # no runner tasks, no cost on the synchronous path.  Heavy dreams and
    # sweeps run for seconds; POST /v1/jobs with SSE progress is the
    # durable alternative (execution checkpoints at octave/layer
    # boundaries and resumes from the journal after a crash or restart).
    jobs_dir: str = ""
    # Queued-or-running jobs the tier will hold; a full queue 429s new
    # submissions with a Retry-After from the running job cost.
    jobs_queue_depth: int = 64
    # Concurrent job runner tasks (each job's device work still rides the
    # shared dispatchers: this bounds how many jobs make progress at once,
    # not device parallelism).
    jobs_workers: int = 2
    # Completed/failed/cancelled job records (and their result payloads)
    # survive this long across boots before compaction drops them: the
    # idempotent-resubmit and late-GET window.
    jobs_retention_s: float = 3600.0
    # Runner-crash resume budget per job: a job that crashes (not a
    # deterministic taxonomy failure) re-queues and resumes from its last
    # checkpoint at most this many times before failing for good.
    jobs_max_attempts: int = 3
    # Low-channel backward-tail packing of the sequential engine: 'off'
    # (default) | 'auto' (pack the C<=64 tail when top_k > 1) | 'forced'
    # (whole certified C<=128 tail) | an explicit channel threshold.  DAG
    # models and dreams leave it inert.  Output bytes are identical on/off.
    lowc_kpack: str = "off"  # 'off' | 'auto' | 'forced' | '<channels>'
    # The fused unpool + flipped-conv backward tail (K3, csrc/
    # fused_unpool_conv.cu): fuse each certified pool -> backward-ReLU ->
    # flipped-conv triple of the backward walk into one kernel.  'off'
    # (default: K2 + cuDNN is faster on the H100, PERF.md) | 'auto' (fuse
    # certified sites on the card; elsewhere inert) | 'forced' (fuse
    # everywhere: the plain version on the CPU, the parity harness).
    # Sequential models only; DAG models and dreams leave it inert.
    # Validated at boot; it folds into the response-cache key prefix.
    fused_unpool: str = "off"  # 'off' | 'auto' | 'forced'
    dtype: str = "float32"  # forward/selection dtype: 'float32' | 'bfloat16'
    # Backward-projection dtype.  bfloat16 is the default: selection and
    # switches stay exact (the forward runs in `dtype`); '' runs the
    # backward in the forward's dtype (no cast).
    backward_dtype: str = "bfloat16"  # '' | 'float32' | 'bfloat16'
    # --- multi-model serving (serving/weight_manager.py) ---
    # The set of registry models THIS process serves per-request
    # (``model=`` form field / ``x-model`` header): '' = only `model`
    # (the classic single-model server: the manager stays inert and the
    # hot path is unchanged), 'all' = the whole registry, or a comma list.
    # `model` is always included and stays the default when a request
    # names nothing.
    serve_models: str = ""
    # Models paged onto the card and warmed (captured) at BOOT, never
    # evicted: '' = just `model`.  Everything else served is ON-DEMAND:
    # its first request pays the page-in (and first-use captures) inside
    # its own latency, visible as a weight_page_in stage.
    pinned_models: str = ""
    # Device-memory byte budget for resident model weights (the stored
    # form's bytes).  0 = unlimited (nothing is ever paged out).  When the
    # working set exceeds it, the least-recently-used unpinned model with
    # no in-flight batches is paged out; if every resident model is pinned
    # or in flight the budget overshoots LOUDLY
    # (weight_budget_overcommit_total) instead of failing requests.
    hbm_budget_bytes: int = 0
    # Stored weight precision of the device copies: 'f32' (exact, the
    # default), 'bf16' (half the bytes; cast-on-use), 'int8' (per-tensor
    # symmetric kernels, about a quarter of the kernel bytes, f32
    # dequant-on-use).  Quantized tiers trade bounded fidelity (PSNR
    # floors) for more resident models per budget.
    weight_dtype: str = "f32"
    # --- multi-tenant QoS (serving/qos.py) ---
    # Master switch: tenant identity (x-api-key / x-tenant header),
    # priority classes, per-tenant token-bucket device-time budgets and
    # in-flight caps, and deficit-round-robin fair queues in every
    # dispatcher.  OFF by default: the batcher keeps its plain FIFO and the
    # routes skip the admission wrap.
    qos: bool = False
    # Tenant policy spec: inline JSON ('{...}') or a path to a JSON file,
    # {"name": {"class": "bulk", "rate_ms": 50, "burst_ms": 200,
    # "max_inflight": 32}}.  "*" is the template for tenants not named;
    # anonymous traffic maps to the (unmetered by default) 'default'
    # tenant.  Empty = fair queues only, no quotas.
    tenants: str = ""
    # Priority class for tenants with no explicit class (and for the
    # default tenant): 'interactive' | 'standard' | 'bulk'.
    qos_default_class: str = "standard"
    # DRR quantum weights per class, 'class=weight,...' (defaults
    # interactive=8,standard=4,bulk=1).
    qos_weights: str = ""
    # Fixed device-ms a response-cache hit debits from the tenant's
    # bucket: hits are metered traffic, not free.
    qos_hit_cost_ms: float = 0.05
    # --- per-request quality and the int8 execution tier ---
    # Default precision tier for requests that name none (the ``quality=``
    # form field wins, then the ``x-quality`` header, then the requester's
    # QoS-class default below, then this): 'full' = the server's
    # configured fidelity, 'bf16' = the forward staged in bfloat16,
    # 'int8' = int8 activations and kernels with int32 accumulation
    # through the forward walk (sequential models; DAG models run it as
    # bf16 and dreams as full).  The resolved tier joins the response-cache
    # key, so an int8 body never serves a full-fidelity request.
    quality_default: str = "full"
    # Per-QoS-class default tiers, 'class=tier,...', applied only when QoS
    # is on and the request names no tier: bulk traffic runs int8 while
    # interactive traffic keeps full fidelity.  Empty disables them.
    quality_by_class: str = "bulk=int8"
    # Directory of per-model calibration artifacts (<model>.calib.json,
    # engine/quant.py): per-layer activation ranges.  With an artifact,
    # quality=int8 uses its static scales (its digest joins the cache
    # key); without one, each example's own ranges ('dynamic').  A corrupt
    # artifact reads as absent.
    calibration_dir: str = ""
    # --- the warm boot (serving/aot.py) ---
    # Directory of built kernel libraries, keyed by the kernel's source,
    # nvcc's flags and version, the card's compute capability and torch's
    # versions.  With it set, the boot resolves every kernel library
    # before /ready: a stored one is loaded, a missing one is built with
    # nvcc and stored, so a backend booting against a filled store (a
    # shared disk, or one copied from a peer) runs no nvcc.  Empty =
    # disabled: kernels build into the checkout's build/ at first use.
    # Entries are digest-verified; a corrupt one reads as a miss.
    aot_dir: str = ""
    # Store byte budget; the oldest entries (by last use) are swept above
    # it.  0 = unbounded.
    aot_bytes: int = 0
    # --- fleet tier (serving/fleet.py) ---
    # Peer cache fill: honour the router's ``x-peer-fill: host:port`` hint
    # on a cache miss by asking the key's previous ring owner for the
    # finished payload (GET /v1/internal/cache/{digest}) before computing,
    # so a rebalance (drain, ejection, scale-out) moves bytes rather than
    # recomputes.  Also registers the internal cache route this backend
    # serves to its peers.  Off by default: the hint names a host to fetch
    # from, so it belongs on a trusted mesh behind the router tier.
    fleet_peer_fill: bool = False
    # Per-peer-fetch timeout: past it the miss computes, so a slow peer
    # never costs more than the compute it would have saved.
    peer_fill_timeout_s: float = 2.0
    # Shared fleet secret: backends present it (x-fleet-token) when they
    # register with routers, routers require it on POST
    # /v1/internal/register.  Empty disables registration on both sides.
    fleet_token: str = ""
    # Router addresses ('host:port,host:port') this backend announces
    # itself to: register once its listener answers, drain on SIGTERM.
    # Empty = no announcements.
    fleet_routers: str = ""
    # The host:port this backend registers as (what routers probe and
    # forward to).  Empty = '<hostname>:<bound port>'.
    fleet_advertise: str = ""
    # Capacity this member advertises on registration: the ring grants it
    # vnodes in proportion.  0 = auto, which is 1 here (no pod).
    fleet_capacity: int = 0
    # Pretrained weights: a Keras .h5 (needs h5py) or .npz file, which
    # belongs to the default model, or a directory of <model>.h5 /
    # <model>.npz files, one per served model ('' = He-normal init).
    weights_path: str = ""
    # torch.profiler trace output: the first DECONV_PROFILE_BATCHES device
    # batches after warmup, and each POST /v1/profile re-arm ('' = disabled)
    profile_dir: str = ""

    @classmethod
    def from_env(cls, **overrides: Any) -> "ServerConfig":
        """The defaults, then each ``DECONV_<FIELD>`` variable that is set,
        then ``overrides`` (a name that is no field raises)."""
        cfg = cls()
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"DECONV_{f.name.upper()}")
            if env is not None:
                setattr(cfg, f.name, _coerce(env, f.type, getattr(cfg, f.name)))
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        return cfg


def _coerce(raw: str, annotation: Any, default: Any):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, tuple):
        return tuple(int(x) for x in raw.split(",") if x)
    return raw
