"""Per-request tracing spine + slow/error flight recorder (a copy of
``deconv_api_tpu/serving/trace.py``).

The serving path is a five-stage concurrent pipeline (codec pool →
cache/singleflight → collect queue → dispatch → fetch/encode) and until
now its only observability was AGGREGATE: `Metrics` quantiles say the
fleet's p99 climbed, but nothing could say *which* request was slow or
where its time went.  Production ML-serving systems treat per-request,
cross-stage timelines as the primary debugging surface (TensorFlow's
serving/profiling story, arXiv:1605.08695; TVM's per-op instrumentation,
arXiv:1802.04799); this module is that surface for the deconv service:

- ``new_request_id`` / ``RID_RE``: stable per-request IDs.  An inbound
  ``x-request-id`` header is honored when it is sane (so client logs and
  server traces join on the client's own key); otherwise the server
  mints one — a per-process random prefix + a monotone counter, cheap
  enough for the hot cache-hit path (no uuid4 per request).

- ``RequestTrace``: one request's span timeline.  Spans are
  ``(name, start-offset, duration)`` plus free-form attributes, recorded
  with perf_counter timestamps so offsets are exact across threads.
  The batcher adds queue-wait/dispatch/fetch spans (with the batch id
  that ``Metrics.observe_batch`` recorded), the cache wrapper adds
  lookup/coalesce spans (a coalesced waiter's trace points at the
  LEADER flight's trace id, so the debug endpoint can pull the flight
  that actually computed the bytes), and ``utils.tracing.stage`` mirrors
  every metrics stage observation into the active trace.

- A ``contextvars`` context (``activate``/``current_trace``): routes
  activate the trace for the request's task; everything downstream that
  runs in that task (cache wrapper, dispatcher submit, codec-pool
  handoff) picks it up without threading an argument through five
  layers.  Worker threads never *read* the context — span writers that
  run off-loop (codec workers) capture the trace object by closure, and
  ``RequestTrace`` is lock-protected for exactly those writers.

- ``FlightRecorder``: bounded ring buffers of (a) the last N completed
  traces (head-sampled by ``trace_sample``), (b) tail-sampled SLOW
  traces over ``trace_slow_ms``, and (c) all error traces — slow and
  error traces are always kept regardless of the sample rate, which is
  the tail-sampling contract: the interesting requests survive even
  when the happy path records 1-in-N.  Exposed at
  ``GET /v1/debug/requests`` (serving/app.py) and summarized per-span
  in the Prometheus exposition (monotone seconds/count totals, so the
  averages are derivable and the exposition lint holds).

Overhead: the default configuration (ring 256, sample 1.0) costs one
small object allocation, a handful of list appends, and two deque
appends per request — measured ≤3% of loopback throughput on the hot
cache-hit path (the `trace-on` guard in tools/run_bench_suite.py pins
this budget; rows in bench_suite_results.jsonl).  ``trace_ring=0``
disables the spine entirely (request IDs remain).
"""

from __future__ import annotations

import contextvars
import itertools
import os
import re
import threading
import time
from collections import deque

# Honored inbound x-request-id shape: opaque tokens, no whitespace or
# header-splitting characters, bounded length.  Anything else is
# replaced with a server-minted id (never echoed back verbatim — an
# unsanitized header echo is a response-splitting primitive).
RID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")

_RID_PREFIX = os.urandom(3).hex()  # fresh per process: ids never collide
_RID_COUNTER = itertools.count(1)  # across restarts within one log window


def new_request_id() -> str:
    """Mint a process-unique request id: 6 random hex chars (process
    epoch) + a monotone counter.  ~0.5 µs — uuid4 would cost multiples
    of that on a hot path that answers in ~80 µs from cache."""
    return f"{_RID_PREFIX}-{next(_RID_COUNTER):08x}"


def request_id_from(raw: str | None) -> str:
    """Honor a sane inbound ``x-request-id``; mint otherwise."""
    if raw and RID_RE.match(raw):
        return raw
    return new_request_id()


# Cross-hop trace propagation: the fleet router stamps each
# forward ATTEMPT with ``x-trace-hop: <ordinal>:<purpose>`` so a
# backend's flight-recorder trace of a router-forwarded request knows
# WHICH attempt it was — a retried request's two backend traces would
# otherwise be indistinguishable when the router assembles them into
# one timeline (GET /v1/debug/trace/{id}).  Closed vocabulary + bounded
# ordinal: anything else reads as "no hop context", never an error.
HOP_PURPOSES = frozenset(
    ("primary", "hedge", "failover", "canary", "replica")
)
HOP_RE = re.compile(
    r"^([0-9]{1,3}):(primary|hedge|failover|canary|replica)$"
)


def hop_from(raw: str | None) -> tuple[int, str] | None:
    """Parse an inbound ``x-trace-hop`` header into ``(attempt ordinal,
    purpose)``; malformed or absent yields None — hop context is
    annotation metadata, and rejecting a request over it would fail
    work the caller still wants (the x-deadline-ms rule)."""
    if not raw:
        return None
    m = HOP_RE.match(raw)
    if not m:
        return None
    return int(m.group(1)), m.group(2)


# A deadline header longer than a day is a client bug, not a budget;
# ignoring it (no deadline) beats honoring a nonsense value.
MAX_DEADLINE_MS = 24 * 3600 * 1000


def deadline_from(raw: str | None, now: float | None = None) -> float | None:
    """Parse an inbound ``x-deadline-ms`` header (deadline
    propagation) into an ABSOLUTE ``time.perf_counter`` deadline.

    The header is the caller's remaining budget in milliseconds, anchored
    at request-parse time so queue wait counts against it.  Malformed or
    insane values (non-numeric, <= 0, > a day) yield None — no deadline —
    rather than a 400: the header is advisory backpressure metadata, and
    rejecting the request over it would fail work the caller still
    wants.  The per-dispatcher cap against ``request_timeout_s`` is
    applied downstream (serving/batcher.py), where the timeout lives."""
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        return None
    if not 0 < ms <= MAX_DEADLINE_MS:
        return None
    return (time.perf_counter() if now is None else now) + ms / 1e3


class RequestTrace:
    """One request's span-structured lifecycle.

    Span timestamps are ``time.perf_counter()`` values; offsets are
    computed against the trace's own start so the serialized form is
    self-contained.  Lock-protected: spans are recorded from the event
    loop AND from codec-pool worker threads (the pool-handoff span)."""

    __slots__ = (
        "id", "route", "start_ts", "t0", "spans", "annotations",
        "status", "error", "total_ms", "_lock",
    )

    def __init__(self, request_id: str, route: str):
        self.id = request_id
        self.route = route
        self.start_ts = time.time()
        self.t0 = time.perf_counter()
        self.spans: list[dict] = []
        self.annotations: dict = {}
        self.status: int | None = None
        self.error: str | None = None
        self.total_ms: float | None = None
        self._lock = threading.Lock()

    def add_span(self, name: str, start_pc: float, dur_s: float, **attrs) -> None:
        """Record one span: ``start_pc`` is a perf_counter timestamp,
        ``dur_s`` its wall duration.  Extra kwargs become span attrs."""
        span = {
            "name": name,
            "start_ms": round((start_pc - self.t0) * 1e3, 3),
            "ms": round(dur_s * 1e3, 3),
        }
        if attrs:
            span.update(attrs)
        with self._lock:
            self.spans.append(span)

    def annotate(self, **fields) -> None:
        """Trace-level attributes (batch id, cache disposition, the
        coalesced waiter's leader link)."""
        with self._lock:
            self.annotations.update(fields)

    def finish(
        self,
        status: int,
        error: str | None = None,
        cache: str | None = None,
    ) -> None:
        self.total_ms = round((time.perf_counter() - self.t0) * 1e3, 3)
        self.status = status
        self.error = error
        if cache is not None:
            self.annotate(cache=cache)

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "id": self.id,
                "route": self.route,
                "ts": round(self.start_ts, 3),
                "status": self.status,
                "error": self.error,
                "total_ms": self.total_ms,
                "spans": list(self.spans),
            }
            d.update(self.annotations)
        return d


# ------------------------------------------------------------- context

_current: contextvars.ContextVar[RequestTrace | None] = contextvars.ContextVar(
    "deconv_request_trace", default=None
)


def current_trace() -> RequestTrace | None:
    """The active request's trace, or None outside a traced request
    (CLI paths, warmup, tests without the spine)."""
    return _current.get()


def activate(trace: RequestTrace) -> contextvars.Token:
    return _current.set(trace)


def deactivate(token: contextvars.Token) -> None:
    _current.reset(token)


# ------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded rings of completed traces: recent / slow / error.

    ``record`` classifies a finished ``RequestTrace``; ``query`` serves
    the ``/v1/debug/requests`` surface.  All state is lock-protected —
    recording happens per request on the event loop, queries come from
    debug handlers and tests.

    ``sample`` head-samples the RECENT ring only (1.0 = every request,
    0.25 = one in four, 0 = none); slow and error traces are always
    recorded — tail sampling keeps the interesting requests regardless
    of how aggressively the happy path is thinned."""

    def __init__(
        self,
        ring: int = 256,
        *,
        slow_ms: float = 100.0,
        sample: float = 1.0,
    ):
        n = max(1, int(ring))
        self.slow_ms = float(slow_ms)
        # Stratified deterministic sampling (no RNG on the hot path):
        # trace k of the stream is kept when floor(k*sample) advances,
        # so ANY rate in (0, 1] retains exactly floor(N*sample) of N —
        # keep-every-kth would quantize (0.75 -> keep all, 0.4 -> 1-in-2)
        self.sample = min(1.0, max(0.0, float(sample)))
        self._lock = threading.Lock()
        self._recent: deque[dict] = deque(maxlen=n)
        self._slow: deque[dict] = deque(maxlen=n)
        self._errors: deque[dict] = deque(maxlen=n)
        self._n = 0
        self.traces_total = 0
        self.slow_total = 0
        self.error_total = 0
        # per-span monotone aggregates (count, total seconds, max seconds)
        # — the per-stage summary /v1/metrics exposes.  O(1) per span,
        # unlike the reservoirs Metrics keeps for the stage quantiles.
        self._span_stats: dict[str, list] = {}

    def record(self, trace: RequestTrace) -> None:
        d = trace.to_dict()
        is_error = (trace.status or 0) >= 400
        is_slow = (
            self.slow_ms > 0
            and trace.total_ms is not None
            and trace.total_ms >= self.slow_ms
        )
        with self._lock:
            self._n += 1
            self.traces_total += 1
            for span in d["spans"]:
                st = self._span_stats.get(span["name"])
                if st is None:
                    st = self._span_stats[span["name"]] = [0, 0.0, 0.0]
                st[0] += 1
                st[1] += span["ms"] / 1e3
                st[2] = max(st[2], span["ms"] / 1e3)
            if is_error:
                self.error_total += 1
                self._errors.append(d)
            if is_slow:
                self.slow_total += 1
                self._slow.append(d)
            if int(self._n * self.sample) > int((self._n - 1) * self.sample):
                self._recent.append(d)

    def query(
        self,
        *,
        slow: bool = False,
        error: bool = False,
        trace_id: str | None = None,
        tenant: str | None = None,
        model: str | None = None,
        limit: int = 50,
    ) -> list[dict]:
        """Newest-first traces.  ``trace_id`` searches every ring;
        ``slow`` / ``error`` select their rings (both = union, deduped —
        the same trace dict can sit in several rings); neither = the
        recent ring.  ``tenant`` (QoS) and ``model`` (multi-model serving) filter whichever pool was selected on the
        trace's annotations — either alone searches every ring, so
        "which tenant is slow" / "is it only vgg19 requests" is one
        query, not a log grep."""
        with self._lock:
            if trace_id is not None:
                pool = list(self._errors) + list(self._slow) + list(self._recent)
                pool = [d for d in pool if d["id"] == trace_id]
            elif slow or error:
                pool = []
                if error:
                    pool.extend(self._errors)
                if slow:
                    pool.extend(self._slow)
            elif tenant is not None or model is not None:
                # identity-only query: the caller is asking about an
                # annotation, not a ring — search everything retained
                pool = list(self._errors) + list(self._slow) + list(self._recent)
            else:
                pool = list(self._recent)
        if tenant is not None:
            pool = [d for d in pool if d.get("tenant") == tenant]
        if model is not None:
            pool = [d for d in pool if d.get("model") == model]
        uniq: list[dict] = []
        seen: set[int] = set()
        for d in sorted(pool, key=lambda d: d["ts"], reverse=True):
            if id(d) in seen:
                continue
            seen.add(id(d))
            uniq.append(d)
            if len(uniq) >= limit:
                break
        return uniq

    def counts(self) -> dict:
        with self._lock:
            return {
                "traces_total": self.traces_total,
                "slow_total": self.slow_total,
                "error_total": self.error_total,
                "recent": len(self._recent),
                "slow": len(self._slow),
                "errors": len(self._errors),
            }

    def prometheus(self, prefix: str = "deconv") -> str:
        """Trace-spine exposition block: monotone totals (lint-safe) +
        per-span seconds/count aggregates — sum/count give the per-stage
        average, max the worst single span since boot."""
        from deconv_api_tpu_torch.serving.metrics import escape_label

        p = prefix
        with self._lock:
            counts = {
                "recent": len(self._recent),
                "slow": len(self._slow),
                "error": len(self._errors),
            }
            totals = (self.traces_total, self.slow_total, self.error_total)
            stats = {k: list(v) for k, v in self._span_stats.items()}
        lines = [
            f"# HELP {p}_traces_total completed request traces by class",
            f"# TYPE {p}_traces_total counter",
            f'{p}_traces_total{{class="all"}} {totals[0]}',
            f'{p}_traces_total{{class="slow"}} {totals[1]}',
            f'{p}_traces_total{{class="error"}} {totals[2]}',
            f"# TYPE {p}_trace_ring_size gauge",
        ]
        for ring, n in sorted(counts.items()):
            lines.append(f'{p}_trace_ring_size{{ring="{ring}"}} {n}')
        if stats:
            lines.append(
                f"# HELP {p}_trace_span_seconds_total summed span wall time; "
                "divide by trace_spans_total for the per-stage average"
            )
            lines.append(f"# TYPE {p}_trace_span_seconds_total counter")
            for name, (_, total, _mx) in sorted(stats.items()):
                lines.append(
                    f'{p}_trace_span_seconds_total'
                    f'{{span="{escape_label(name)}"}} {total:.6f}'
                )
            lines.append(f"# TYPE {p}_trace_spans_total counter")
            for name, (count, _, _mx) in sorted(stats.items()):
                lines.append(
                    f'{p}_trace_spans_total{{span="{escape_label(name)}"}} {count}'
                )
            lines.append(f"# TYPE {p}_trace_span_max_seconds gauge")
            for name, (_, _, mx) in sorted(stats.items()):
                lines.append(
                    f'{p}_trace_span_max_seconds'
                    f'{{span="{escape_label(name)}"}} {mx:.6f}'
                )
        return "\n".join(lines) + "\n"


def debug_query_args(query: dict, trace_ring: int) -> dict:
    """Parse the ``GET /v1/debug/requests`` query contract —
    ``?slow=``/``?error=`` ring selectors, ``?id=`` search, ``?limit=``
    (default 50, clamped to 10x the ring) — into ``FlightRecorder.query``
    kwargs.  ONE implementation for the backend (serving/app.py) and the
    router (serving/fleet.py), so the two surfaces cannot
    silently diverge; identity filters (tenant/model) layer on top at
    the backend.  Raises ValueError on a non-integer limit (the caller
    answers 400)."""

    def truthy(v: str) -> bool:
        return v.lower() in ("1", "true", "yes", "on")

    limit = int(query.get("limit", "50"))
    return {
        "slow": truthy(query.get("slow", "")),
        "error": truthy(query.get("error", "")),
        "trace_id": query.get("id") or None,
        "limit": max(1, min(limit, 10 * max(1, trace_ring))),
    }


# ------------------------------------------------------ trace assembly


def assemble_timeline(
    router_trace: dict, backend_traces: dict[str, list[dict]]
) -> list[dict]:
    """Merge a router flight-recorder trace with the per-backend traces
    it touched into ONE ordered timeline (the
    ``GET /v1/debug/trace/{id}`` surface).

    Every span gains a ``source`` ("router" or the backend's host:port)
    and its ``start_ms`` is re-anchored to the ROUTER trace's start
    using each trace's wall-clock ``ts`` — approximate across hosts
    (NTP-grade skew applies; the runbook says so), exact enough to read
    "the hedge fired at +52 ms, the loser was cancelled at +81 ms, the
    winner's device span ran +55..+74 ms" off one listing.  Each
    backend trace also contributes a synthetic ``backend_request`` span
    covering its whole server-side life, carrying its hop annotations
    (attempt ordinal + purpose) so the two legs of a retry or hedge are
    attributable at a glance.  Spans sort by start offset."""
    t0 = float(router_trace.get("ts") or 0.0)
    timeline: list[dict] = []
    for span in router_trace.get("spans", ()):
        timeline.append({**span, "source": "router"})
    for backend, traces in backend_traces.items():
        for tr in traces:
            shift_ms = round((float(tr.get("ts") or t0) - t0) * 1e3, 3)
            summary = {
                "name": "backend_request",
                "source": backend,
                "start_ms": shift_ms,
                "ms": tr.get("total_ms"),
                "status": tr.get("status"),
                "route": tr.get("route"),
            }
            for key in ("hop", "hop_purpose", "cache", "error"):
                if tr.get(key) is not None:
                    summary[key] = tr[key]
            timeline.append(summary)
            for span in tr.get("spans", ()):
                timeline.append(
                    {
                        **span,
                        "source": backend,
                        "start_ms": round(
                            float(span.get("start_ms") or 0.0) + shift_ms, 3
                        ),
                    }
                )
    timeline.sort(key=lambda s: (s.get("start_ms") or 0.0))
    return timeline
