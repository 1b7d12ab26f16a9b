"""The fleet tier: a cache-affine HTTP router over N deconv backends (a copy
of ``deconv_api_tpu/serving/fleet.py``: the same placement, headers,
status codes, error bodies and metric families, so the port's router and
the JAX package's route one request to one backend).

A round-robin balancer would fragment the backends' response caches (a
hot key warms N private LRUs with N device computations) and spread N
identical in-flight requests over N singleflight tables.  This router
consistent-hashes the same canonical request digest the backend cache
uses (``serving/cache.py:canonical_digest``) onto a ring of backends, so
identical requests land on one backend and N private caches act as one.

- ``HashRing``: consistent hashing with ``vnodes`` virtual nodes per
  member (times the member's advertised capacity).  Placement is a pure
  function of (member name, key): every router over the same member set
  agrees, and a join or leave moves about 1/N of the keyspace.
- ``BackendMember``: one backend's health state, gated by its
  ``/readyz``: admitted on a 200, removed gracefully when it reports or
  announces a drain, ejected by a ``CircuitBreaker`` after consecutive
  probe or forward failures and re-admitted by a half-open probe.  503
  sheds and 504 deadlines are backpressure, never an ejection signal.
- ``BackendPool``: a bounded keep-alive connection pool per backend,
  with a stale-socket retry and a destroyed socket for a cancelled
  (hedge loser) roundtrip; ``raw_request`` and ``raw_request_stream``
  are the dial-per-request dialect the backends' peer fill also speaks.
- ``FleetRouter``: POST bodies are digested and forwarded to the key's
  ring owner, everything else round-robins.  Headers pass through (an
  ``x-request-id`` is minted when absent), responses come back stamped
  ``x-backend``.  A transport failure retries once on the next distinct
  owner, then answers 502 ``backend_unavailable`` with a ``Retry-After``.
  Job entity routes follow the job's backend; ``GET /v1/jobs`` gathers
  every member's collection.  When membership changes, a moved key's
  request carries ``x-peer-fill: host:port`` naming its previous owner,
  whose cache the new owner reads before computing
  (``GET /v1/internal/cache/{digest}`` on the backend).
- Membership: a static ``--backends`` list, self-registration
  (``POST /v1/internal/register`` with the shared fleet token:
  ``register`` at boot, ``drain`` at SIGTERM) and a shared membership
  file that several routers converge on.  An announced drain leaves the
  ring at once; one that names ``grace_s`` (the port's backends do)
  stays a peer-fill source until its grace ends, so a drained backend's
  keyspace moves as bytes rather than recomputes.  That hint is the one
  routing difference from the JAX router, which never hints at an
  announced drain.
- Tail tolerance: per-backend latency windows (forwards and probes on
  separate channels), gray-failure demotion to ``slow`` (placement kept,
  picks routed around it), hedged requests (a duplicate to the next
  owner after the fleet p95, under a token-bucket budget of
  ``hedge_budget_pct`` of requests), hot-key read replication, and the
  router-side ``fleet.*`` network-fault sites behind ``POST
  /v1/debug/faults``.
- Observability: the router's own flight recorder (``x-trace-hop``
  stamps, ``GET /v1/debug/trace/{id}`` joins the backends' records),
  ``/v1/metrics/fleet`` federation with a ``backend=`` label, latency
  histograms and SLO burn rates, and with ``tsdb=on`` metric history,
  alert rules and incident bundles.

- Elasticity: ``autoscale`` advisory or enforce embeds the controller
  of ``serving/autoscale.py`` (its arrival hook on the proxy path, its
  blocks on ``/readyz`` and ``/v1/config``, its ``autoscaler_`` families
  on ``/metrics``); ``off`` constructs nothing.

The router imports no torch: ``python -m deconv_api_tpu_torch
fleet-router`` boots without the model stack.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import logging
import os
import re
import time
import urllib.parse
from bisect import bisect_left
from collections import OrderedDict, deque
from typing import Callable

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import durable
from deconv_api_tpu_torch.serving import faults as faults_mod
from deconv_api_tpu_torch.serving.alerts import (
    AlertEngine,
    IncidentStore,
    parse_alert_rules,
)
from deconv_api_tpu_torch.serving.batcher import CircuitBreaker
from deconv_api_tpu_torch.serving.cache import canonical_digest
from deconv_api_tpu_torch.serving.http import HttpServer, Request, Response
from deconv_api_tpu_torch.serving.metrics import (
    Metrics,
    escape_label,
    parse_slos,
    slo_prometheus,
)
from deconv_api_tpu_torch.serving.trace import (
    RID_RE,
    FlightRecorder,
    RequestTrace,
    assemble_timeline,
    debug_query_args,
)
from deconv_api_tpu_torch.serving.tsdb import KIND_GAUGE, Tsdb, flatten_snapshot
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.fleet")

# backend address grammar: host:port, host a sane DNS token — the same
# shape the x-peer-fill hint is validated against on the backend side
# (serving/app.py), so a hint can never smuggle a URL or a header
BACKEND_RE = re.compile(r"^[A-Za-z0-9_.\-]+:\d{1,5}$")

# Ceiling on a member's advertised capacity: vnode count per
# member is vnodes * capacity, so an unbounded registration could bloat
# the ring to millions of points.  1024 hosts behind one coordinator is
# past any real pod; anything larger is a typo or an attack.
MAX_MEMBER_CAPACITY = 1024

# Hop-by-hop / recomputed headers never forwarded in either direction.
_HOP_HEADERS = frozenset(
    ("connection", "content-length", "transfer-encoding", "keep-alive",
     "host", "upgrade", "te", "trailer", "proxy-connection")
)

# Everything stripped from CLIENT headers before a forward: hop-by-hop
# plus the two router-authoritative trust headers (precomputed once so
# the hot path does one frozenset lookup per key).
_FWD_STRIP = _HOP_HEADERS | frozenset(("x-peer-fill", "x-trace-hop"))


def _splice_worker_label(text: str, worker: int) -> str:
    """Splice ``worker="N"`` into every sample line of a Prometheus
    exposition (SO_REUSEPORT routers): same head-of-block
    insertion as the federation splice in ``_metrics_fleet`` — no
    existing label value is crossed, so it is escape-safe."""
    label = f'worker="{worker}"'
    out: list[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        metric, _, rest = line.partition(" ")
        if "{" in metric:
            mname, _, tail = metric.partition("{")
            out.append(f"{mname}{{{label},{tail} {rest}")
        else:
            out.append(f"{metric}{{{label}}} {rest}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def _connection_nominated(headers: dict[str, str]) -> frozenset | set:
    """RFC 9110 §7.6.1: headers NOMINATED by a
    ``connection`` header are hop-by-hop too and must be stripped by an
    intermediary.  The always-``connection: close`` dial-per-forward
    transport masked this; keep-alive upstreams do not."""
    nominated = headers.get("connection")
    if not nominated:
        return _HOP_HEADERS
    return _HOP_HEADERS | {
        t.strip().lower() for t in nominated.split(",") if t.strip()
    }

# How long a moved key keeps its previous-owner hint after a rebalance:
# past this, the new owner has either filled (peer or compute) or the
# entry was cold anyway — a stale hint only costs a pointless peer miss.
PEER_FILL_WINDOW_S = 60.0

# /v1/jobs/{id}[/sub] entity traffic follows the JOB, not the ring: the
# durable job subsystem is per-backend state, so a poll or
# cancel routed by ring walk lands on a backend that never heard of the
# id.  The router pins each id to the backend that answered its submit.
_JOBS_ENTITY_RE = re.compile(r"^/v1/jobs/([A-Za-z0-9_\-]+)(/[A-Za-z0-9_\-/]*)?$")
_JOB_OWNERS_MAX = 4096

# router_backend_state gauge values, one line per backend.  ``slow``
# is IN the ring for placement but demoted for picks — a
# gray-failed member keeps its keyspace assignment while traffic routes
# around it, so recovery restores affinity with zero rebalance.
_STATE_GAUGE = {
    "healthy": 0, "joining": 1, "ejected": 2, "draining": 3, "slow": 4,
}

# Explicit cap on the rebalance `seen`-set (the attacker-chosen-
# cardinality rule the QoS tier applies to tenants — unbounded
# unique keys must never grow router memory; a clipped key double-counts
# at worst, and the clip itself is counted).
MOVED_SEEN_MAX = 4096

# Route families for the router's latency histogram + SLO labels
#: req.path is attacker-chosen and job paths embed ids, so
# the label vocabulary is a CLOSED map — bounded cardinality by
# construction (the QoS tenant rule, applied to metric labels).
_ROUTE_FAMILIES = frozenset(
    (
        "/", "/v1/deconv", "/v1/dream", "/v1/jobs", "/v1/models",
        "/v1/config", "/v1/metrics", "/metrics", "/healthz", "/readyz",
    )
)


def _route_family(path: str) -> str:
    if path in _ROUTE_FAMILIES:
        return path
    if path.startswith("/v1/jobs/"):
        return "/v1/jobs/{id}"
    return "other"


class LatencyDigest:
    """Bounded sliding-window latency sample in MILLISECONDS.

    One per backend (head latency of every buffered forward + every
    probe RTT) plus one fleet-wide instance (the hedge-delay source).
    Samples older than ``window_s`` age out, so a recovered backend's
    p95 converges to its new reality within one window — the digest is
    a rate-of-now, not a lifetime average.  ``cap`` bounds memory and
    the per-quantile sort (512 floats, microseconds to sort, consulted
    once per probe tick per member — not per request).

    Single-consumer by contract: the router event loop feeds and reads
    it; no lock."""

    def __init__(
        self,
        window_s: float = 30.0,
        cap: int = 512,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = float(window_s)
        self.cap = max(8, int(cap))
        self._clock = clock
        self._samples: deque[tuple[float, float]] = deque()

    def _prune(self, now: float) -> None:
        cut = now - self.window_s
        while self._samples and self._samples[0][0] < cut:
            self._samples.popleft()

    def add(self, ms: float) -> None:
        now = self._clock()
        self._samples.append((now, float(ms)))
        while len(self._samples) > self.cap:
            self._samples.popleft()
        self._prune(now)

    def clear(self) -> None:
        self._samples.clear()

    def __len__(self) -> int:
        self._prune(self._clock())
        return len(self._samples)

    def quantile(self, q: float) -> float:
        """q-quantile of the live window in ms; 0.0 when empty."""
        self._prune(self._clock())
        if not self._samples:
            return 0.0
        vals = sorted(v for _t, v in self._samples)
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    def snapshot(self) -> dict:
        self._prune(self._clock())
        if not self._samples:
            return {"n": 0, "p50_ms": 0.0, "p95_ms": 0.0}
        vals = sorted(v for _t, v in self._samples)
        n = len(vals)
        return {
            "n": n,
            "p50_ms": round(vals[min(n - 1, int(0.50 * n))], 3),
            "p95_ms": round(vals[min(n - 1, int(0.95 * n))], 3),
        }


class HedgeBudget:
    """Token bucket denominated in REQUESTS.

    Every hedge-eligible request deposits ``pct/100`` tokens (capped at
    ``burst``); firing one hedge spends a whole token.  Hedges are
    therefore bounded at ~pct% of eligible traffic over any window
    longer than the burst — a fleet-wide latency storm (every backend
    slow, every request hedge-eligible past its delay) cannot double
    device load, it drains the bucket and the rest are budget-denied.
    Request-count denomination (not wall clock) keeps the bound exact
    and the arithmetic deterministic for tests."""

    def __init__(self, pct: float = 5.0, burst: float = 8.0):
        self.pct = float(pct)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst

    def on_request(self) -> None:
        self._tokens = min(self.burst, self._tokens + self.pct / 100.0)

    def try_spend(self) -> bool:
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


class HotKeyTracker:
    """Per-key EWMA request-rate tracker + zipf-head promotion.

    Consistent hashing's pathology is the SUPER-hot key: one owner
    serves the whole head of a zipf distribution while its peers idle.
    The router already sees every keyed request, so this tracker keeps a
    decayed per-key score (each observation adds 1, the total halves
    every ``halflife_s`` — a rate-in-recent-window, cheap to update
    lazily) and promotes the top ``top_k`` keys whose score clears
    ``min_rate`` into the HOT set.  Promotion/demotion happens at
    ``recompute()`` (driven every ``recompute_every`` observations and
    by the router's probe tick, so demotion-on-cooldown needs no
    traffic on the cooled key).

    Memory is explicitly bounded (the QoS tenant-cardinality rule):
    at most ``max_entries`` tracked keys — past it the coldest half is
    dropped in one pass and ``hot_tracker_clipped_total`` counts what
    the cap clipped.  Attacker-chosen unique keys cost at most the cap.
    """

    def __init__(
        self,
        top_k: int,
        *,
        max_entries: int = 4096,
        halflife_s: float = 30.0,
        min_rate: float = 8.0,
        recompute_every: int = 64,
        clock: Callable[[], float] = time.monotonic,
        metrics: Metrics | None = None,
    ):
        self.top_k = int(top_k)
        self.max_entries = max(self.top_k, int(max_entries))
        self.halflife_s = float(halflife_s)
        self.min_rate = float(min_rate)
        self.recompute_every = max(1, int(recompute_every))
        self._clock = clock
        self._metrics = metrics
        # key -> (score at last update, last update timestamp)
        self._scores: dict[str, tuple[float, float]] = {}
        self._hot: frozenset[str] = frozenset()
        self._since_recompute = 0

    def _decayed(self, score: float, last: float, now: float) -> float:
        if now <= last:
            return score
        return score * 0.5 ** ((now - last) / self.halflife_s)

    def observe(self, key: str) -> None:
        now = self._clock()
        score, last = self._scores.get(key, (0.0, now))
        self._scores[key] = (self._decayed(score, last, now) + 1.0, now)
        if len(self._scores) > self.max_entries:
            self._clip(now)
        self._since_recompute += 1
        if self._since_recompute >= self.recompute_every:
            self.recompute()

    def _clip(self, now: float) -> None:
        """One-pass cap enforcement: keep the hottest half, count the
        rest.  Amortized — runs only when an insert crosses the cap."""
        ranked = sorted(
            self._scores.items(),
            key=lambda kv: self._decayed(kv[1][0], kv[1][1], now),
            reverse=True,
        )
        keep = max(self.top_k, self.max_entries // 2)
        clipped = len(ranked) - keep
        self._scores = dict(ranked[:keep])
        if clipped > 0 and self._metrics is not None:
            self._metrics.inc_counter("hot_tracker_clipped_total", clipped)

    def recompute(self) -> None:
        """Refresh the hot set: decay every score to now, drop entries
        that have cooled to noise, promote the top-K above the floor.
        A key whose traffic stopped decays below ``min_rate`` and is
        demoted here even if it is never observed again."""
        self._since_recompute = 0
        now = self._clock()
        live: dict[str, tuple[float, float]] = {}
        candidates: list[tuple[float, str]] = []
        for key, (score, last) in self._scores.items():
            d = self._decayed(score, last, now)
            if d < 0.05:
                continue  # stone cold: self-clean
            live[key] = (d, now)
            if d >= self.min_rate:
                candidates.append((d, key))
        self._scores = live
        candidates.sort(reverse=True)
        self._hot = frozenset(k for _d, k in candidates[: self.top_k])
        if self._metrics is not None:
            self._metrics.set_gauge("hot_keys_active", len(self._hot))

    def is_hot(self, key: str) -> bool:
        return key in self._hot

    @property
    def hot_keys(self) -> frozenset[str]:
        return self._hot


def _ring_point(data: bytes) -> int:
    """64-bit ring position — blake2b like the cache key itself, so the
    placement function has no second hash family to reason about."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Pure data structure: ``members`` in, deterministic ``owner(key)``
    out.  Rebuilt (cheap — N*vnodes points) on membership change; the
    router keeps the previous instance for rebalance accounting and
    peer-fill hints.  Placement depends only on (member name, vnode
    index, key), so two routers over the same member set agree.

    ``capacities`` (pod-scale members) weights placement: a
    member advertising capacity C gets C × vnodes virtual nodes, so a
    pod coordinator fronting N hosts owns ~N× the keyspace of a
    single-host peer.  Weighting multiplies the COUNT of a member's
    vnodes — vnode i's ring position is still ``blake2b(name#i)``, so a
    member's first ``vnodes`` points are IDENTICAL at any capacity and
    capacity changes only add/remove the tail points (minimal keyspace
    movement, same property as member join/leave)."""

    def __init__(self, members=(), vnodes: int = 64, capacities=None):
        self.vnodes = max(1, int(vnodes))
        self.members: tuple[str, ...] = tuple(sorted(set(members)))
        caps = capacities or {}
        self.capacities: dict[str, int] = {
            m: max(1, int(caps.get(m, 1))) for m in self.members
        }
        points: list[tuple[int, str]] = []
        for m in self.members:
            for i in range(self.vnodes * self.capacities[m]):
                points.append((_ring_point(f"{m}#{i}".encode()), m))
        points.sort()
        self._points = points
        self._keys = [p for p, _ in points]

    def __len__(self) -> int:
        return len(self._points)

    def owner(self, key: str) -> str | None:
        """The member owning ``key`` (a hex digest string), or None on an
        empty ring: first vnode clockwise of the key's ring position."""
        if not self._points:
            return None
        i = bisect_left(self._keys, _ring_point(key.encode()))
        if i == len(self._keys):
            i = 0  # wrap
        return self._points[i][1]

    def owners(self, key: str) -> list[str]:
        """Every member in clockwise preference order from ``key`` —
        owner first, then each next DISTINCT member.  The failover walk:
        attempt 2 after an infra failure goes to ``owners(key)[1]``."""
        if not self._points:
            return []
        start = bisect_left(self._keys, _ring_point(key.encode()))
        seen: list[str] = []
        for off in range(len(self._points)):
            m = self._points[(start + off) % len(self._points)][1]
            if m not in seen:
                seen.append(m)
                if len(seen) == len(self.members):
                    break
        return seen


class BackendMember:
    """One backend's membership state, health-gated by the breaker.

    States: ``joining`` (configured, not yet probed healthy — out of
    ring), ``healthy`` (in ring), ``draining`` (graceful leave: the
    backend itself said so via /readyz — out of ring, no breaker
    involvement, rejoins if it comes back ready), ``ejected`` (breaker
    OPEN after consecutive failures — out of ring until a half-open
    probe succeeds)."""

    def __init__(
        self,
        name: str,
        *,
        eject_threshold: int = 3,
        cooldown_s: float = 5.0,
        latency_window_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not BACKEND_RE.match(name):
            raise ValueError(
                f"backend {name!r} must be host:port (no scheme, no path)"
            )
        self.name = name
        host, _, port = name.rpartition(":")
        self.host = host
        self.port = int(port)
        if not 0 < self.port < 65536:
            raise ValueError(f"backend {name!r}: port out of range")
        self.state = "joining"
        # ejection/half-open machinery IS the device breaker: N
        # consecutive failures open it (leave ring), cooldown, allow()
        # claims one probe, success closes it (rejoin).  metrics=None —
        # the router publishes its own labeled gauge per backend.
        self.breaker = CircuitBreaker(
            eject_threshold, cooldown_s, clock=clock
        )
        self.requests_total = 0
        # the backend itself said "I am going away NOW"
        # (POST /v1/internal/register action=drain, or the membership
        # file's drain flag) — authoritative and faster than the next
        # probe tick, so round-robin AND the jobs collection fan-out
        # skip it immediately.  Cleared when it re-registers or a probe
        # that STARTED after the announcement answers healthy (the
        # timestamp guards against an in-flight stale 200).
        self.announced_drain = False
        self.drain_announced_at = 0.0
        # until when an announced drain's listener is still up (the
        # grace the announcement named; 0 = gone now): a peer-fill
        # source until then
        self.drain_fill_until = 0.0
        # windowed latency samples (ms) and
        # the slow-state bookkeeping — when the member entered ``slow``
        # (the min-hold anchor).  ``latency`` is the combined surface
        # digest (/readyz, /v1/config, gauges); judgment uses the two
        # CHANNEL digests so forwards (compute + queue wait) are only
        # ever compared against peers' forwards and probe RTTs against
        # probe RTTs — a busy member must not look like an outlier
        # against an idle peer's probe-dominated window.
        self.latency = LatencyDigest(latency_window_s, clock=clock)
        self.fwd_latency = LatencyDigest(latency_window_s, clock=clock)
        self.probe_latency = LatencyDigest(latency_window_s, clock=clock)
        self.slow_since = 0.0
        # how many hosts' worth of devices
        # this member fronts (a pod coordinator registers capacity=N).
        # The ring grants vnodes proportionally; 1 = the classic member.
        self.capacity = 1

    @property
    def in_ring(self) -> bool:
        # ``slow`` keeps its RING placement (so the keyspace assignment
        # — and with it cache affinity on recovery — never moves); picks
        # demote it instead.
        return self.state in ("healthy", "slow")


class _BackendError(Exception):
    """Infra-level forward failure: connect refused/reset, timeout, torn
    response.  The ONLY failure kind that retries on the next owner and
    feeds the ejection breaker from the forward path."""


class _HedgeExhausted(_BackendError):
    """Both sides of a hedged forward infra-failed.  The
    hedge helper has ALREADY noted both failures and extended ``tried``
    — the caller's normal _BackendError bookkeeping must not run again
    or the breaker would double-count one wire failure."""


def _grace_s(form: dict) -> float:
    """The ``grace_s`` of a drain announcement: seconds its listener
    stays up, clamped to [0, 3600]; 0 when absent or malformed."""
    try:
        g = float(form.get("grace_s") or 0.0)
    except ValueError:
        return 0.0
    return min(3600.0, g) if g > 0 else 0.0


def _swallow_task_result(t: asyncio.Task) -> None:
    """Done-callback for cancelled hedge losers: retrieve the result so
    the event loop never logs an un-retrieved exception."""
    if not t.cancelled():
        t.exception()


def _is_timeout(e: _BackendError) -> bool:
    return isinstance(e.__cause__, (asyncio.TimeoutError, TimeoutError))


async def _read_all(chunks) -> bytes:
    parts = []
    async for c in chunks:
        parts.append(c)
    return b"".join(parts)


def _build_request_head(
    method: str,
    target: str,
    host: str,
    port: int,
    headers: dict[str, str],
    body: bytes,
) -> str:
    """The one place the fleet's request dialect is spelled out, shared
    by the buffered and streaming clients so they cannot diverge."""
    head = f"{method} {target} HTTP/1.1\r\n"
    hdrs = {"host": f"{host}:{port}", "connection": "close", **headers}
    if body or method not in ("GET", "HEAD", "DELETE"):
        hdrs["content-length"] = str(len(body))
    return head + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())


async def raw_request(
    host: str,
    port: int,
    method: str,
    target: str,
    headers: dict[str, str],
    body: bytes,
    timeout_s: float,
) -> tuple[int, dict[str, str], bytes]:
    """One HTTP/1.1 request over a fresh connection, response read to
    EOF (``connection: close`` is always sent).  Shared by the router's
    forward/probe paths and the backend's peer-fill client
    (serving/app.py), so the fleet speaks exactly one dialect.

    Raises ``_BackendError`` on any infra failure; HTTP-level errors
    (4xx/5xx) return normally — they are the backend SPEAKING, not the
    backend being gone."""
    head = _build_request_head(method, target, host, port, headers, body)

    async def _roundtrip() -> bytes:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(head.encode() + b"\r\n" + body)
            await writer.drain()
            return await reader.read()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    try:
        raw = await asyncio.wait_for(_roundtrip(), timeout_s)
    except (OSError, asyncio.TimeoutError, TimeoutError) as e:
        raise _BackendError(f"{host}:{port}: {type(e).__name__}: {e}") from e
    if b"\r\n\r\n" not in raw:
        raise _BackendError(f"{host}:{port}: torn response ({len(raw)}B)")
    head_raw, _, payload = raw.partition(b"\r\n\r\n")
    status, resp_headers = _parse_response_head(head_raw, f"{host}:{port}")
    # A graceful FIN mid-body looks exactly like EOF; without this check
    # a truncated 200 would be forwarded (and, on the peer-fill path,
    # CACHED) as if complete.
    cl = resp_headers.get("content-length")
    if cl is not None and cl.isdigit():
        want = int(cl)
        if len(payload) < want:
            raise _BackendError(
                f"{host}:{port}: truncated body "
                f"({len(payload)}B of content-length {want})"
            )
        payload = payload[:want]
    return status, resp_headers, payload


def _parse_response_head(
    head_raw: bytes, who: str
) -> tuple[int, dict[str, str]]:
    lines = head_raw.decode("latin-1").split("\r\n")
    try:
        status = int(lines[0].split(" ", 2)[1])
    except (IndexError, ValueError) as e:
        raise _BackendError(f"{who}: bad status line {lines[0]!r}") from e
    resp_headers: dict[str, str] = {}
    for line in lines[1:]:
        k, sep, v = line.partition(":")
        if sep:
            resp_headers[k.strip().lower()] = v.strip()
    return status, resp_headers


async def raw_request_stream(
    host: str,
    port: int,
    method: str,
    target: str,
    headers: dict[str, str],
    body: bytes,
    head_timeout_s: float,
) -> tuple[int, dict[str, str], object]:
    """Like ``raw_request`` but progressive: the payload comes back as
    an async chunk iterator instead of a buffered read-to-EOF.  Only the
    HEAD (status line + headers) is bounded by ``head_timeout_s`` — the
    body is an open pipe, because its one caller is the jobs SSE surface
    where a healthy stream lives exactly
    as long as the job it narrates; clamping it under the forward
    timeout would both break progressiveness and misread a long job as
    backend death.  The caller owns the iterator: exhaust it or
    ``aclose()`` it (the router's serve loop does either), both release
    the connection."""
    head = _build_request_head(method, target, host, port, headers, body)
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError as e:
        raise _BackendError(f"{host}:{port}: {type(e).__name__}: {e}") from e

    async def _close() -> None:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass

    try:
        writer.write(head.encode() + b"\r\n" + body)
        await writer.drain()
        head_raw = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), head_timeout_s
        )
        status, resp_headers = _parse_response_head(
            head_raw[:-4], f"{host}:{port}"
        )
    except _BackendError:
        await _close()
        raise
    except (
        OSError,
        asyncio.TimeoutError,
        TimeoutError,
        asyncio.IncompleteReadError,
        asyncio.LimitOverrunError,
    ) as e:
        await _close()
        raise _BackendError(f"{host}:{port}: {type(e).__name__}: {e}") from e

    async def _chunks():
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    return
                yield chunk
        finally:
            await _close()

    return status, resp_headers, _chunks()


# Scripted-transport seam: dozens of fleet tests monkeypatch
# ``fleet.raw_request`` with a per-backend response script.  The pooled
# fast path honors that contract by checking whether the module global
# still IS the real implementation — a patched transport wins over the
# pool, so every pre-pool test (and the loopback drills' fault scripts)
# keeps intercepting the wire exactly as before.
_DIAL_RAW_REQUEST = raw_request
_DIAL_RAW_REQUEST_STREAM = raw_request_stream


class _PoolConn:
    """One pooled keep-alive socket.  ``reused`` marks a checkout that
    came from the idle list — the only kind whose immediate EOF/reset is
    a keep-alive race (the backend reaped the idle socket between our
    checkout and our write) rather than a backend failure."""

    __slots__ = ("reader", "writer", "reused", "idle_since")

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.reused = False
        self.idle_since = 0.0


class BackendPool:
    """Bounded keep-alive HTTP/1.1 connection pool for ONE backend.

    Replaces dial-per-forward: checkout prefers the warmest idle socket
    (LIFO), dials when the idle list is empty, and enforces framed reads
    (head + exact content-length) instead of read-to-EOF so the socket
    survives the response.  Responses without a content-length, with
    ``transfer-encoding``, or carrying ``connection: close`` are drained
    to EOF and the socket destroyed — correctness first, reuse second.

    Staleness contract: a REUSED socket that dies before yielding a
    single response byte is retried exactly once on a freshly dialed
    connection (``pool_stale_retry_total``); a fresh socket's failure,
    or any failure after response bytes arrived, is a real
    ``_BackendError``.  Cancellation mid-roundtrip (a hedge loser)
    destroys the socket — a connection with an unread response on it
    must never return to the pool.

    Accounting: ``pool_{dial,reuse,stale_retry}_total`` counters,
    ``pool_{idle,in_use}{backend=}`` gauges, and dial wall time into
    ``connect_seconds_total{backend=}`` — the probe-RTT honesty metric
    (pooled probes no longer pay connect time, so it is surfaced
    separately instead of silently vanishing from the digests)."""

    def __init__(
        self,
        name: str,
        host: str,
        port: int,
        *,
        size: int = 8,
        idle_max_s: float = 30.0,
        metrics: Metrics | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.host = host
        self.port = port
        self.size = max(1, int(size))
        self.idle_max_s = float(idle_max_s)
        self._metrics = metrics
        self._clock = clock
        self._idle: deque[_PoolConn] = deque()
        self.in_use = 0
        self.dials = 0
        self.reuses = 0
        self.stale_retries = 0
        # pre-serialized per-backend header template (fast path):
        # host + connection are constants of the backend, so
        # they are encoded once; per-request fields are appended.
        self._head_base = (
            f"host: {host}:{port}\r\nconnection: keep-alive\r\n"
        ).encode("latin-1")

    # ------------------------------------------------------------ lifecycle

    def _publish(self) -> None:
        if self._metrics is not None:
            self._metrics.set_labeled_gauge(
                "pool_idle", "backend", self.name, len(self._idle)
            )
            self._metrics.set_labeled_gauge(
                "pool_in_use", "backend", self.name, self.in_use
            )

    @staticmethod
    def _close(c: _PoolConn) -> None:
        try:
            c.writer.close()
        except Exception:  # noqa: BLE001 — close is best-effort cleanup
            pass

    async def _dial(self) -> _PoolConn:
        t0 = time.perf_counter()
        reader, writer = await asyncio.open_connection(self.host, self.port)
        self.dials += 1
        if self._metrics is not None:
            self._metrics.inc_counter("pool_dial_total")
            self._metrics.inc_labeled(
                "connect_seconds_total", "backend", self.name,
                time.perf_counter() - t0,
            )
        return _PoolConn(reader, writer)

    async def checkout(self, *, fresh: bool = False) -> _PoolConn:
        """Pop the most-recently-parked idle socket (skipping reaped or
        half-closed ones), else dial.  ``fresh=True`` bypasses the idle
        list — the stale-retry leg must not draw a second possibly-dead
        socket from the same era."""
        now = self._clock()
        while not fresh and self._idle:
            c = self._idle.pop()
            if (
                (self.idle_max_s > 0 and now - c.idle_since > self.idle_max_s)
                or c.reader.at_eof()
                or c.writer.is_closing()
            ):
                self._close(c)
                continue
            c.reused = True
            self.reuses += 1
            if self._metrics is not None:
                self._metrics.inc_counter("pool_reuse_total")
            self.in_use += 1
            self._publish()
            return c
        c = await self._dial()
        self.in_use += 1
        self._publish()
        return c

    def release(self, c: _PoolConn) -> None:
        """Return a socket whose response was fully consumed."""
        self.in_use -= 1
        if (
            len(self._idle) >= self.size
            or c.reader.at_eof()
            or c.writer.is_closing()
        ):
            self._close(c)
        else:
            c.reused = False
            c.idle_since = self._clock()
            self._idle.append(c)
        self._publish()

    def destroy(self, c: _PoolConn) -> None:
        """Drop a socket that failed, was cancelled mid-roundtrip, or
        carries unread response bytes.  Never back to the pool."""
        self.in_use -= 1
        self._close(c)
        self._publish()

    def flush(self) -> None:
        """Close every idle socket (breaker open / ejection / drain /
        router stop): a member leaving the ring must not leave warm
        sockets behind that would be reused against its next life."""
        while self._idle:
            self._close(self._idle.pop())
        self._publish()

    def reap(self) -> None:
        """Idle reap, run on the probe tick: sockets parked longer than
        ``idle_max_s`` are closed oldest-first (the backend side reaps
        at its own idle timeout — reaping ours first keeps the stale-
        retry path an edge case instead of the steady state)."""
        if self.idle_max_s <= 0:
            return
        now = self._clock()
        while self._idle and now - self._idle[0].idle_since > self.idle_max_s:
            self._close(self._idle.popleft())
        self._publish()

    # ------------------------------------------------------------ requests

    def build_wire(
        self, method: str, target: str, headers: dict[str, str], body: bytes
    ) -> bytes:
        """Request head from the pre-serialized template + per-request
        fields.  Same dialect as ``_build_request_head`` except the
        keep-alive connection token — the one divergence the pool is."""
        parts = [
            f"{method} {target} HTTP/1.1\r\n".encode("latin-1"),
            self._head_base,
        ]
        append = parts.append
        for k, v in headers.items():
            append(f"{k}: {v}\r\n".encode("latin-1"))
        if body or method not in ("GET", "HEAD", "DELETE"):
            append(b"content-length: %d\r\n" % len(body))
        append(b"\r\n")
        if body:
            append(body)
        return b"".join(parts)

    async def _roundtrip(
        self, c: _PoolConn, wire: bytes
    ) -> tuple[int, dict[str, str], bytes, bool]:
        """Write + framed read on one socket.  Returns ``(status,
        headers, payload, reusable)``; raises the raw transport error
        (classified by the caller, which owns stale-retry)."""
        c.writer.write(wire)
        await c.writer.drain()
        head_raw = await c.reader.readuntil(b"\r\n\r\n")
        status, resp_headers = _parse_response_head(head_raw[:-4], self.name)
        cl = resp_headers.get("content-length")
        if (
            cl is not None
            and cl.isdigit()
            and "chunked"
            not in resp_headers.get("transfer-encoding", "").lower()
        ):
            want = int(cl)
            try:
                payload = await c.reader.readexactly(want) if want else b""
            except asyncio.IncompleteReadError as e:
                raise _BackendError(
                    f"{self.name}: truncated body "
                    f"({len(e.partial)}B of content-length {want})"
                ) from e
            reusable = (
                resp_headers.get("connection", "keep-alive").lower()
                != "close"
            )
            return status, resp_headers, payload, reusable
        # unknown length (streamed / legacy close-framed response): the
        # socket is spent — read to EOF and let the caller destroy it
        payload = await c.reader.read()
        return status, resp_headers, payload, False

    async def request(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        timeout_s: float,
    ) -> tuple[int, dict[str, str], bytes]:
        """Pooled equivalent of ``raw_request``: same signature shape,
        same ``_BackendError`` classification (cause chains preserved so
        ``_is_timeout`` still reads deadline-capped legs as 504s), plus
        the stale-retry-once contract."""
        wire = self.build_wire(method, target, headers, body)
        deadline = time.perf_counter() + timeout_s
        for attempt in (0, 1):
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                try:
                    raise asyncio.TimeoutError()
                except asyncio.TimeoutError as e:
                    raise _BackendError(
                        f"{self.name}: TimeoutError: pooled budget spent"
                    ) from e
            try:
                c = await asyncio.wait_for(
                    self.checkout(fresh=attempt == 1), remaining
                )
            except (OSError, asyncio.TimeoutError, TimeoutError) as e:
                raise _BackendError(
                    f"{self.name}: {type(e).__name__}: {e}"
                ) from e
            try:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise asyncio.TimeoutError()
                status, resp_headers, payload, reusable = (
                    await asyncio.wait_for(
                        self._roundtrip(c, wire), remaining
                    )
                )
            except BaseException as e:  # noqa: BLE001 — single destroy point
                self.destroy(c)
                if isinstance(e, asyncio.CancelledError):
                    # hedge-loser cancellation: socket destroyed above,
                    # never leaked; the cancellation itself propagates
                    raise
                if isinstance(e, _BackendError):
                    raise
                if (
                    attempt == 0
                    and c.reused
                    and isinstance(
                        e,
                        (
                            ConnectionResetError,
                            BrokenPipeError,
                            asyncio.IncompleteReadError,
                        ),
                    )
                    and not getattr(e, "partial", b"")
                ):
                    # keep-alive race: the backend reaped this socket
                    # while it was parked.  Retry once, dialed fresh.
                    self.stale_retries += 1
                    if self._metrics is not None:
                        self._metrics.inc_counter("pool_stale_retry_total")
                    continue
                if isinstance(
                    e,
                    (
                        OSError,
                        asyncio.TimeoutError,
                        TimeoutError,
                        asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError,
                    ),
                ):
                    raise _BackendError(
                        f"{self.name}: {type(e).__name__}: {e}"
                    ) from e
                raise
            (self.release if reusable else self.destroy)(c)
            return status, resp_headers, payload
        raise _BackendError(f"{self.name}: stale retry exhausted")

    async def request_stream(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        head_timeout_s: float,
    ) -> tuple[int, dict[str, str], object]:
        """Pooled equivalent of ``raw_request_stream``: HEAD bounded by
        ``head_timeout_s`` (stale-retry-once applies), body handed back
        as an async chunk iterator.  Content-length-framed bodies read
        exactly that many bytes and RETURN the socket to the pool;
        unframed bodies (SSE) stream to EOF on a spent socket.  The
        caller owns the iterator — exhaust or ``aclose()`` it."""
        wire = self.build_wire(method, target, headers, body)
        for attempt in (0, 1):
            try:
                c = await asyncio.wait_for(
                    self.checkout(fresh=attempt == 1), head_timeout_s
                )
            except (OSError, asyncio.TimeoutError, TimeoutError) as e:
                raise _BackendError(
                    f"{self.name}: {type(e).__name__}: {e}"
                ) from e
            try:
                c.writer.write(wire)
                await c.writer.drain()
                head_raw = await asyncio.wait_for(
                    c.reader.readuntil(b"\r\n\r\n"), head_timeout_s
                )
            except BaseException as e:  # noqa: BLE001 — single destroy point
                self.destroy(c)
                if isinstance(e, (asyncio.CancelledError, _BackendError)):
                    raise
                if (
                    attempt == 0
                    and c.reused
                    and isinstance(
                        e,
                        (
                            ConnectionResetError,
                            BrokenPipeError,
                            asyncio.IncompleteReadError,
                        ),
                    )
                    and not getattr(e, "partial", b"")
                ):
                    self.stale_retries += 1
                    if self._metrics is not None:
                        self._metrics.inc_counter("pool_stale_retry_total")
                    continue
                if isinstance(
                    e,
                    (
                        OSError,
                        asyncio.TimeoutError,
                        TimeoutError,
                        asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError,
                    ),
                ):
                    raise _BackendError(
                        f"{self.name}: {type(e).__name__}: {e}"
                    ) from e
                raise
            status, resp_headers = _parse_response_head(
                head_raw[:-4], self.name
            )
            cl = resp_headers.get("content-length")
            framed = (
                cl is not None
                and cl.isdigit()
                and "chunked"
                not in resp_headers.get("transfer-encoding", "").lower()
            )
            reusable = framed and (
                resp_headers.get("connection", "keep-alive").lower()
                != "close"
            )
            pool = self

            async def _chunks(want=int(cl) if framed else -1, conn=c):
                done = False
                try:
                    if want >= 0:
                        left = want
                        while left > 0:
                            chunk = await conn.reader.read(min(65536, left))
                            if not chunk:
                                raise _BackendError(
                                    f"{pool.name}: truncated body "
                                    f"({want - left}B short of "
                                    f"content-length {want})"
                                )
                            left -= len(chunk)
                            yield chunk
                        done = True
                    else:
                        while True:
                            chunk = await conn.reader.read(65536)
                            if not chunk:
                                done = True
                                return
                            yield chunk
                finally:
                    if done and reusable:
                        pool.release(conn)
                    else:
                        pool.destroy(conn)

            return status, resp_headers, _chunks()
        raise _BackendError(f"{self.name}: stale retry exhausted")


class FleetRouter:
    """The routing tier: one of these per router process (or embedded in
    a drill).  ``start()`` binds the listener and launches the prober;
    ``stop()`` drains and shuts both down."""

    def __init__(
        self,
        backends: list[str] | tuple[str, ...] = (),
        *,
        vnodes: int = 64,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 2.0,
        eject_threshold: int = 3,
        cooldown_s: float = 5.0,
        peer_fill: bool = True,
        forward_timeout_s: float = 330.0,
        idle_timeout_s: float = 30.0,
        body_timeout_s: float = 20.0,
        max_connections: int = 1024,
        membership_file: str = "",
        fleet_token: str = "",
        hot_key_top_k: int = 0,
        hot_key_replicas: int = 2,
        hot_key_min_rate: float = 8.0,
        tail_tolerance: bool = True,
        slow_eject_k: float = 4.0,
        slow_restore_k: float = 2.0,
        slow_min_samples: int = 20,
        slow_hold_s: float = 10.0,
        slow_floor_ms: float = 25.0,
        slow_canary_every: int = 64,
        latency_window_s: float = 30.0,
        hedge_budget_pct: float = 5.0,
        hedge_min_delay_ms: float = 30.0,
        fault_injection: bool = False,
        faults_spec: str = "",
        fault_seed: int = 0,
        trace_ring: int = 256,
        trace_slow_ms: float = 100.0,
        trace_sample: float = 1.0,
        slos: str = "",
        connection_pool: bool = True,
        pool_size: int = 8,
        pool_idle_s: float = 30.0,
        stream_relay_min_bytes: int = 262144,
        autoscale: str = "off",
        autoscale_opts: dict | None = None,
        tsdb: str = "off",
        tsdb_interval_s: float = 1.0,
        alerts: str = "",
        incidents_dir: str = "",
        incidents_retention_s: float = 86400.0,
        worker: int | None = None,
        metrics: Metrics | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not backends and not membership_file and not fleet_token:
            # with neither a shared membership view nor self-registration
            # there is no way for a backend to ever appear
            raise ValueError(
                "fleet router needs at least one backend (or a "
                "--membership-file / --fleet-token so backends can join)"
            )
        if autoscale not in ("off", "advisory", "enforce"):
            raise ValueError(
                f"autoscale={autoscale!r}: expected off|advisory|enforce"
            )
        self.vnodes = int(vnodes)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.eject_threshold = int(eject_threshold)
        self.cooldown_s = float(cooldown_s)
        self.peer_fill = bool(peer_fill)
        self.forward_timeout_s = float(forward_timeout_s)
        self.membership_file = membership_file
        self.fleet_token = fleet_token
        self.hot_key_replicas = max(1, int(hot_key_replicas))
        self._clock = clock
        self.metrics = metrics or Metrics(prefix="router", core=False)
        # data-plane fast path: per-backend keep-alive pools
        # (created lazily — members join at runtime), the zero-copy
        # relay threshold, and the multi-process worker ordinal whose
        # ``worker=`` label keeps the federation sums truthful
        # when N SO_REUSEPORT routers share one scrape port.
        # connection_pool=False is the escape hatch: dial-per-forward,
        # byte-identical to the pre-pool dialect.
        self.connection_pool = bool(connection_pool)
        self.pool_size = max(1, int(pool_size))
        self.pool_idle_s = float(pool_idle_s)
        self.stream_relay_min_bytes = int(stream_relay_min_bytes)
        self.worker = worker
        self.pools: dict[str, BackendPool] = {}
        # Pre-register the new counter families at zero so the
        # exposition carries them from the first scrape — a counter
        # that never fired (e.g. stale_retry on a quiet pool, or a
        # torn relay that never happened) must still be visible to
        # the lint and to rate() queries.
        if self.connection_pool:
            for fam in ("pool_dial_total", "pool_reuse_total",
                        "pool_stale_retry_total"):
                self.metrics.inc_counter(fam, 0)
        for fam in ("relayed_responses_total", "relay_bytes_total",
                    "relay_torn_total"):
            self.metrics.inc_counter(fam, 0)
        # Router flight recorder: the SAME RequestTrace/
        # FlightRecorder spine the backend runs, recording the router's
        # side of every request — ring pick, each forward attempt
        # (backend-attributed, hedge legs as siblings), failover hops,
        # peer-fill hints, deadline-at-router expiry.  trace_ring=0 is
        # the same escape hatch: no recorder, no RequestTrace object,
        # zero per-request state.
        self.trace_slow_ms = float(trace_slow_ms)
        self.trace_sample = float(trace_sample)
        self.recorder = (
            FlightRecorder(
                trace_ring, slow_ms=trace_slow_ms, sample=trace_sample
            )
            if int(trace_ring) > 0
            else None
        )
        self.trace_ring = int(trace_ring)
        # Router-side latency SLOs: fed by every terminal
        # response path, route-scoped by the closed _route_family map —
        # which is also the scope vocabulary a --slo route must name
        # (a typo'd route is a boot error, not a 0.0-burn dead object)
        self.slos = parse_slos(
            slos,
            observable_routes=frozenset(
                (*_ROUTE_FAMILIES, "/v1/jobs/{id}", "other")
            ),
        )
        # last successful per-member /v1/metrics scrape, for the
        # federation endpoint: (monotonic ts, exposition text).  A
        # member that stops answering re-exports its LAST-GOOD text
        # with the staleness gauge climbing — a vanished family reads
        # as a counter reset to every downstream rate() otherwise.
        self._scrape_cache: dict[str, tuple[float, str]] = {}
        # OFF pins topology and routing
        # byte-identical to a router without it (the escape hatch the
        # hot-key-replication precedent set) — no digests fed, no slow
        # transitions, no hedges.
        self.tail_tolerance = bool(tail_tolerance)
        self.slow_eject_k = max(1.0, float(slow_eject_k))
        self.slow_restore_k = min(
            self.slow_eject_k, max(1.0, float(slow_restore_k))
        )
        self.slow_min_samples = max(2, int(slow_min_samples))
        # the probe CHANNEL's floor must be reachable by probes alone
        # (window/interval samples per window): an idle fleet detects
        # network-level grays on this channel, and a demoted member —
        # round-robin skips it, canaries are 1/64 — is fed mostly by
        # probes, so this is also its guaranteed restore-evidence
        # channel.  A floor above the supply would strand it in `slow`
        # forever.
        probe_cap = int(
            float(latency_window_s) / max(float(probe_interval_s), 1e-3)
        )
        self._min_probe_samples = max(
            2, min(self.slow_min_samples, probe_cap - 1)
        )
        self.slow_hold_s = max(0.0, float(slow_hold_s))
        self.slow_floor_ms = max(0.0, float(slow_floor_ms))
        # restore evidence for DEVICE-level gray failures: a demoted
        # member's probes may be fast (the slowness lives behind its
        # dispatch, not on the wire), so without fresh forward samples
        # it would restore sick and flap.  Every Nth demoted keyed pick
        # is a CANARY that still goes to the slow primary (unhedged, so
        # the observation is real) — bounded honest tail cost, honest
        # recovery signal.  0 disables.
        self.slow_canary_every = max(0, int(slow_canary_every))
        self._canary = 0
        self.latency_window_s = float(latency_window_s)
        self.hedge_min_delay_ms = max(1.0, float(hedge_min_delay_ms))
        # fleet-wide digest: the hedge delay's p95 source (union of
        # every member's samples, so one slow member RAISES the delay —
        # hedging backs off exactly when the fleet can least afford
        # duplicate work)
        self._fleet_latency = LatencyDigest(latency_window_s, clock=clock)
        self.hedge_budget: HedgeBudget | None = (
            HedgeBudget(hedge_budget_pct)
            if self.tail_tolerance and hedge_budget_pct > 0
            else None
        )
        # epoch stamp folded into the replica-list cache key: a slow
        # transition changes which owners a hot key may spread over
        self._slow_epoch = 0
        # router-side network-fault registry: owned DIRECTLY
        # (never module-installed) so an in-process drill can arm
        # fleet.* sites here and device.* sites on the backends' global
        # hook without cross-talk.
        self.faults: faults_mod.FaultRegistry | None = None
        if fault_injection or faults_spec:
            self.faults = faults_mod.FaultRegistry(
                seed=fault_seed, metrics=self.metrics
            )
            if faults_spec:
                self.faults.arm_string(faults_spec)
        self._fault_injection = bool(fault_injection)
        # zipf-head replication: 0 = off (every key has ONE
        # owner, the classic topology — the default)
        self.hot_keys: HotKeyTracker | None = (
            HotKeyTracker(
                hot_key_top_k,
                min_rate=hot_key_min_rate,
                clock=clock,
                metrics=self.metrics,
            )
            if hot_key_top_k > 0
            else None
        )
        self._hot_rr = 0  # replica round-robin cursor for hot-key reads
        # hot keys are the HIGHEST-QPS keys, so their replica list must
        # not cost a full owners() ring walk per request (the walk the
        # normal path reserves for retries): cached per (ring, hot-set)
        # epoch — at most top_k entries, flushed on rebuild/recompute
        self._replica_cache: dict[str, list[str]] = {}
        self._replica_cache_epoch: tuple = ()
        self.members: dict[str, BackendMember] = {}
        # where each member was learned from: static | file | announce
        self._member_source: dict[str, str] = {}
        for name in backends:
            if name in self.members:
                raise ValueError(f"duplicate backend {name!r}")
            self.members[name] = BackendMember(
                name,
                eject_threshold=eject_threshold,
                cooldown_s=cooldown_s,
                latency_window_s=latency_window_s,
                clock=clock,
            )
            self._member_source[name] = "static"
        self.ring = HashRing((), vnodes)
        # previous topology, for rebalance accounting + peer-fill hints
        self._prev_ring: HashRing | None = None
        self._prev_ring_at = 0.0
        # keys already counted against router_rebalanced_keys_total for
        # the CURRENT topology (bounded: oldest forgotten first — a
        # forgotten key double-counts at worst, it never grows state)
        self._moved_seen: OrderedDict[str, None] = OrderedDict()
        # job-id -> backend name, learned from 202 Locations and entity
        # polls (bounded LRU: a forgotten id degrades to the fan-out
        # walk in _proxy_job, never to an error)
        self._job_owners: OrderedDict[str, str] = OrderedDict()
        self._rr = 0  # round-robin cursor for non-keyed traffic
        self.draining = False
        self._probe_task: asyncio.Task | None = None
        self.bound: tuple[str, int] | None = None
        self._mf_mtime_ns = -1  # membership-file watch state
        # FAIL-LOUD durable surface: a registration whose
        # membership persist cannot be made durable answers 503, never
        # a 200 the fleet would forget across a crash
        self._membership_surface = durable.Surface(
            "fleet.membership", metrics=self.metrics
        )
        if membership_file:
            # boot sweep of OUR .tmp half only — the membership file
            # lives in a shared, operator-provided directory
            durable.sweep_tmp_file(membership_file)
        # drains announced for members THIS router never knew (the
        # announcement raced ahead of the registration relay): carried
        # into the membership file so peers that DO know them converge.
        # Bounded; token-authenticated callers only.
        self._foreign_drains: OrderedDict[str, None] = OrderedDict()
        # the fleet's memory: router-side retention/alerting
        # plane over the SAME registry the federation scrape reads.
        # tsdb=off (and no rules) is the escape hatch — no objects, no
        # task, no routes; the router stays byte-identical to a
        # router without it.  A non-empty rule spec implies the TSDB: a
        # rule without history would be a dead object.
        if tsdb not in ("off", "on"):
            raise ValueError(f"tsdb={tsdb!r}: expected off|on")
        if float(tsdb_interval_s) <= 0:
            raise ValueError("tsdb_interval_s must be > 0")
        self.tsdb: Tsdb | None = None
        self.alert_engine: AlertEngine | None = None
        self.incidents: IncidentStore | None = None
        self._tsdb_task: asyncio.Task | None = None
        self.tsdb_interval_s = float(tsdb_interval_s)
        if tsdb == "on" or alerts:
            self.tsdb = Tsdb(self.tsdb_interval_s, clock=clock)
            try:
                rules = parse_alert_rules(
                    alerts,
                    known_slos=frozenset(t.name for t in self.slos),
                )
            except ValueError as e:
                raise ValueError(f"invalid alerts spec: {e}") from e
            if rules:
                self.alert_engine = AlertEngine(
                    rules, self.tsdb, slos=self.slos, clock=clock
                )
            if incidents_dir:
                self.incidents = IncidentStore(
                    incidents_dir,
                    retention_s=float(incidents_retention_s),
                    metrics=self.metrics,
                )
        # closed-loop elasticity: off is the escape hatch — no
        # controller object, no arrival recording, no config/readyz
        # block, no metric families
        if autoscale == "off":
            self.autoscaler = None
        else:
            from deconv_api_tpu_torch.serving.autoscale import (
                AutoscaleController,
            )

            self.autoscaler = AutoscaleController(
                mode=autoscale,
                router=self,
                fleet_token=fleet_token,
                faults=self.faults,
                clock=clock,
                # with the TSDB on, the forecaster reads per-tenant
                # arrivals back from the history plane an operator
                # queries, instead of a private accumulator
                tsdb=self.tsdb,
                tsdb_metrics=self.metrics,
                **(autoscale_opts or {}),
            )

        self.server = HttpServer(
            idle_timeout_s=idle_timeout_s,
            body_timeout_s=body_timeout_s,
            max_connections=max_connections,
        )
        self.server.route("GET", "/healthz")(self._healthz)
        self.server.route("GET", "/readyz")(self._readyz)
        self.server.route("GET", "/v1/config")(self._config)
        self.server.route("GET", "/metrics")(self._metrics_route)
        self.server.route("GET", "/v1/metrics")(self._metrics_route)
        # fleet observability surfaces.  NOTE the first two
        # exact routes SHADOW proxying of those paths (the
        # /v1/debug/faults precedent): the router's own flight recorder
        # answers /v1/debug/requests — query a BACKEND's recorder by
        # asking it directly, or let /v1/debug/trace/{id} join both
        # sides for you.
        self.server.route("GET", "/v1/debug/requests")(
            self._debug_requests
        )
        self.server.route_prefix("GET", "/v1/debug/trace/")(
            self._debug_trace
        )
        self.server.route("GET", "/v1/metrics/fleet")(self._metrics_fleet)
        if self.tsdb is not None:
            # the fleet's memory.  Exact routes SHADOW
            # proxying of these paths (the /v1/debug/requests
            # precedent): the router answers with its OWN history and
            # alerts plus a per-backend federation block — ask a member
            # directly for its raw surface.
            self.server.route("GET", "/v1/metrics/history")(
                self._metrics_history
            )
            self.server.route("GET", "/v1/alerts")(self._alerts_route)
            if self.incidents is not None:
                self.server.route("GET", "/v1/debug/incidents")(
                    self._debug_incidents
                )
        if self.fleet_token:
            # self-registration surface: ONLY with a shared
            # token configured — a tokenless router keeps the whole
            # /v1/internal/ prefix as a 404
            self.server.route("POST", "/v1/internal/register")(
                self._register
            )
        if self._fault_injection:
            # router-side fault arming surface — only with
            # --fault-injection, matching the backend's contract.  Note
            # the exact route SHADOWS proxying of this one path: arm a
            # BACKEND's sites by POSTing to the backend directly.
            self.server.route("POST", "/v1/debug/faults")(
                self._debug_faults
            )
        for method in ("GET", "POST", "DELETE", "PUT"):
            # everything else proxies; exact routes above win
            self.server.route_prefix(method, "/")(self._proxy)
        # a pre-existing membership file seeds the view at boot (new
        # router joining a running fleet: same file => same members =>
        # same ring once probes admit them)
        self._load_membership_file()
        for m in self.members.values():
            self._publish_state(m)
        self._publish_membership_sources()

    @property
    def walk_timeout_s(self) -> float:
        """Per-member bound for blind fan-out hops (the job-entity walk
        and the fleet collection view): a wedged member that accepts TCP
        but never answers must cost seconds, not the full forward
        timeout (330s default) per hop."""
        return min(
            self.forward_timeout_s, max(10.0, 2 * self.probe_timeout_s)
        )

    # ------------------------------------------------------------ membership

    def _publish_state(self, m: BackendMember) -> None:
        self.metrics.set_labeled_gauge(
            "backend_state", "backend", m.name, _STATE_GAUGE[m.state]
        )
        self.metrics.set_labeled_gauge(
            "member_capacity", "backend", m.name, m.capacity
        )
        self.metrics.set_gauge(
            "backends_in_ring",
            sum(1 for b in self.members.values() if b.in_ring),
        )

    def _publish_membership_sources(self) -> None:
        counts = {"static": 0, "file": 0, "announce": 0}
        for src in self._member_source.values():
            counts[src] = counts.get(src, 0) + 1
        for kind, n in counts.items():
            self.metrics.set_labeled_gauge(
                "membership_source", "kind", kind, n
            )

    def _add_member(self, name: str, source: str) -> BackendMember:
        """Dynamic membership: a member learned at runtime —
        self-registration or the shared membership file.  It starts
        ``joining`` and enters the ring only after its first healthy
        probe, exactly like a static one."""
        m = BackendMember(
            name,
            eject_threshold=self.eject_threshold,
            cooldown_s=self.cooldown_s,
            latency_window_s=self.latency_window_s,
            clock=self._clock,
        )
        self.members[name] = m
        self._member_source[name] = source
        slog.event(
            _log, "member_added", level=logging.WARNING,
            backend=name, source=source,
        )
        self._publish_state(m)
        self._publish_membership_sources()
        return m

    def _mark_announced_drain(
        self, m: BackendMember, reason: str, grace_s: float = 0.0
    ) -> None:
        """A drain the backend ANNOUNCED (directly or relayed through
        the membership file): authoritative — leave the ring now, and
        the jobs fan-out walks stop asking it now.  No breaker state
        accrues (the graceful-leave rule from the probe path).
        ``grace_s`` is how long the announcement said its listener
        stays up."""
        if m.announced_drain:
            return
        m.announced_drain = True
        m.drain_announced_at = self._clock()
        m.drain_fill_until = m.drain_announced_at + grace_s
        m.breaker.record_success()
        self._set_state(m, "draining", reason)
        # _set_state no-ops when the probe already saw the readyz flip;
        # the flag above is the part that must land either way

    def _clear_announced_drain(self, m: BackendMember, reason: str) -> None:
        if not m.announced_drain:
            return
        m.announced_drain = False
        slog.event(
            _log, "drain_cleared", level=logging.WARNING,
            backend=m.name, reason=reason,
        )

    # ---------------------------------------------------- self-registration

    async def _register(self, req: Request) -> Response:
        """POST /v1/internal/register — backend self-registration.
        Authenticated by the shared fleet token; form fields
        ``backend=host:port`` and ``action=register|drain``.
        Register adds an unknown member in ``joining`` (the ring
        admission stays probe-gated) and clears an announced drain on a
        known one; drain marks the member gone NOW.  Either action
        persists the shared membership file so peer routers converge on
        their next watch tick.

        ``capacity=N`` (optional, default 1) weights ring
        placement: a pod coordinator fronting N hosts registers the
        whole pod's capacity and the ring grants it N x vnodes.  A
        re-registration with a DIFFERENT capacity (a pod degrading to
        capacity=1 after follower loss) rebuilds the ring immediately —
        the registration is authoritative, same rule as clear_drain.

        ``grace_s=S`` on a drain (optional; the JAX package's backends
        never send it) says the backend keeps its listener up for S more
        seconds: until then the router still hints peer fills at it
        (``_peer_hint``), so its keyspace moves as bytes, not
        recomputes."""
        token = req.headers.get("x-fleet-token", "")
        if not self.fleet_token or not hmac.compare_digest(
            token, self.fleet_token
        ):
            slog.event(
                _log, "register_rejected", level=logging.WARNING,
                reason="bad_token",
            )
            return Response.json(
                {"error": "bad_fleet_token", "request_id": req.id}, 403
            )
        try:
            form = req.form()
        except Exception:  # noqa: BLE001 — unparseable body
            form = {}
        name = (form.get("backend") or "").strip()
        action = (form.get("action") or "register").strip()
        if not BACKEND_RE.match(name):
            return Response.json(
                {
                    "error": "bad_request",
                    "message": "backend must be host:port",
                    "request_id": req.id,
                },
                400,
            )
        if action not in ("register", "drain"):
            return Response.json(
                {
                    "error": "bad_request",
                    "message": "action must be register|drain",
                    "request_id": req.id,
                },
                400,
            )
        raw_cap = (form.get("capacity") or "").strip()
        capacity = None
        if raw_cap:
            try:
                capacity = int(raw_cap)
            except ValueError:
                capacity = -1
            if not 1 <= capacity <= MAX_MEMBER_CAPACITY:
                return Response.json(
                    {
                        "error": "bad_request",
                        "message": (
                            "capacity must be an integer in "
                            f"[1, {MAX_MEMBER_CAPACITY}]"
                        ),
                        "request_id": req.id,
                    },
                    400,
                )
        m = self.members.get(name)
        cleared = None
        if action == "register":
            self._foreign_drains.pop(name, None)
            if m is None:
                m = self._add_member(name, source="announce")
            else:
                self._clear_announced_drain(m, "re_registered")
            if capacity is not None and capacity != m.capacity:
                was = m.capacity
                m.capacity = capacity
                slog.event(
                    _log, "member_capacity", level=logging.WARNING,
                    backend=name, capacity=capacity, was=was,
                )
                self._publish_state(m)
                self._rebuild_ring("capacity_changed")
            cleared = name  # a register is the one signal that may
            # DOWNGRADE a persisted draining flag to false
        else:
            if m is None:
                # a drain for a member we never knew (the announcement
                # raced ahead of the registration relay): record it so
                # the membership file still carries the signal to peers
                # that DO know it, but add nothing to our own view
                slog.event(
                    _log, "drain_unknown_member", level=logging.WARNING,
                    backend=name,
                )
                self._foreign_drains[name] = None
                while len(self._foreign_drains) > 1024:
                    self._foreign_drains.popitem(last=False)
                if not self._persist_membership():
                    return self._undurable_register(req)
                return Response.json(
                    {"ok": False, "known": False, "request_id": req.id}
                )
            self._mark_announced_drain(
                m, "self_announced", grace_s=_grace_s(form)
            )
        if not self._persist_membership(clear_drain=cleared):
            # fail-loud contract: a 200 would acknowledge a
            # membership change the fleet cannot remember across a crash
            return self._undurable_register(req)
        return Response.json(
            {
                "ok": True,
                "backend": name,
                "action": action,
                "state": m.state,
                "request_id": req.id,
            }
        )

    @staticmethod
    def _undurable_register(req: Request) -> Response:
        resp = Response.json(
            {
                "error": "undurable_write",
                "message": "membership persist failed; retry",
                "request_id": req.id,
            },
            503,
        )
        resp.headers["retry-after"] = "1"
        return resp

    # ------------------------------------------------------ membership file

    def _load_membership_file(self) -> None:
        """Converge on the shared membership view: mtime-poll
        the file every probe tick; new members join (probe-gated, source
        ``file``), drain flags relay announced drains, a cleared flag
        relays a re-registration.  Members are never REMOVED by the file
        — a dead one is ejected by its own probes, and keeping it costs
        one probe per tick."""
        path = self.membership_file
        if not path:
            return
        try:
            st = os.stat(path)
        except OSError:
            return  # not written yet
        if st.st_mtime_ns == self._mf_mtime_ns:
            return
        self._mf_mtime_ns = st.st_mtime_ns
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.loads(f.read())
        except (OSError, ValueError) as e:
            slog.event(
                _log, "membership_file_error", level=logging.ERROR,
                path=path, error=f"{type(e).__name__}: {e}",
            )
            return
        if isinstance(doc, dict):
            v = doc.get("version", 1)
            if isinstance(v, int) and v > 1:
                # fail-static: a file written by a NEWER
                # binary is ignored, never misparsed — and never
                # rewritten by our older merge (see _persist_membership)
                slog.event(
                    _log, "membership_file_error", level=logging.ERROR,
                    path=path, error=f"future membership version {v}",
                )
                return
        members = doc.get("members") if isinstance(doc, dict) else None
        if not isinstance(members, dict):
            slog.event(
                _log, "membership_file_error", level=logging.ERROR,
                path=path, error="no members object",
            )
            return
        for name, info in members.items():
            if not isinstance(name, str) or not BACKEND_RE.match(name):
                continue
            m = self.members.get(name)
            if m is None:
                m = self._add_member(name, source="file")
            draining = isinstance(info, dict) and bool(info.get("draining"))
            if draining:
                self._mark_announced_drain(m, "membership_file")
            else:
                self._clear_announced_drain(m, "membership_file")
            # capacity relays like the drain flag: the router that took
            # the registration wrote it; peers converge here
            cap = info.get("capacity", 1) if isinstance(info, dict) else 1
            if (
                isinstance(cap, int)
                and 1 <= cap <= MAX_MEMBER_CAPACITY
                and cap != m.capacity
            ):
                m.capacity = cap
                slog.event(
                    _log, "member_capacity", level=logging.WARNING,
                    backend=name, capacity=cap, was=None, source="file",
                )
                self._publish_state(m)
                self._rebuild_ring("capacity_file")

    def _persist_membership(self, clear_drain: str | None = None) -> bool:
        """Write the shared membership view through
        ``durable.atomic_write`` (tmp + fsync + rename + dir
        fsync — peers never observe a torn file), under an exclusive
        flock on a sidecar lockfile so two router PROCESSES persisting
        concurrently serialize their read-merge-write instead of
        erasing each other's registrations.

        Merge rules: membership only GROWS here (a dead member is a
        probe-ejection concern, not a file edit); a ``draining`` flag is
        sticky — it merges as (file OR own view OR foreign announce), so
        a router that never saw the direct announcement cannot overwrite
        a peer's fresher drain with its own stale false.  The ONE signal
        allowed to downgrade the flag is an explicit re-registration
        (``clear_drain`` names the member), because only the restarted
        backend itself knows the drain is over.

        Returns whether the write is durable.  FAIL-LOUD surface: the
        error is counted and the degraded gauge flips here; callers on
        the request path (``_register``) turn False into a 503 +
        Retry-After, periodic callers log-and-continue."""
        path = self.membership_file
        if not path:
            return True
        try:
            import fcntl

            lock = open(path + ".lock", "a")
        except OSError:
            lock = None
        try:
            if lock is not None:
                try:
                    fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
                except OSError:
                    pass
            merged: dict[str, dict] = {}
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.loads(f.read())
                cur_v = doc.get("version", 1) if isinstance(doc, dict) else 1
                if isinstance(cur_v, int) and cur_v > 1:
                    # fail-static: never rewrite (and so destroy) a
                    # NEWER binary's membership document
                    slog.event(
                        _log, "membership_file_error", level=logging.ERROR,
                        path=path,
                        error=f"future membership version {cur_v}",
                    )
                    return False
                current = doc.get("members", {}) if isinstance(doc, dict) else {}
                if isinstance(current, dict):
                    for name, info in current.items():
                        if isinstance(name, str) and BACKEND_RE.match(name):
                            cap = (
                                info.get("capacity", 1)
                                if isinstance(info, dict)
                                else 1
                            )
                            if not (
                                isinstance(cap, int)
                                and 1 <= cap <= MAX_MEMBER_CAPACITY
                            ):
                                cap = 1
                            merged[name] = {
                                "draining": bool(
                                    isinstance(info, dict)
                                    and info.get("draining")
                                ),
                                "capacity": cap,
                            }
            except (OSError, ValueError):
                pass
            for m in self.members.values():
                flag = merged.get(m.name, {}).get("draining", False)
                # our member view is authoritative for capacity — it came
                # from a direct registration or an earlier file relay
                merged[m.name] = {
                    "draining": flag or m.announced_drain,
                    "capacity": m.capacity,
                }
            for name in self._foreign_drains:
                if name in merged:
                    merged[name]["draining"] = True
            if clear_drain is not None and clear_drain in merged:
                merged[clear_drain]["draining"] = False
            # JSON-document artifact: {format, version} ride in-document
            data = json.dumps(
                {
                    "format": "fleet.membership",
                    "version": 1,
                    "members": merged,
                },
                separators=(",", ":"),
            ).encode()
            try:
                durable.atomic_write(
                    path, data, surface=self._membership_surface
                )
                # inside the lock no peer write can interleave, so this
                # mtime is OUR content — safe to skip on the next watch
                self._mf_mtime_ns = os.stat(path).st_mtime_ns
            except durable.DurableWriteError as e:
                slog.event(
                    _log, "membership_file_error", level=logging.ERROR,
                    path=path, error=f"{type(e).__name__}: {e}",
                )
                return False
            return True
        finally:
            if lock is not None:
                lock.close()  # closing drops the flock

    def _set_state(self, m: BackendMember, state: str, reason: str) -> None:
        if m.state == state:
            return
        old = m.state
        m.state = state
        if old == "slow" or state == "slow":
            # the hot-key replica lists filter slow members; their cache
            # must not serve a list computed under the old slow set
            self._slow_epoch += 1
        if state not in ("healthy", "slow"):
            # leaving the ring: the window's samples describe a life
            # that ended (pre-crash, pre-drain) — a rejoin starts with
            # empty digests and earns its way past the min-sample
            # floors before it can be judged slow again
            m.latency.clear()
            m.fwd_latency.clear()
            m.probe_latency.clear()
            # ...and its warm sockets describe the same ended life: an
            # ejection/drain flushes the member's pool so nothing is
            # reused against its next incarnation
            pool = self.pools.get(m.name)
            if pool is not None:
                pool.flush()
        slog.event(
            _log, "backend_state", level=logging.WARNING,
            backend=m.name, state=state, was=old, reason=reason,
        )
        self._publish_state(m)
        self._rebuild_ring(reason)

    def _rebuild_ring(self, reason: str) -> None:
        live = [n for n, m in self.members.items() if m.in_ring]
        caps = {n: self.members[n].capacity for n in live}
        if (
            tuple(sorted(live)) == self.ring.members
            and caps == self.ring.capacities
        ):
            return
        # keep the old topology around: rebalance accounting and the
        # peer-fill hints both ask "who owned this key BEFORE the move".
        # Only once the ring has SERVED something, though — a cold
        # boot's staggered admissions ({} -> {b1} -> {b1,b2} -> ...)
        # would otherwise count ~1/N of the keyspace as "rebalanced" on
        # every clean start and hint peer fills at members that cannot
        # hold anything yet (a guaranteed-404 internal round trip per
        # moved key).
        if self.ring.members and any(
            m.requests_total for m in self.members.values()
        ):
            self._prev_ring = self.ring
            self._prev_ring_at = self._clock()
        self._moved_seen.clear()
        self.ring = HashRing(live, self.vnodes, capacities=caps)
        slog.event(
            _log, "ring_rebalance", level=logging.WARNING,
            members=sorted(live), vnodes=self.vnodes, reason=reason,
            capacities={n: c for n, c in sorted(caps.items()) if c != 1},
        )

    def _observe_latency(
        self, m: BackendMember, ms: float, probe: bool = False
    ) -> None:
        """Feed one head-latency/RTT sample (ms) into the member's
        digests: the combined surface digest always, plus
        the sample's CHANNEL digest — probes and forwards are judged
        separately, because a forward carries compute + queue wait and
        a probe RTT carries neither; mixing them would demote a busy
        member against an idle peer's ~1ms probe window.  The
        fleet-wide hedge-delay digest takes forwards only: probe RTTs
        would collapse the "fleet p95" to ~1ms on any lightly loaded
        fleet and fire hedges at perfectly healthy compute requests.
        Inert with tail tolerance off — the escape hatch leaves zero
        new state."""
        if not self.tail_tolerance:
            return
        m.latency.add(ms)
        if probe:
            m.probe_latency.add(ms)
        else:
            m.fwd_latency.add(ms)
            self._fleet_latency.add(ms)

    def _note_forward_result(
        self,
        m: BackendMember,
        ok: bool,
        latency_ms: float | None = None,
    ) -> None:
        """Passive health: forward outcomes feed the same breaker the
        probes do, so a dead backend is ejected by its own traffic
        between probe ticks.  Outcomes carry their HEAD
        latency too (``latency_ms``; None for failures and stream
        heads) — the gray-failure digest rides the same call."""
        if latency_ms is not None:
            self._observe_latency(m, latency_ms)
        if ok:
            m.breaker.record_success()
            if (
                m.state == "ejected"
                and m.breaker.state == CircuitBreaker.CLOSED
            ):
                # a live forward answered while ejected AND the breaker
                # actually closed (it was half-open: this success was
                # the probe).  record_success is a deliberate no-op in
                # OPEN — a straggler that dispatched before the
                # ejection must not flap a dead backend back into the
                # ring with zero failure tolerance; the half-open
                # probe path owns that re-admission.
                self._set_state(m, "healthy", "forward_ok")
            return
        m.breaker.record_failure()
        if m.breaker.state == CircuitBreaker.OPEN and m.state != "ejected":
            self._set_state(m, "ejected", "consecutive_forward_failures")

    # ------------------------------------------------------ transport

    def _pool_for(self, m: BackendMember) -> BackendPool:
        pool = self.pools.get(m.name)
        if pool is None:
            pool = self.pools[m.name] = BackendPool(
                m.name, m.host, m.port,
                size=self.pool_size,
                idle_max_s=self.pool_idle_s,
                metrics=self.metrics,
                clock=self._clock,
            )
        return pool

    async def _backend_request(
        self,
        m: BackendMember,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        timeout_s: float,
    ) -> tuple[int, dict[str, str], bytes]:
        """``raw_request`` + the router-side ``fleet.*`` network-fault
        sites, consulted with ``who=<backend name>`` so a
        spec's ``@host:port`` target grays exactly one path.  The sites
        model the failures the backend-side device sites cannot: they
        hit PROBES too (this wrapper is the probe transport), so a
        blackholed backend ejects by probe while a late-head one stays
        probe-200 and is caught only by the latency digest — the gray
        case the digests exist for."""
        reg = self.faults
        if reg is not None:
            if reg.check("fleet.blackhole", who=m.name) is not None:
                # accepts the connection, never answers: indistinguishable
                # from a wedged peer — burn the caller's timeout honestly
                await asyncio.sleep(timeout_s)
                raise _BackendError(f"{m.name}: blackhole (injected)")
            act = reg.check("fleet.connect_delay_ms", who=m.name)
            if act is not None:
                delay = min((act.param or 100.0) / 1e3, timeout_s)
                await asyncio.sleep(delay)
                timeout_s = max(0.001, timeout_s - delay)
        if self.connection_pool and raw_request is _DIAL_RAW_REQUEST:
            # pooled keep-alive roundtrip.  A
            # monkeypatched ``fleet.raw_request`` (the test suites'
            # scripted transports) takes the dial branch below instead
            # — the pool must never hide a scripted wire.
            status, resp_headers, payload = await self._pool_for(
                m
            ).request(method, target, headers, body, timeout_s)
        else:
            status, resp_headers, payload = await raw_request(
                m.host, m.port, method, target, headers, body, timeout_s
            )
        if reg is not None:
            act = reg.check("fleet.head_delay_ms", who=m.name)
            if act is not None:
                await asyncio.sleep((act.param or 100.0) / 1e3)
            act = reg.check("fleet.body_trickle", who=m.name)
            if act is not None:
                # trickle scales with payload size: param ms per 64 KiB,
                # so big result bodies hurt and probe bodies barely do —
                # the asymmetric NIC-sickness shape
                chunks = max(1, (len(payload) + 65535) // 65536)
                await asyncio.sleep((act.param or 20.0) / 1e3 * chunks)
            if reg.check("fleet.torn_body", who=m.name) is not None:
                raise _BackendError(f"{m.name}: torn body (injected)")
        return status, resp_headers, payload

    async def _backend_request_stream(
        self,
        m: BackendMember,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        head_timeout_s: float,
    ) -> tuple[int, dict[str, str], object]:
        """Streaming sibling of ``_backend_request``: the
        same ``fleet.*`` fault sites, applied where a stream actually
        has them — blackhole/connect_delay before the wire, head_delay
        after the head, and the BODY faults (trickle, torn) riding the
        chunk iterator so a torn body tears MID-RELAY, which is the
        failure shape a streamed response really has."""
        reg = self.faults
        if reg is not None:
            if reg.check("fleet.blackhole", who=m.name) is not None:
                await asyncio.sleep(head_timeout_s)
                raise _BackendError(f"{m.name}: blackhole (injected)")
            act = reg.check("fleet.connect_delay_ms", who=m.name)
            if act is not None:
                delay = min((act.param or 100.0) / 1e3, head_timeout_s)
                await asyncio.sleep(delay)
                head_timeout_s = max(0.001, head_timeout_s - delay)
        if (
            self.connection_pool
            and raw_request_stream is _DIAL_RAW_REQUEST_STREAM
        ):
            status, resp_headers, chunks = await self._pool_for(
                m
            ).request_stream(method, target, headers, body, head_timeout_s)
        else:
            status, resp_headers, chunks = await raw_request_stream(
                m.host, m.port, method, target, headers, body,
                head_timeout_s,
            )
        if reg is not None:
            act = reg.check("fleet.head_delay_ms", who=m.name)
            if act is not None:
                await asyncio.sleep((act.param or 100.0) / 1e3)
            trickle = reg.check("fleet.body_trickle", who=m.name)
            torn = reg.check("fleet.torn_body", who=m.name)
            if trickle is not None or torn is not None:
                chunks = self._faulted_chunks(m, chunks, trickle, torn)
        return status, resp_headers, chunks

    @staticmethod
    async def _faulted_chunks(m, chunks, trickle, torn):
        n = 0
        try:
            async for chunk in chunks:
                if trickle is not None:
                    per = max(1, (len(chunk) + 65535) // 65536)
                    await asyncio.sleep((trickle.param or 20.0) / 1e3 * per)
                if torn is not None and n >= 1:
                    raise _BackendError(f"{m.name}: torn body (injected)")
                n += 1
                yield chunk
            if torn is not None and n <= 1:
                # a one-chunk (or empty) body still tears — the site
                # must fire regardless of how the backend chunked it
                raise _BackendError(f"{m.name}: torn body (injected)")
        finally:
            aclose = getattr(chunks, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:  # noqa: BLE001 — cleanup must not mask
                    pass

    async def _forward_maybe_relay(
        self,
        m: BackendMember,
        req: Request,
        target: str,
        fwd_headers: dict[str, str],
        timeout_s: float,
    ) -> tuple[int, dict[str, str], bytes, object | None]:
        """Non-hedged forward with the zero-copy relay engaged: the
        head is bounded by ``timeout_s`` exactly as before; a
        200 whose content-length is at or above
        ``stream_relay_min_bytes`` returns ``(status, headers, b"",
        chunk-iterator)`` and is piped upstream→client with
        backpressure instead of buffered to completion.  Small bodies,
        error statuses and unframed responses buffer — byte-identical
        to ``_backend_request``.  Scripted transports (a monkeypatched
        ``raw_request``) and the relay-off knob take the buffered path
        wholesale."""
        if (
            self.stream_relay_min_bytes <= 0
            or raw_request is not _DIAL_RAW_REQUEST
        ):
            s, h, b = await self._backend_request(
                m, req.method, target, fwd_headers, req.body, timeout_s
            )
            return s, h, b, None
        status, headers, chunks = await self._backend_request_stream(
            m, req.method, target, fwd_headers, req.body, timeout_s
        )
        cl = headers.get("content-length", "")
        if (
            status == 200
            and cl.isdigit()
            and int(cl) >= self.stream_relay_min_bytes
        ):
            return status, headers, b"", chunks
        try:
            body = await asyncio.wait_for(_read_all(chunks), timeout_s)
        except (asyncio.TimeoutError, TimeoutError) as te:
            await chunks.aclose()
            raise _BackendError(f"{m.name}: stalled body") from te
        return status, headers, body, None

    def _update_slow_states(self) -> None:
        """Gray-failure outlier ejection, run every probe
        tick: a member whose windowed p95 exceeds ``slow_eject_k`` x the
        median of its PEERS' p95s is demoted to ``slow``; one back under
        ``slow_restore_k`` x (after ``slow_hold_s``) is restored.

        Comparison is PER CHANNEL — a member's forward p95 against its
        peers' forward p95s (device-level grays under traffic), its
        probe-RTT p95 against their probe p95s (network-level grays,
        idle fleets) — with forwards preferred when both sides qualify.
        A skewed workload therefore cannot demote the merely-busy
        member: its 80ms compute forwards are never held against an
        idle peer's 1ms probe window (the probe channel, where both
        sides are symmetric, shows no outlier).

        Peer-median (self excluded) rather than fleet-median: with the
        member's own inflated tail inside the reference, a 2-member
        fleet could never trip (slow > k x (slow+fast)/2 has no
        solution past k=2), and a uniformly slow fleet (overload, not
        gray failure) compares ~1x everywhere and ejects nobody —
        exactly right, routing around EVERYONE routes to no one.  The
        same safety shows up as an explicit valve: the last non-slow
        member can never be demoted.  Flap control is three-layered:
        the min-sample floors (a trickle can't convict on 3 points; the
        probe channel's floor is clamped to the probe supply so a
        demoted member always stays judgeable), the absolute
        ``slow_floor_ms`` (sub-ms jitter ratios are noise, not
        signal), and enter/exit hysteresis with a ``slow_hold_s``
        min-hold."""
        if not self.tail_tolerance:
            return
        now = self._clock()
        cands = [m for m in self.members.values() if m.in_ring]
        fwd95: dict[str, float] = {}
        prb95: dict[str, float] = {}
        for m in self.members.values():
            # per-backend latency gauges: the operator's "who is slow"
            # surface (combined channels), published for EVERY member
            # every tick — an emptied/cleared window reads 0, never a
            # frozen pre-crash value an alerting rule would mistake
            # for a live one
            snap = m.latency.snapshot()
            self.metrics.set_labeled_gauge(
                "backend_latency_p50_ms", "backend", m.name,
                snap["p50_ms"],
            )
            self.metrics.set_labeled_gauge(
                "backend_latency_p95_ms", "backend", m.name,
                snap["p95_ms"],
            )
            if not m.in_ring:
                continue
            fs = m.fwd_latency.snapshot()
            if fs["n"] >= self.slow_min_samples:
                fwd95[m.name] = fs["p95_ms"]
            ps = m.probe_latency.snapshot()
            if ps["n"] >= self._min_probe_samples:
                prb95[m.name] = ps["p95_ms"]
        for m in cands:
            if m.state == "healthy":
                mine = ref = None
                for chan in (fwd95, prb95):
                    if m.name in chan:
                        others = sorted(
                            v for n, v in chan.items() if n != m.name
                        )
                        if others:
                            mine = chan[m.name]
                            ref = max(others[len(others) // 2], 0.001)
                            break
                if mine is None:
                    continue  # no peer comparison -> no conviction
                if (
                    mine > self.slow_eject_k * ref
                    and mine > self.slow_floor_ms
                ):
                    fast = [
                        c for c in cands
                        if c.state == "healthy" and c is not m
                    ]
                    if not fast:
                        continue  # never demote the last fast member
                    m.slow_since = now
                    self.metrics.inc_labeled(
                        "slow_ejections_total", "backend", m.name
                    )
                    self._set_state(
                        m, "slow",
                        f"p95 {mine:.1f}ms > {self.slow_eject_k:g}x "
                        f"peer median {ref:.1f}ms",
                    )
            elif m.state == "slow":
                # restore gates on the window MAX per channel, not p95:
                # a demoted member's window is mostly fast probe RTTs,
                # and one sick 150ms canary among 25 sub-ms probes
                # dilutes right past a p95 check — max cannot be
                # diluted, and a single canary forward counts however
                # few there are.  Each channel's evidence is held to
                # ITS OWN peer bar (a canary forward carries compute +
                # queue wait and must be judged against peers'
                # forwards, never against a ~1ms probe reference) and
                # floored by the same absolute slow_floor_ms as
                # conviction — a max that could never convict must not
                # block restoration.  A channel with NO peer reference
                # is skipped, exactly as conviction skips it: judging
                # a canary's legitimate 60ms compute against the bare
                # absolute floor would pin a recovered member forever.
                # When no channel offers a comparison at all (solo
                # survivor, degenerate cadence), the member restores
                # once the hold elapses — demotion without any peer to
                # route to is meaningless, and conviction was equally
                # impossible.  Cost of the max: one honest blip delays
                # restore by at most one window.
                if now - m.slow_since < self.slow_hold_s:
                    continue
                clean = True
                worst_seen = 0.0
                for digest, chan in (
                    (m.fwd_latency, fwd95),
                    (m.probe_latency, prb95),
                ):
                    if len(digest) == 0:
                        continue
                    others = sorted(
                        v for n, v in chan.items() if n != m.name
                    )
                    if not others:
                        continue  # no peer reference on this channel
                    bar = max(
                        self.slow_restore_k
                        * others[len(others) // 2],
                        self.slow_floor_ms,
                    )
                    worst = digest.quantile(1.0)
                    worst_seen = max(worst_seen, worst)
                    if worst >= bar:
                        clean = False
                if clean:
                    self._set_state(
                        m, "healthy",
                        f"window max {worst_seen:.1f}ms back under the "
                        f"{self.slow_restore_k:g}x per-channel peer bars",
                    )

    def _hedge_delay_s(self) -> float | None:
        """The hedge trigger: fire the duplicate once the primary has
        been out longer than the live fleet p95 (floored at
        ``hedge_min_delay_ms``).  None until the fleet digest has
        enough samples to mean anything — a cold router must not hedge
        on a delay it invented."""
        if not self.tail_tolerance or self.hedge_budget is None:
            return None
        if len(self._fleet_latency) < self.slow_min_samples:
            return None
        p95 = self._fleet_latency.quantile(0.95)
        return max(self.hedge_min_delay_ms, p95) / 1e3

    def _hedge_candidate(
        self, key: str | None, primary: BackendMember
    ) -> BackendMember | None:
        """Where the duplicate goes: the next DISTINCT ring owner for
        keyed traffic, the next live member for round-robin GETs —
        never the primary again, never a slow member (hedging INTO the
        outlier defeats the point)."""
        if key is not None:
            for name in self.ring.owners(key):
                if name == primary.name:
                    continue
                c = self.members[name]
                if c.in_ring and c.state != "slow":
                    return c
            return None
        cands = [
            m for m in self.members.values()
            if m.in_ring and m.state != "slow" and m is not primary
        ]
        if not cands:
            return None
        self._rr += 1
        return cands[self._rr % len(cands)]

    # --------------------------------------------------------------- probing

    async def probe_once(self) -> None:
        """One health sweep over every backend (the prober loop's body;
        tests drive it directly).  Also the membership-file watch tick:
        a peer router's registrations/drains converge here."""
        self._load_membership_file()
        if self.hot_keys is not None:
            # demotion-on-cooldown must not wait for traffic on the
            # cooled key: decay + re-rank on the probe cadence
            self.hot_keys.recompute()
        for pool in self.pools.values():
            # idle-reap rides the probe cadence too: a connection parked
            # past pool_idle_s is closed here rather than discovered
            # stale at checkout
            pool.reap()
        await asyncio.gather(
            *(self._probe(m) for m in list(self.members.values()))
        )
        # gray-failure evaluation rides the probe cadence:
        # probe RTTs just landed in the digests, so an IDLE fleet still
        # detects — and restores — a slow member within a few ticks
        self._update_slow_states()

    async def _probe(self, m: BackendMember) -> None:
        if m.state == "ejected":
            allowed, _retry = m.breaker.allow()
            if not allowed:
                return  # still cooling; no half-open claim available
        t_start = self._clock()
        t0 = time.perf_counter()
        try:
            status, _h, body = await self._backend_request(
                m, "GET", "/readyz", {}, b"", self.probe_timeout_s
            )
        except _BackendError as e:
            m.breaker.record_failure()
            if m.breaker.state == CircuitBreaker.OPEN:
                self._set_state(m, "ejected", f"probe: {e}")
            elif m.in_ring:
                # below threshold: stay in ring (one blip is not death)
                slog.event(
                    _log, "probe_failed", level=logging.WARNING,
                    backend=m.name, error=str(e),
                )
            return
        # the probe RTT is a latency observation for the MEMBER digest
        #: an IDLE fleet still sees a backend go gray — and,
        # just as important, sees it recover.  probe=True keeps it out
        # of the fleet-wide hedge-delay digest.
        self._observe_latency(
            m, (time.perf_counter() - t0) * 1e3, probe=True
        )
        if status == 200:
            if m.announced_drain and m.drain_announced_at >= t_start:
                # the drain announcement landed WHILE this probe was in
                # flight: its 200 observed the backend before the drain
                # and must not override the fresher authoritative signal
                return
            m.breaker.record_success()
            # a healthy probe after an announced drain means the backend
            # restarted (or withdrew the drain): the announcement is spent
            self._clear_announced_drain(m, "probe_ok")
            if m.state not in ("healthy", "slow"):
                # a 200 readmits the ejected/joining/draining — but a
                # SLOW member's probe-200 is exactly the gray-failure
                # signature; only the latency machinery restores it
                self._set_state(m, "healthy", "probe_ok")
            return
        checks = {}
        try:
            checks = json.loads(body).get("checks", {})
        except (ValueError, AttributeError):
            pass
        if checks.get("not_draining") is False:
            # graceful leave: the backend ASKED
            # to go — its keyspace rebalances with bounded movement, and
            # no breaker state accrues (it rejoins the moment a probe
            # sees 200 after the restart)
            m.breaker.record_success()
            self._set_state(m, "draining", "backend_draining")
            return
        # not ready and not draining (warmup, dead pool, open breaker):
        # a failure for ejection purposes — consecutive ones open it
        m.breaker.record_failure()
        if m.breaker.state == CircuitBreaker.OPEN:
            self._set_state(m, "ejected", f"readyz_{status}")
        elif m.in_ring:
            self._set_state(m, "joining", f"readyz_{status}")

    async def _probe_loop(self) -> None:
        while True:
            try:
                await self.probe_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — prober must survive
                slog.event(
                    _log, "probe_loop_error", level=logging.ERROR,
                    error=f"{type(e).__name__}: {e}",
                )
            await asyncio.sleep(self.probe_interval_s)

    # -------------------------------------------------------------- routing

    def _pick(
        self,
        key: str | None,
        tried: set[str],
        replicas: list[str] | None = None,
    ) -> BackendMember | None:
        """The ring owner for a keyed request (failover walks clockwise
        past ``tried``); round-robin over ring members otherwise.  A
        promoted hot key's READS (``replicas`` non-None) spread
        round-robin over its R ring owners instead of hammering the
        primary alone.

        Demotion: a ``slow`` member keeps its ring placement
        but is LAST-RESORT — keyed picks walk past it to the next fast
        owner (the caller attaches an x-peer-fill hint back at it, so
        the stand-in copies bytes instead of recomputing), round-robin
        skips it outright.  When every candidate is slow the pick falls
        back to the slow set: a uniformly slow fleet still serves."""
        if key is not None:
            if replicas and not tried:
                self._hot_rr += 1
                return self.members[
                    replicas[self._hot_rr % len(replicas)]
                ]
            if not tried:
                # hot path: one bisect; the full owners() walk (scan
                # until every distinct member is seen) is retry-only
                name = self.ring.owner(key)
                if name is None:
                    return None
                m = self.members[name]
                if m.state == "slow":
                    self._canary += 1
                    if (
                        self.slow_canary_every
                        and self._canary % self.slow_canary_every == 0
                    ):
                        # canary: the restore-evidence channel — a
                        # device-level gray's probes are FAST, so only
                        # real forwards can testify to recovery
                        self.metrics.inc_counter(
                            "slow_canary_forwards_total"
                        )
                        return m
                    # demote the gray primary: first fast owner in the
                    # clockwise walk stands in (deterministic, so the
                    # stand-in's cache warms for the whole slow window)
                    for n in self.ring.owners(key):
                        c = self.members[n]
                        if c.in_ring and c.state != "slow":
                            self.metrics.inc_counter(
                                "slow_routed_around_total"
                            )
                            return c
                return m
            cands = [
                n for n in self.ring.owners(key) if n not in tried
            ]
            for n in cands:
                if self.members[n].state != "slow":
                    return self.members[n]
            return self.members[cands[0]] if cands else None
        live = [m for m in self.members.values() if m.in_ring
                and m.name not in tried]
        fast = [m for m in live if m.state != "slow"]
        pool = fast or live
        if not pool:
            return None
        self._rr += 1
        return pool[self._rr % len(pool)]

    @staticmethod
    def _attempt_purpose(
        owner: str | None,
        m: BackendMember,
        tried: set[str],
        replicas: list[str] | None,
    ) -> str:
        """Classify a pick for the x-trace-hop stamp + attempt span,
        from the same state _pick used (``owner`` is the
        key's ring owner, computed ONCE per attempt by the caller —
        this runs on the hot proxy path): a retry walk is a
        ``failover``; a hot-key spread read off the primary is a
        ``replica``; a pick that LANDED on a slow member is a
        ``canary`` (the canary cadence or the all-slow fallback —
        either way a deliberate visit to the demoted member); a keyed
        pick standing in for a demoted owner is a ``failover``;
        everything else is the ``primary``."""
        if tried:
            return "failover"
        if replicas and m.name != replicas[0]:
            return "replica"
        if m.state == "slow":
            return "canary"
        if owner is not None and owner != m.name:
            return "failover"
        return "primary"

    def _peer_hint(self, key: str, owner: str) -> str | None:
        """Previous ring owner for a key whose placement moved in the
        last PEER_FILL_WINDOW_S — the ``x-peer-fill`` hint — and the
        rebalanced-keys accounting (each moved key counted once per
        topology)."""
        if self._prev_ring is None:
            return None
        if self._clock() - self._prev_ring_at > PEER_FILL_WINDOW_S:
            return None
        prev = self._prev_ring.owner(key)
        if prev is None or prev == owner:
            return None
        if key not in self._moved_seen:
            self._moved_seen[key] = None
            while len(self._moved_seen) > MOVED_SEEN_MAX:
                self._moved_seen.popitem(last=False)
                # the clip is visible: a clipped
                # key double-counts at worst, but an operator watching
                # this climb knows the keyspace outgrew the window
                self.metrics.inc_counter("rebalance_seen_clipped_total")
            self.metrics.inc_counter("rebalanced_keys_total")
        pm = self.members.get(prev)
        if (
            not self.peer_fill
            or pm is None
            or pm.state in ("ejected",)
            or (pm.announced_drain and self._clock() >= pm.drain_fill_until)
        ):
            # a crashed previous owner cannot serve a fill, and one that
            # ANNOUNCED drain is going away now — unless the announcement
            # named a grace still running; a probe-observed DRAINING one
            # still can (its listener lives out the grace)
            return None
        return pm.name

    def _forward_headers(
        self,
        req: Request,
        key: str | None,
        owner: str,
        hint: str | None = None,
        hop: str | None = None,
    ) -> dict[str, str]:
        # x-peer-fill and x-trace-hop are router-authoritative: a
        # client-supplied hint would point a trusting backend at an
        # arbitrary host:port, and a client-supplied hop would let it
        # forge attempt attribution in the backend's flight recorder.
        # The hop-stripped base is identical across the retry/hedge
        # attempts of one request, so it is filtered once and memoized
        # on the request; connection-nominated
        # client headers are hop-by-hop per RFC 9110 §7.6.1 and join
        # the strip set.
        base = req._fwd_base
        if base is None:
            strip = _FWD_STRIP
            nominated = req.headers.get("connection")
            if nominated:
                strip = strip | {
                    t.strip().lower()
                    for t in nominated.split(",") if t.strip()
                }
            base = req._fwd_base = [
                (k, v) for k, v in req.headers.items() if k not in strip
            ]
        fwd_headers = dict(base)
        if hop is not None:
            # cross-hop trace context: WHICH attempt this
            # forward is (ordinal:purpose) — the backend folds it into
            # its own trace so the assembled timeline can tell a
            # retry's two backend traces apart
            fwd_headers["x-trace-hop"] = hop
        # the router's id IS the fleet's id: honored inbound ids pass
        # through untouched; minted ones (absent/insane inbound) are
        # stamped here so the backend's flight recorder, the backend
        # access line, the router access line and the client response
        # all join on one key (satellite: cross-tier trace continuity)
        fwd_headers["x-request-id"] = req.id
        if key is not None:
            if hint is None:
                # an explicit hint (a hot-key replica's primary) wins
                # over the rebalance-window previous-owner hint
                hint = self._peer_hint(key, owner)
            if hint is not None:
                fwd_headers["x-peer-fill"] = hint
        return fwd_headers

    @staticmethod
    def _forward_target(req: Request) -> str:
        # req.path was percent-DECODED at parse (http.py); re-quote it
        # so decoded CR/LF/space can't break the forwarded request line
        target = urllib.parse.quote(req.path)
        if req.query:
            target += "?" + urllib.parse.urlencode(req.query)
        return target

    def _observe_route(
        self, path: str, dt_s: float, status: int
    ) -> None:
        """One histogram sample + every matching SLO tracker
        per terminal response — the router's true-p99/burn-rate source,
        labeled by the CLOSED route-family map (bounded cardinality)."""
        family = _route_family(path)
        self.metrics.observe_hist(
            "request_duration_seconds", ("route",), (family,), dt_s
        )
        for t in self.slos:
            if t.matches(family):
                t.observe(dt_s, status)

    def _record_trace(
        self,
        tr: RequestTrace | None,
        status: int,
        error: str | None = None,
        cache: str | None = None,
    ) -> None:
        if tr is None or self.recorder is None:
            return
        tr.finish(status, error=error, cache=cache)
        self.recorder.record(tr)

    def _respond(
        self,
        req: Request,
        m: BackendMember,
        status: int,
        headers: dict[str, str],
        body: bytes,
        t0: float,
        stream: object | None = None,
        trace: RequestTrace | None = None,
    ) -> Response:
        """Per-forward bookkeeping + the response the client sees (the
        success tail shared by the keyed, job-entity and fan-out paths).
        For a stream the latency recorded is head latency — the body's
        lifetime belongs to the job, not the router."""
        m.requests_total += 1
        dt = time.perf_counter() - t0
        self.metrics.inc_labeled("requests_total", "backend", m.name)
        self.metrics.observe_stage("forward", dt)
        code = errors.code_from_body(body) if status >= 400 else None
        self.metrics.observe_request(dt, code)
        self._observe_route(req.path, dt, status)
        if trace is not None:
            trace.annotate(backend=m.name)
            if stream is None:
                self._record_trace(
                    trace, status, error=code,
                    cache=headers.get("x-cache"),
                )
        slog.event(
            _log, "router_request",
            level=logging.WARNING if status >= 500 else logging.INFO,
            method=req.method, path=req.path, status=status,
            backend=m.name, id=req.id,
            ms=round(dt * 1e3, 1),
            **({"stream": True} if stream is not None else {}),
        )
        resp_headers = {
            k: v for k, v in headers.items()
            if k not in _connection_nominated(headers)
        }
        resp_headers["x-backend"] = m.name
        if stream is not None:
            # zero-copy relay: the head is on the books; the
            # body pipes through ``_relay_stream`` which counts bytes,
            # adds the relay span, and records the trace at stream end.
            # A framed body keeps its content-length on the way out so
            # the CLIENT detects a torn relay as truncation.
            cl = headers.get("content-length", "")
            if cl.isdigit():
                resp_headers["content-length"] = cl
            stream = self._relay_stream(
                stream, m, trace, status, code, headers.get("x-cache")
            )
        return Response(
            status=status, body=body, headers=resp_headers, stream=stream
        )

    async def _relay_stream(
        self,
        chunks,
        m: BackendMember,
        trace: RequestTrace | None,
        status: int,
        code: str | None,
        cache: str | None,
    ):
        """Relay accounting for a streamed body: count bytes,
        record the relay span + the request trace at STREAM END, and
        keep a torn upstream from crashing the client's connection task
        — the client sees truncation via the preserved content-length,
        and the breaker is NOT re-fed (the head already reported this
        forward's outcome to ``_note_forward_result``)."""
        t0 = time.perf_counter()
        n = 0
        err: str | None = None
        try:
            async for chunk in chunks:
                n += len(chunk)
                yield chunk
        except (_BackendError, OSError, asyncio.IncompleteReadError) as e:
            err = str(e)
            self.metrics.inc_counter("relay_torn_total")
            slog.event(
                _log, "relay_torn", level=logging.WARNING,
                backend=m.name, bytes=n, error=err,
            )
        finally:
            aclose = getattr(chunks, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:  # noqa: BLE001 — cleanup only
                    pass
            self.metrics.inc_counter("relayed_responses_total")
            self.metrics.inc_counter("relay_bytes_total", n)
            if trace is not None:
                trace.add_span(
                    "relay", t0, time.perf_counter() - t0,
                    backend=m.name, bytes=n,
                    **({"error": err} if err else {}),
                )
                self._record_trace(trace, status, error=code, cache=cache)

    def _unavailable(
        self,
        req: Request,
        t0: float,
        last_err: str,
        trace: RequestTrace | None = None,
    ) -> Response:
        # no backend reachable (empty ring, or every candidate
        # infra-failed).  This is a router-side
        # error that used to vanish without a trace — the attempts that
        # were tried (incl. both legs of an exhausted hedge) are
        # already spans on ``trace``; the error ring keeps them.
        e = errors.BackendUnavailable(
            "no backend available"
            + (f" (last: {last_err})" if last_err else ""),
            retry_after_s=self.cooldown_s,
        )
        dt = time.perf_counter() - t0
        self.metrics.observe_request(dt, e.code)
        self._observe_route(req.path, dt, e.status)
        self._record_trace(trace, e.status, error=e.code)
        slog.event(
            _log, "router_request", level=logging.ERROR,
            method=req.method, path=req.path, status=e.status,
            backend=None, id=req.id, ms=round(dt * 1e3, 1),
            error=e.code,
        )
        resp = Response.json(errors.to_payload(e, req.id), e.status)
        retry = errors.retry_after_value(e.retry_after_s)
        if retry is not None:
            resp.headers["retry-after"] = retry
        return resp

    def _learn_job_owner(self, job_id: str, backend: str) -> None:
        self._job_owners.pop(job_id, None)
        self._job_owners[job_id] = backend
        while len(self._job_owners) > _JOB_OWNERS_MAX:
            self._job_owners.popitem(last=False)

    def _deadline_expired(
        self,
        req: Request,
        t0: float,
        during: str | None = None,
        trace: RequestTrace | None = None,
    ) -> Response:
        """A request whose ``x-deadline-ms`` budget
        is spent 504s AT THE ROUTER — before consuming a backend
        (``during`` None), or the moment its deadline-capped forward
        times out mid-flight (``during`` names the backend; that
        timeout is the CALLER's budget lapsing, not backend death, so
        it never feeds the ejection breaker).  The 504 that
        deliberately carries no ``x-backend`` now carries a TRACE —
        annotated deadline_expired, with whatever attempts ran before
        the budget died (none, when it expired on arrival)."""
        e = errors.DeadlineExpired(
            "x-deadline-ms budget exhausted at the router"
            + (f" (forward to {during} cut short)" if during else "")
        )
        self.metrics.inc_counter("deadline_expired_total")
        dt = time.perf_counter() - t0
        self.metrics.observe_request(dt, e.code)
        self._observe_route(req.path, dt, e.status)
        if trace is not None:
            trace.annotate(
                deadline_expired=True,
                **({"during": during} if during else {}),
            )
            self._record_trace(trace, e.status, error=e.code)
        slog.event(
            _log, "router_request", level=logging.WARNING,
            method=req.method, path=req.path, status=e.status,
            backend=during, id=req.id, ms=round(dt * 1e3, 1),
            error=e.code,
        )
        return Response.json(errors.to_payload(e, req.id), e.status)

    def _effective_timeout(self, req: Request, base: float) -> float:
        """min(per-forward timeout, the request's remaining deadline
        budget): a deadline-carrying interactive request can never be
        pinned to a dying socket for the full 330 s default."""
        if req.deadline is None:
            return base
        return min(base, max(0.001, req.deadline - time.perf_counter()))

    async def _forward_hedged(
        self,
        req: Request,
        m: BackendMember,
        key: str | None,
        target: str,
        fwd_headers: dict[str, str],
        timeout_s: float,
        tried: set[str],
        deadline_capped: bool = False,
        tr: RequestTrace | None = None,
        hops: list[int] | None = None,
        purpose: str = "primary",
    ) -> tuple[BackendMember, int, dict[str, str], bytes, float]:
        """One forward with a tail hedge: the primary fires
        immediately; once it has been out longer than the live fleet
        p95 (and the token-bucket budget allows), ONE duplicate fires
        to the next distinct ring owner.  First response wins; the
        loser's in-flight connection is closed via task cancellation.
        Returns ``(serving member, status, headers, body, head dt)``;
        raises ``_HedgeExhausted`` after noting BOTH members' failures
        (the caller must not re-note them).  A ``deadline_capped`` leg
        timing out is the CALLER's budget lapsing, not backend death:
        it is never noted, and when it is all that remains the plain
        ``_BackendError`` propagates so the caller's deadline guard
        answers 504.

        Tracing: the two legs are SIBLING ``attempt`` spans on
        ``tr`` — the helper records the failed and cancelled legs (a
        cancelled loser's span ends at its cancellation point, with
        ``cancelled: true``); the caller records the winner's span,
        because only it knows the final disposition.  ``hops`` is the
        request's shared attempt-ordinal counter: the hedge leg takes
        the next ordinal so a later failover never collides."""
        prim_ord = hops[0] if hops is not None else 1
        # per-leg start times + span metadata, for the failure spans
        # recorded in ``timed`` and the CANCELLED-loser span recorded
        # synchronously in the finally below (recording it from the
        # loser's own CancelledError handler would land AFTER the
        # winner's trace was snapshotted into the recorder — the
        # cancellation point would vanish from the recorded trace)
        leg_t0: dict[str, float] = {}

        async def timed(
            mm: BackendMember, hdrs: dict, to: float,
            hop_ord: int, leg_purpose: str,
        ):
            leg_t0[mm.name] = ts = time.perf_counter()
            try:
                s, h, b = await self._backend_request(
                    mm, req.method, target, hdrs, req.body, to
                )
            except _BackendError as e:
                if tr is not None:
                    tr.add_span(
                        "attempt", ts, time.perf_counter() - ts,
                        backend=mm.name, hop=hop_ord,
                        purpose=leg_purpose, error=str(e),
                    )
                raise
            return s, h, b, time.perf_counter() - ts

        prim_task = asyncio.ensure_future(
            timed(m, fwd_headers, timeout_s, prim_ord, purpose)
        )
        delay = self._hedge_delay_s()
        if delay is None or delay >= timeout_s:
            s, h, b, dt = await prim_task
            return m, s, h, b, dt
        done, _ = await asyncio.wait({prim_task}, timeout=delay)
        if done:
            # on time: no hedge, no budget touched (the common case —
            # result() re-raises a fast infra failure for the caller's
            # normal retry path)
            s, h, b, dt = prim_task.result()
            return m, s, h, b, dt
        hm = self.hedge_budget and self._hedge_candidate(key, m)
        if not hm:
            s, h, b, dt = await prim_task
            return m, s, h, b, dt
        if not self.hedge_budget.try_spend():
            self.metrics.inc_counter("hedges_budget_denied_total")
            s, h, b, dt = await prim_task
            return m, s, h, b, dt
        self.metrics.inc_counter("hedges_fired_total")
        if hops is not None:
            hops[0] += 1
        hedge_ord = prim_ord + 1
        if tr is not None:
            tr.annotate(hedge_fired=True, hedge_backend=hm.name)
        remaining = max(0.001, self._effective_timeout(req, timeout_s))
        # no x-peer-fill hint on the duplicate: the obvious fill source
        # is the very primary being raced
        hedge_task = asyncio.ensure_future(
            timed(
                hm,
                self._forward_headers(
                    req, key, hm.name, hop=f"{hedge_ord}:hedge"
                ),
                remaining, hedge_ord, "hedge",
            )
        )
        by_task = {prim_task: m, hedge_task: hm}
        leg_meta = {
            prim_task: (prim_ord, purpose),
            hedge_task: (hedge_ord, "hedge"),
        }
        pending = set(by_task)
        last_err: _BackendError | None = None
        deadline_err: _BackendError | None = None
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                # deterministic preference inside one wake-up batch:
                # primary first (its bytes are no worse, and the win
                # counter must not lie about a dead-heat)
                for t in sorted(done, key=lambda t: t is hedge_task):
                    mm = by_task[t]
                    try:
                        s, h, b, dt = t.result()
                    except _BackendError as e:
                        if deadline_capped and _is_timeout(e):
                            # the caller's budget lapsed on this leg:
                            # no breaker state, no tried entry.  Name
                            # WHICH leg — m in the caller is still the
                            # pre-hedge primary, and the 504's `during`
                            # (and its trace annotation) must not blame
                            # the primary for the hedge leg's timeout.
                            e.member = mm.name
                            deadline_err = e
                            continue
                        last_err = e
                        self._note_forward_result(mm, ok=False)
                        tried.add(mm.name)
                        continue
                    if t is hedge_task:
                        self.metrics.inc_counter("hedges_won_total")
                        slog.event(
                            _log, "hedge_won", level=logging.INFO,
                            backend=mm.name, id=req.id,
                            ms=round(dt * 1e3, 1),
                        )
                    return mm, s, h, b, dt
            if deadline_err is not None:
                # plain _BackendError (NOT _HedgeExhausted): the
                # caller's deadline guard turns it into the 504
                raise deadline_err
            raise _HedgeExhausted(str(last_err))
        finally:
            # close the loser's (or, on exhaustion, nobody's) in-flight
            # connection; the swallow callback retrieves the
            # CancelledError so the loop never logs an orphan.  The
            # loser's span is recorded HERE — synchronously, at the
            # cancellation point — so it is already on the trace when
            # the caller's _respond snapshots it into the recorder.
            for t in by_task:
                if not t.done():
                    mm = by_task[t]
                    if tr is not None:
                        ts = leg_t0.get(mm.name, time.perf_counter())
                        ord_, purp = leg_meta[t]
                        tr.add_span(
                            "attempt", ts, time.perf_counter() - ts,
                            backend=mm.name, hop=ord_, purpose=purp,
                            cancelled=True,
                        )
                    t.cancel()
                    t.add_done_callback(_swallow_task_result)

    def _new_trace(self, req: Request) -> RequestTrace | None:
        """The router's side of a request's story: a
        RequestTrace on the shared spine, or None with the recorder off
        — the trace_ring=0 escape hatch allocates NOTHING per request."""
        if self.recorder is None:
            return None
        return RequestTrace(req.id, _route_family(req.path))

    async def _proxy(self, req: Request) -> Response:
        t0 = time.perf_counter()
        if req.path.startswith("/v1/internal/"):
            # the peer-fill surface is backend-to-backend on the trusted
            # mesh: unauthenticated and QoS-unmetered BY DESIGN, which
            # is exactly why the router must not re-export it to
            # clients.  Same shape as a route that does not exist —
            # but still a histogram/SLO sample: bad-path
            # traffic must not be invisible to the rate the fleet p99
            # is computed over.
            self._observe_route(
                req.path, time.perf_counter() - t0, 404
            )
            return Response.json(
                {"error": f"no route for {req.path}"}, 404
            )
        if self.autoscaler is not None:
            # one O(1) bucket increment feeds the predictive pre-scaler's
            # per-tenant arrival history (identity per the qos.py rule:
            # x-api-key wins over x-tenant; cardinality is bounded inside
            # ArrivalHistory)
            self.autoscaler.record_arrival(
                req.headers.get("x-api-key")
                or req.headers.get("x-tenant")
                or "default"
            )
        tr = self._new_trace(req)
        if req.deadline is not None and (
            req.deadline - time.perf_counter() <= 0.01
        ):
            # already expired at the router: 504
            # without consuming a backend — forwarding work whose
            # caller has given up is the router-tier version of
            # dispatching dead work to the device.  The trace says so
            #: no attempt spans, deadline_expired annotated.
            return self._deadline_expired(req, t0, trace=tr)
        if req.method in ("GET", "DELETE"):
            if req.method == "GET" and req.path.rstrip("/") == "/v1/jobs":
                return await self._proxy_jobs_collection(req, t0, tr)
            jm = _JOBS_ENTITY_RE.match(req.path)
            if jm is not None:
                return await self._proxy_job(req, jm.group(1), t0, tr)
        key = None
        if req.method == "POST" and req.body:
            # the SAME canonicalization as the backend cache key
            # (serving/cache.py): field order / multipart boundaries /
            # encoding choice collapse, so every spelling of one logical
            # request lands on one backend.  The prefix differs from the
            # backend's (the router knows no model config) — irrelevant
            # for affinity, which only needs determinism per body.  The
            # quality tier is resolved the way the BACKEND
            # resolves it — `quality=` form field wins over the
            # x-quality header — then rides the PREFIX with the raw
            # field excluded from the body digest: the backend hashes
            # every spelling of one (body, tier) to one cache key, so
            # the ring must too, or the identical payload computes and
            # caches on two owners.  An explicit `full` normalizes to
            # bare, and tier-less requests keep the EXACT tier-less
            # digest — a mixed-version router fleet mid-rollout never
            # disagrees on placement for plain traffic.
            try:
                xq = req.form().get("quality", "")
            except Exception:  # noqa: BLE001 — unparseable: header only
                xq = ""
            xq = (
                xq or req.headers.get("x-quality", "")
            ).strip().lower()
            if xq == "full":
                xq = ""
            key = canonical_digest(
                f"fleet|{req.path}" + (f"|q={xq}" if xq else ""),
                req.headers.get("content-type", ""),
                req.body,
                req=req,
                exclude=("quality",),
            )
        # hot-key replication: a promoted zipf-head key's
        # READS spread over its R ring owners; forced recomputes
        # ("writes" — cache-control no-cache/no-store) stay on the
        # primary ALONE, where the backend's singleflight dedups them,
        # so replication never multiplies device work.
        replicas: list[str] | None = None
        if key is not None and self.hot_keys is not None:
            self.hot_keys.observe(key)
            cc = req.headers.get("cache-control", "").lower()
            if (
                "no-cache" not in cc
                and "no-store" not in cc
                # a job submit is NOT a read: identical submissions must
                # keep landing on ONE backend or the per-backend
                # idempotency index stops deduping them fleet-wide
                and req.path != "/v1/jobs"
                and self.hot_keys.is_hot(key)
            ):
                # the slow epoch is part of the key: a healthy<->slow
                # transition changes WHICH owners may serve a hot key
                # without changing ring identity or the hot set
                epoch = (
                    id(self.ring),
                    self.hot_keys.hot_keys,
                    self._slow_epoch,
                )
                if epoch != self._replica_cache_epoch:
                    self._replica_cache_epoch = epoch
                    self._replica_cache = {}
                owners = self._replica_cache.get(key)
                if owners is None:
                    owners = [
                        n
                        for n in self.ring.owners(key)[
                            : self.hot_key_replicas
                        ]
                        if self.members[n].in_ring
                        # a slow member in the spread would make the
                        # hottest keys the WORST served in the fleet —
                        # filtered uniformly; a slow PRIMARY collapses
                        # the list to one entry, which disables the
                        # spread and hands the key to the normal keyed
                        # demotion path (stand-in + peer-fill hint)
                        and self.members[n].state != "slow"
                    ]
                    self._replica_cache[key] = owners
                if len(owners) > 1:
                    replicas = owners
        if tr is not None and key is not None:
            # enough digest to eyeball cache/ring joins without bloating
            # every retained trace with 64 hex chars
            tr.annotate(key=key[:16])
            if replicas:
                tr.annotate(replicas=list(replicas))
        tried: set[str] = set()
        last_err = ""
        target = self._forward_target(req)
        # infra failures replay once on the next distinct ring owner —
        # safe for compute routes (pure functions of the request) but
        # NOT for job submits: the idempotency index is per-backend, so
        # a torn 202 replayed elsewhere would silently double-submit a
        # durable job.  One attempt, honest 502, client decides.
        attempts = (
            1 if req.method == "POST" and req.path == "/v1/jobs" else 2
        )
        # hedge eligibility: keyed idempotent traffic only.
        # Job submits are excluded by the same per-backend-idempotency
        # rule as retries (attempts==1); forced recomputes (no-cache /
        # no-store) are WRITES — a duplicate write is double device
        # work by definition; SSE/job streams never reach this loop
        # (_proxy_job owns them).  DELETE/PUT are not hedged.
        cc_hdr = req.headers.get("cache-control", "").lower()
        hedgeable = (
            attempts > 1
            and req.method in ("GET", "POST")
            and "no-cache" not in cc_hdr
            and "no-store" not in cc_hdr
            # the backend debug surface MUTATES (fault arming consumes
            # one-shot counts): a hedge would replay it onto a second
            # process on mere slowness of a request that succeeds
            and not req.path.startswith("/v1/debug/")
        )
        if hedgeable and self.hedge_budget is not None:
            # every eligible request deposits its fraction of a hedge
            # token — the <=pct% bound is against this stream
            self.hedge_budget.on_request()
        # attempt-ordinal counter shared with the hedge helper:
        # every forward leg — primary, hedge, failover — gets a
        # distinct x-trace-hop ordinal, so the assembled timeline can
        # tell the backend traces apart
        hops = [0]
        for _attempt in range(attempts):
            t_pick = time.perf_counter()
            m = self._pick(key, tried, replicas)
            if m is None:
                break
            # the key's ring owner, computed once per attempt: the
            # purpose classifier AND the demoted-primary hint below
            # both need it (one blake2b+bisect, hot path)
            owner = self.ring.owner(key) if key is not None else None
            purpose = self._attempt_purpose(owner, m, tried, replicas)
            if tr is not None:
                tr.add_span(
                    "ring_pick", t_pick, time.perf_counter() - t_pick,
                    backend=m.name, purpose=purpose,
                )
            # effective timeout = min(forward
            # timeout, remaining deadline budget), re-derived per
            # attempt; a spent budget 504s without consuming a backend
            timeout_s = self.forward_timeout_s
            deadline_capped = False
            if req.deadline is not None:
                remaining = req.deadline - time.perf_counter()
                if remaining <= 0.01:
                    return self._deadline_expired(req, t0, trace=tr)
                if remaining < timeout_s:
                    timeout_s = remaining
                    deadline_capped = True
            hint = None
            # replica accounting/hints apply to the INITIAL spread pick
            # only: a failover retry (tried non-empty) is a plain
            # owners-walk hop — counting it as a replica read would lie,
            # and hinting at replicas[0] could point the new pick's
            # peer-fill at the very member that just infra-failed
            was_replica = (
                replicas is not None
                and not tried
                and m.name != replicas[0]
            )
            if was_replica and self.peer_fill:
                # the replica's first miss fills from the primary's
                # cache instead of recomputing — the "write" lives on
                # the primary, the replica serves a copy of its bytes
                hint = replicas[0]
            elif (
                key is not None
                and not tried
                and replicas is None
                and self.peer_fill
            ):
                if (
                    owner is not None
                    and owner != m.name
                    and self.members[owner].state == "slow"
                    and not self.members[owner].announced_drain
                ):
                    # demoted gray primary: slow, not dead —
                    # its cache is warm, so the stand-in's first miss
                    # copies bytes from it instead of recomputing the
                    # whole demoted keyspace
                    hint = owner
            hops[0] += 1
            hop_ord = hops[0]
            fwd_headers = self._forward_headers(
                req, key, m.name, hint=hint,
                hop=f"{hop_ord}:{purpose}",
            )
            picked = m  # the pre-hedge pick: m may become the winner
            # the hedge helper buffers both legs (the race needs bytes
            # it can throw away when the loser is cancelled), so it is
            # only taken when a hedge could actually FIRE: eligible
            # traffic AND a warm enough digest to price the delay.  A
            # cold router, or traffic hedging excludes, takes the
            # streaming-relay path instead.
            hedged_path = (
                hedgeable
                and not tried
                and m.state != "slow"
                and self._hedge_delay_s() is not None
            )
            stream = None  # hedged forwards stay buffered (race needs bytes)
            t_att = time.perf_counter()
            try:
                if hedged_path:
                    # a SLOW pick (canary, or the all-slow fallback) is
                    # never hedged: a winning hedge would cancel the
                    # canary's observation — the whole point is to let
                    # the slow path testify, at a bounded tail cost
                    m, status, headers, body, dt = (
                        await self._forward_hedged(
                            req, m, key, target, fwd_headers,
                            timeout_s, tried,
                            deadline_capped=deadline_capped,
                            tr=tr, hops=hops, purpose=purpose,
                        )
                    )
                else:
                    status, headers, body, stream = (
                        await self._forward_maybe_relay(
                            m, req, target, fwd_headers, timeout_s
                        )
                    )
                    dt = time.perf_counter() - t_att
            except _HedgeExhausted as e:
                # both race legs already noted/`tried`/span-recorded
                # inside the helper — just move the walk along
                last_err = str(e)
                continue
            except _BackendError as e:
                if tr is not None and not hedged_path:
                    # the hedged path's legs record their own spans
                    # inside the helper (incl. a fast primary failure
                    # re-raised through it) — recording here too would
                    # double the span
                    tr.add_span(
                        "attempt", t_att, time.perf_counter() - t_att,
                        backend=m.name, hop=hop_ord, purpose=purpose,
                        error=str(e),
                    )
                if deadline_capped and _is_timeout(e):
                    # the CALLER's budget lapsed mid-forward — not
                    # backend death; 504, and the breaker stays clean.
                    # A hedged race stamps the timed-out LEG's name on
                    # the error (m still names the pre-hedge primary).
                    return self._deadline_expired(
                        req, t0,
                        during=getattr(e, "member", m.name),
                        trace=tr,
                    )
                last_err = str(e)
                self._note_forward_result(m, ok=False)
                tried.add(m.name)
                slog.event(
                    _log, "forward_failed", level=logging.WARNING,
                    backend=m.name, id=req.id, error=last_err,
                )
                continue
            if tr is not None:
                # the WINNING leg's span (the hedge helper records only
                # losers — it cannot know the final disposition).  The
                # winner mark is scoped to THIS attempt having raced
                # (hedged_path): hedge_fired is a trace-level
                # annotation, and a later failover after an exhausted
                # hedge must not be painted as a race winner.
                won_hedge = m is not picked
                raced = hedged_path and tr.annotations.get("hedge_fired")
                tr.add_span(
                    "attempt",
                    time.perf_counter() - dt,
                    dt,
                    backend=m.name,
                    hop=hop_ord + 1 if won_hedge else hop_ord,
                    purpose="hedge" if won_hedge else purpose,
                    status=status,
                    **({"winner": True} if raced else {}),
                )
            # 500/502 = the backend (or ITS downstream) crashing — a
            # passive-ejection signal like a timeout.  503/504 are
            # designed backpressure (sheds, breakers, deadlines): they
            # pass through with their Retry-After and never eject.
            self._note_forward_result(
                m, ok=status not in (500, 502), latency_ms=dt * 1e3
            )
            if (
                was_replica
                and m.name in replicas
                and m.name != replicas[0]
            ):
                # m may have become the hedge WINNER above: the spread
                # credit only applies while the server is actually one
                # of the key's replicas
                self.metrics.inc_labeled(
                    "replica_reads_total", "backend", m.name
                )
            if (
                status == 202
                and req.method == "POST"
                and req.path == "/v1/jobs"
            ):
                # pin the new job to its backend so entity polls follow
                # it instead of the ring (jobs are per-backend state)
                jid = headers.get("location", "").rsplit("/", 1)[-1]
                if jid:
                    self._learn_job_owner(jid, m.name)
            return self._respond(
                req, m, status, headers, body, t0, stream=stream,
                trace=tr,
            )
        return self._unavailable(req, t0, last_err, trace=tr)

    async def _proxy_job(
        self,
        req: Request,
        job_id: str,
        t0: float,
        tr: RequestTrace | None = None,
    ) -> Response:
        """GET/DELETE ``/v1/jobs/{id}[/...]`` — follow the JOB, not the
        ring.  The owner pinned at submit time goes first; after a
        router restart (or an evicted pin) the walk degrades to asking
        every live member, reading a 404 ``job_not_found`` as "not here,
        next".  ``/events`` forwards PROGRESSIVELY: only the response
        head is bounded by the forward timeout, then the SSE body rides
        an open pipe for the job's lifetime — buffering it to EOF would
        break the jobs' streaming contract, and a long job's timeout
        would feed the ejection breaker and evict a healthy backend."""
        sticky = self._job_owners.get(job_id)
        sm = self.members.get(sticky) if sticky is not None else None

        def _askable(m: BackendMember) -> bool:
            # a DRAINING owner still answers (its listener lives out
            # the grace window) and is the only holder of its jobs'
            # state — the ENTITY walk asks it whether the drain was
            # probe-observed or self-announced (skipping a live
            # grace-window listener would fail every poll for a job
            # only it holds); an announced member that is ALREADY dead
            # costs one bounded infra failure and the walk moves on.
            # Round-robin and the collection fan-out DO skip announced
            # drains — no single job depends on them.
            return m.in_ring or m.state == "draining"

        cands: list[BackendMember] = []
        if sm is not None and _askable(sm):
            cands.append(sm)
        cands += [
            m
            for m in self.members.values()
            # draining members are asked too: after a router restart (or
            # an evicted pin) the walk is the only way back to a job held
            # by a backend mid-rolling-restart
            if _askable(m) and m is not sm
        ]
        is_stream = req.method == "GET" and req.path.endswith("/events")
        target = self._forward_target(req)
        miss: tuple | None = None
        no_route: tuple | None = None
        last_err = ""
        hop_ord = 0
        for m in cands:
            hop_ord += 1
            # the pinned owner is the walk's primary; every further
            # candidate is a failover hop — stamped so the backend's
            # trace of a walked poll is attributable
            purpose = "primary" if hop_ord == 1 else "failover"
            fwd_headers = self._forward_headers(
                req, None, m.name, hop=f"{hop_ord}:{purpose}"
            )
            stream = None
            # the pinned owner gets the full forward timeout (a /result
            # body may be large); blind-walk candidates get a short
            # bound, else one wedged member stalls an unknown-id poll
            # for forward_timeout_s (330s default) PER candidate.  An
            # owner that ANNOUNCED drain gets the short bound too — it
            # may already be dead, and the announcement promised it
            # would not be around for a 330s answer anyway.
            base_timeout = (
                self.forward_timeout_s
                if m is sm and not m.announced_drain
                else self.walk_timeout_s
            )
            if req.deadline is not None and (
                req.deadline - time.perf_counter() <= 0.01
            ):
                # the budget ran out mid-walk: stop consuming members
                return self._deadline_expired(req, t0, trace=tr)
            timeout = self._effective_timeout(req, base_timeout)
            deadline_capped = timeout < base_timeout
            t_att = time.perf_counter()
            try:
                if is_stream:
                    status, headers, stream = (
                        await self._backend_request_stream(
                            m, req.method, target, fwd_headers,
                            req.body, timeout,
                        )
                    )
                    body = b""
                    if status != 200:
                        # an error head is a small buffered payload:
                        # drain it (bounded — a backend that sends the
                        # head then stalls must read as an infra
                        # failure, not hang the walk) so the miss-walk
                        # below can read the machine code
                        try:
                            body = await asyncio.wait_for(
                                _read_all(stream), timeout
                            )
                        except (asyncio.TimeoutError, TimeoutError) as te:
                            await stream.aclose()
                            raise _BackendError(
                                f"{m.name}: stalled error body"
                            ) from te
                        stream = None
                else:
                    status, headers, body = await self._backend_request(
                        m, req.method, target, fwd_headers,
                        req.body, timeout,
                    )
            except _BackendError as e:
                if tr is not None:
                    tr.add_span(
                        "attempt", t_att, time.perf_counter() - t_att,
                        backend=m.name, hop=hop_ord, purpose=purpose,
                        error=str(e),
                    )
                if deadline_capped and _is_timeout(e):
                    # the caller's budget lapsed mid-forward — not this
                    # member's failure, and no point walking on with an
                    # already-spent budget
                    return self._deadline_expired(
                        req, t0, during=m.name, trace=tr
                    )
                last_err = str(e)
                self._note_forward_result(m, ok=False)
                slog.event(
                    _log, "forward_failed", level=logging.WARNING,
                    backend=m.name, id=req.id, error=last_err,
                )
                continue
            if tr is not None:
                tr.add_span(
                    "attempt", t_att, time.perf_counter() - t_att,
                    backend=m.name, hop=hop_ord, purpose=purpose,
                    status=status,
                    **({"stream": True} if stream is not None else {}),
                )
            # stream heads are EXCLUDED from the latency digest:
            # an SSE head's timing is dominated by the job's own
            # state, not the network path
            self._note_forward_result(
                m,
                ok=status not in (500, 502),
                latency_ms=(
                    None
                    if stream is not None
                    else (time.perf_counter() - t_att) * 1e3
                ),
            )
            if status == 404:
                # neither 404 form is an authoritative answer about the
                # job: job_not_found is "not MY job, next", and a
                # jobs-disabled member (no jobs_dir -> the route is
                # never registered) answers a generic no-route 404 that
                # says nothing about a job living elsewhere.  Keep
                # walking either way — and never pin the id to a member
                # that just said it does not have it.
                if errors.code_from_body(body) == "job_not_found":
                    miss = (m, status, headers, body)
                else:
                    no_route = (m, status, headers, body)
                continue  # (an is_stream 404 was already drained above)
            if status < 500:
                self._learn_job_owner(job_id, m.name)
            return self._respond(
                req, m, status, headers, body, t0, stream=stream,
                trace=tr,
            )
        # members not askable right now (ejected, or still joining) may
        # be this durable job's only holder — their jobs survive on disk
        # and resume after the backend rejoins, so their absence makes a
        # fleet-wide 404 just as inconclusive as an in-walk infra failure
        unreachable = [
            m.name
            for m in self.members.values()
            if not (m.in_ring or m.state == "draining")
        ]
        if not last_err and not unreachable:
            # EVERY member was asked, answered, and disowned the id: an
            # honest 404 beats a 502 — the job is gone (or jobs are
            # disabled fleet-wide), not the fleet.  But if any member
            # infra-failed or was unreachable, the one backend that
            # holds this durable job may be the one that never answered:
            # a 404 then would tell the client a live job does not exist
            # (inviting a duplicate re-submit), so report retryable
            # unavailability instead.
            final = miss if miss is not None else no_route
            if final is not None:
                m, status, headers, body = final
                return self._respond(
                    req, m, status, headers, body, t0, trace=tr
                )
        return self._unavailable(
            req, t0,
            last_err or f"unreachable members: {', '.join(unreachable)}",
            trace=tr,
        )

    async def _proxy_jobs_collection(
        self,
        req: Request,
        t0: float,
        tr: RequestTrace | None = None,
    ) -> Response:
        """GET ``/v1/jobs`` — scatter-gather over every in-ring member:
        jobs are per-backend state, so a single-backend view through the
        router is a lie by sampling.  Jobs concatenate (each stamped
        with its ``backend``, created-order preserved), counts and queue
        depth sum; a member that fails to answer sets ``partial`` rather
        than failing the whole view.  DRAINING members are asked too —
        they are out of the ring but their listener lives out the grace
        window and they are the only holders of their jobs' state, so
        skipping them during a rolling restart would make those jobs
        vanish from the fleet view with ``partial: false``."""
        members = [
            m
            for m in self.members.values()
            # self-announced drains are skipped immediately:
            # the announcement says the listener is about to die, and a
            # fan-out that barriers on it would stall the fleet view
            if m.in_ring
            or (m.state == "draining" and not m.announced_drain)
        ]
        if not members:
            return self._unavailable(req, t0, "", trace=tr)
        target = self._forward_target(req)

        async def one(m: BackendMember):
            t_att = time.perf_counter()
            eff = self._effective_timeout(req, self.walk_timeout_s)
            try:
                # walk bound, not the forward timeout: the gather below
                # barriers on the slowest member, so one wedged listing
                # must cost seconds, not stall every fleet view for
                # minutes (no member is "pinned" for a listing)
                got = await self._backend_request(
                    m, "GET", target,
                    self._forward_headers(
                        req, None, m.name, hop="1:primary"
                    ),
                    b"",
                    eff,
                )
                if tr is not None:
                    tr.add_span(
                        "fanout", t_att, time.perf_counter() - t_att,
                        backend=m.name, status=got[0],
                    )
                return m, got, (time.perf_counter() - t_att) * 1e3, False
            except _BackendError as e:
                if tr is not None:
                    tr.add_span(
                        "fanout", t_att, time.perf_counter() - t_att,
                        backend=m.name, error=str(e),
                    )
                # a deadline-capped leg timing out is the CALLER's
                # budget, not this member's failure (partial view, but
                # no breaker state)
                return (
                    m, e, None,
                    eff < self.walk_timeout_s and _is_timeout(e),
                )

        jobs: list = []
        counts: dict[str, int] = {}
        queue_depth = 0
        partial = False
        for m, got, ms, deadline_to in await asyncio.gather(
            *(one(m) for m in members)
        ):
            if isinstance(got, _BackendError):
                if not deadline_to:
                    self._note_forward_result(m, ok=False)
                partial = True
                continue
            status, _headers, body = got
            self._note_forward_result(
                m, ok=status not in (500, 502), latency_ms=ms
            )
            doc = None
            if status == 200:
                try:
                    doc = json.loads(body)
                except ValueError:
                    doc = None
            if not isinstance(doc, dict):
                # a 404 here means jobs are disabled on that backend
                # (no jobs_dir) — still a partial fleet view
                partial = True
                continue
            m.requests_total += 1
            # keep the Prometheus family in lockstep with the
            # /v1/config per-member counter (as _respond does)
            self.metrics.inc_labeled("requests_total", "backend", m.name)
            for j in doc.get("jobs", ()):
                # a malformed element from one member must not 500 the
                # whole view (the sort below assumes dicts)
                if isinstance(j, dict):
                    j.setdefault("backend", m.name)
                    jobs.append(j)
                else:
                    partial = True
            for k, v in (doc.get("counts") or {}).items():
                if isinstance(v, int):
                    counts[k] = counts.get(k, 0) + v
            qd = doc.get("queue_depth")
            if isinstance(qd, int):
                queue_depth += qd

        def _created(j: dict) -> float:
            try:
                return float(j.get("created_ts") or 0)
            except (TypeError, ValueError):
                return 0.0

        jobs.sort(key=_created)
        dt = time.perf_counter() - t0
        self.metrics.observe_stage("forward", dt)
        self.metrics.observe_request(dt)
        self._observe_route(req.path, dt, 200)
        if tr is not None:
            tr.annotate(fanout=len(members), partial=partial)
            self._record_trace(tr, 200)
        slog.event(
            _log, "router_request", method=req.method, path=req.path,
            status=200, backend="*", id=req.id, ms=round(dt * 1e3, 1),
            fanout=len(members),
        )
        resp = Response.json(
            {
                "jobs": jobs,
                "counts": counts,
                "queue_depth": queue_depth,
                "partial": partial,
                "backends": len(members),
            }
        )
        resp.headers["x-backend"] = "*"
        return resp

    # -------------------------------------------------------- own surfaces

    async def _healthz(self, _req: Request) -> Response:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.sleep(0)
        return Response.json(
            {
                "status": "ok",
                "router": True,
                "event_loop_lag_ms": round((loop.time() - t0) * 1e3, 3),
            }
        )

    async def _readyz(self, _req: Request) -> Response:
        by_state: dict[str, int] = {}
        for m in self.members.values():
            by_state[m.state] = by_state.get(m.state, 0) + 1
        # a slow member still serves (last-resort) — it counts as ring
        # capacity for the LB gate exactly as it does for placement
        in_ring = by_state.get("healthy", 0) + by_state.get("slow", 0)
        checks = {
            # the router is USEFUL while any backend accepts; a
            # zero-member ring is the one condition an LB must route
            # around
            "backends_in_ring": in_ring > 0,
            "not_draining": not self.draining,
        }
        ok = all(checks.values())
        body = {
            "ready": ok,
            "checks": checks,
            "backends": {"total": len(self.members), **by_state},
        }
        if self.tail_tolerance:
            # the operator's one-glance gray-failure surface: who is
            # slow NOW, and each member's live
            # window — visible BEFORE anyone ejects
            body["tail"] = {
                "slow": sorted(
                    m.name for m in self.members.values()
                    if m.state == "slow"
                ),
                "fleet": self._fleet_latency.snapshot(),
                "backends": {
                    m.name: m.latency.snapshot()
                    for m in self.members.values()
                },
            }
        if self.slos:
            # burn picture on the probe — informational, the
            # backend rule (a burning SLO must not pull router capacity)
            body["slo"] = {
                t.name: {**t.snapshot(), "ok": t.burn_rates()["5m"] <= 1.0}
                for t in self.slos
            }
        if self.autoscaler is not None:
            # the elasticity signal summary — what the controller last
            # saw and decided, on the probe an operator already reads
            body["autoscale"] = self.autoscaler.ready_block()
        if self.alert_engine is not None:
            # informational ONLY — a firing alert must never
            # pull router capacity out of the LB (the SLO-burn rule)
            snap = self.alert_engine.snapshot()
            body["alerts"] = {
                "firing": self.alert_engine.firing(),
                "pending": snap["pending"],
                "eval_errors_total": snap["eval_errors_total"],
            }
        return Response.json(body, status=200 if ok else 503)

    async def _config(self, _req: Request) -> Response:
        """GET /v1/config — the live ring snapshot: members, per-backend
        state/vnode count/served totals, probe/eject policy.  The
        operator's "who owns what and who is out" surface."""
        return Response.json(
            {
                "router": True,
                "vnodes": self.vnodes,
                "probe_interval_s": self.probe_interval_s,
                "probe_timeout_s": self.probe_timeout_s,
                "eject_threshold": self.eject_threshold,
                "cooldown_s": self.cooldown_s,
                "peer_fill": self.peer_fill,
                "forward_timeout_s": self.forward_timeout_s,
                "ring_points": len(self.ring),
                "rebalanced_keys_total": self.metrics.counter(
                    "rebalanced_keys_total"
                ),
                "draining": self.draining,
                # the shared-membership + replication picture
                "membership_file": self.membership_file or None,
                "fleet_token_set": bool(self.fleet_token),
                "hot_key_top_k": (
                    self.hot_keys.top_k if self.hot_keys is not None else 0
                ),
                "hot_key_replicas": self.hot_key_replicas,
                "hot_keys_active": (
                    len(self.hot_keys.hot_keys)
                    if self.hot_keys is not None
                    else 0
                ),
                # the tail-tolerance picture — knobs, the
                # live hedge state, and (per member, below) the
                # windowed latency an operator reads to see a member
                # going gray BEFORE it ejects
                "tail_tolerance": {
                    "enabled": self.tail_tolerance,
                    "slow_eject_k": self.slow_eject_k,
                    "slow_restore_k": self.slow_restore_k,
                    "slow_min_samples": self.slow_min_samples,
                    "slow_hold_s": self.slow_hold_s,
                    "slow_floor_ms": self.slow_floor_ms,
                    "slow_canary_every": self.slow_canary_every,
                    "latency_window_s": self.latency_window_s,
                    "hedge_budget_pct": (
                        self.hedge_budget.pct
                        if self.hedge_budget is not None
                        else 0.0
                    ),
                    "hedge_min_delay_ms": self.hedge_min_delay_ms,
                    "hedge_tokens": (
                        round(self.hedge_budget.tokens, 3)
                        if self.hedge_budget is not None
                        else 0.0
                    ),
                    "hedge_delay_ms": (
                        round(d * 1e3, 1)
                        if (d := self._hedge_delay_s()) is not None
                        else None
                    ),
                    "fleet_latency": self._fleet_latency.snapshot(),
                },
                # the router observability plane — recorder
                # state + live SLO burn, mirroring the backend contract
                "trace_active": self.recorder is not None,
                **(
                    {"trace_counts": self.recorder.counts()}
                    if self.recorder is not None
                    else {}
                ),
                "slo_state": {
                    t.name: t.snapshot() for t in self.slos
                },
                "fault_injection_active": self.faults is not None,
                **(
                    {"faults_state": self.faults.snapshot()}
                    if self.faults is not None
                    else {}
                ),
                # the autoscale knob block — ABSENT when off
                **(
                    {"autoscale": self.autoscaler.config_block()}
                    if self.autoscaler is not None
                    else {}
                ),
                # the fleet-memory block — ABSENT when off
                **(
                    {
                        "tsdb": {
                            "interval_s": self.tsdb_interval_s,
                            "stats": self.tsdb.stats(),
                            "alert_rules": (
                                len(self.alert_engine.rules)
                                if self.alert_engine is not None
                                else 0
                            ),
                            "alerts_firing": (
                                self.alert_engine.firing()
                                if self.alert_engine is not None
                                else []
                            ),
                            "incidents_dir_set": (
                                self.incidents is not None
                            ),
                        }
                    }
                    if self.tsdb is not None
                    else {}
                ),
                "members": {
                    m.name: {
                        "state": m.state,
                        "in_ring": m.in_ring,
                        "capacity": m.capacity,
                        "vnodes": (
                            self.vnodes * m.capacity if m.in_ring else 0
                        ),
                        "requests_total": m.requests_total,
                        "breaker": m.breaker.state_name,
                        "source": self._member_source.get(
                            m.name, "static"
                        ),
                        "announced_drain": m.announced_drain,
                        "latency": m.latency.snapshot(),
                    }
                    for m in self.members.values()
                },
                "bound_host": self.bound[0] if self.bound else None,
                "bound_port": self.bound[1] if self.bound else None,
            }
        )

    async def _debug_faults(self, req: Request) -> Response:
        """POST /v1/debug/faults — runtime arm/disarm of the router's
        ``fleet.*`` network-fault sites (only routed with
        ``--fault-injection``, mirroring the backend contract).  Form:
        ``arm=site=spec[,...]`` and/or ``disarm=<site>|all``."""
        try:
            form = req.form()
        except Exception:  # noqa: BLE001 — unparseable body = empty form
            form = {}
        disarm = form.get("disarm")
        if disarm:
            self.faults.disarm(None if disarm == "all" else disarm)
        if form.get("arm"):
            try:
                self.faults.arm_string(form["arm"])
            except ValueError as e:
                return Response.json(
                    {
                        "error": "bad_request",
                        "message": str(e),
                        "request_id": req.id,
                    },
                    400,
                )
        return Response.json(
            {"faults": self.faults.snapshot(), "request_id": req.id}
        )

    # ------------------------------------------------- observability plane

    async def _debug_requests(self, req: Request) -> Response:
        """GET /v1/debug/requests — the ROUTER's flight-recorder query
        surface, same contract as the backend's: ``?slow=1``
        / ``?error=1`` select the tail-sampled rings, ``?id=`` searches
        every ring, ``?limit=N`` caps.  NOTE this exact route shadows
        proxying of the path (the /v1/debug/faults precedent): ask a
        backend's recorder directly, or use /v1/debug/trace/{id} for
        the joined view."""
        if self.recorder is None:
            e = errors.BadRequest(
                "router tracing disabled: set --trace-ring > 0"
            )
            return Response.json(errors.to_payload(e, req.id), e.status)
        try:
            args = debug_query_args(req.query, self.trace_ring)
        except ValueError:
            e = errors.BadRequest("limit must be an int")
            return Response.json(errors.to_payload(e, req.id), e.status)
        traces = self.recorder.query(**args)
        return Response.json(
            {
                "requests": traces,
                "counts": self.recorder.counts(),
                "slow_ms": self.trace_slow_ms,
                "sample": self.trace_sample,
            }
        )

    async def _fetch_backend_trace(
        self, m: BackendMember, trace_id: str
    ) -> list[dict] | None:
        """One backend's flight-recorder records for ``trace_id`` via
        its existing debug endpoint; None on any failure (the assembly
        reports it as a missing side, never an error)."""
        try:
            status, _h, body = await raw_request(
                m.host, m.port, "GET",
                f"/v1/debug/requests?id={urllib.parse.quote(trace_id)}",
                {}, b"", self.walk_timeout_s,
            )
            if status != 200:
                return None
            doc = json.loads(body)
            reqs = doc.get("requests")
            return reqs if isinstance(reqs, list) else None
        except (_BackendError, ValueError):
            return None

    async def _debug_trace(self, req: Request) -> Response:
        """GET /v1/debug/trace/{id} — cross-hop trace assembly.
        Joins the router's span tree for one request id with
        every touched backend's flight-recorder record (fetched live
        via the backends' own /v1/debug/requests, keyed by the same
        id) into ONE merged timeline: every attempt backend-attributed,
        both legs of a hedge with the loser's cancellation point, the
        winner's server-side decode/dispatch/encode spans inline.  A
        backend that no longer holds the trace (ring rolled over,
        tracing off, member gone) appears under ``missing`` — partial
        assembly beats a 502."""
        if self.recorder is None:
            e = errors.BadRequest(
                "router tracing disabled: set --trace-ring > 0"
            )
            return Response.json(errors.to_payload(e, req.id), e.status)
        trace_id = req.path[len("/v1/debug/trace/"):]
        if not RID_RE.match(trace_id):
            e = errors.BadRequest("malformed trace id")
            return Response.json(errors.to_payload(e, req.id), e.status)
        found = self.recorder.query(trace_id=trace_id, limit=1)
        if not found:
            return Response.json(
                {
                    "error": "trace_not_found",
                    "message": "no router trace for that id (ring "
                    "rolled over, or the request never crossed this "
                    "router)",
                    "request_id": req.id,
                },
                404,
            )
        router_trace = found[0]
        # every backend the router's spans attribute — attempt legs,
        # fan-out hops, hedge losers — in first-touch order
        touched: list[str] = []
        for span in router_trace.get("spans", ()):
            b = span.get("backend")
            if isinstance(b, str) and b not in touched:
                touched.append(b)
        backend_traces: dict[str, list[dict]] = {}
        missing: list[str] = []
        known = [
            (name, self.members.get(name)) for name in touched
        ]
        fetched = await asyncio.gather(
            *(
                self._fetch_backend_trace(m, trace_id)
                for _name, m in known
                if m is not None
            )
        )
        it = iter(fetched)
        for name, m in known:
            if m is None:
                missing.append(name)
                continue
            got = next(it)
            if got:
                backend_traces[name] = got
            else:
                missing.append(name)
        return Response.json(
            {
                "id": trace_id,
                "router": router_trace,
                "backends": backend_traces,
                "missing": missing,
                "timeline": assemble_timeline(
                    router_trace, backend_traces
                ),
                "request_id": req.id,
            }
        )

    async def _scrape_member(
        self, m: BackendMember
    ) -> tuple[str, str | None, float | None]:
        """(name, exposition text or None, staleness seconds): a live
        scrape is staleness ~0; a failed one falls back to the cached
        last-good text with its age — a member mid-restart must not
        read as a counter reset to every downstream rate()."""
        now = self._clock()
        try:
            status, _h, body = await raw_request(
                m.host, m.port, "GET", "/v1/metrics", {}, b"",
                self.walk_timeout_s,
            )
            if status == 200:
                text = body.decode("utf-8", "replace")
                self._scrape_cache[m.name] = (now, text)
                self._stamp_scrape_health(m.name, True, 0.0)
                return m.name, text, 0.0
        except _BackendError:
            pass
        cached = self._scrape_cache.get(m.name)
        if cached is not None:
            ts, text = cached
            # floor the staleness of a FAILED scrape above 0: exactly
            # 0.0 means "live" to every downstream consumer (scrape_ok,
            # the absence rules), and a cache written sub-millisecond
            # ago would otherwise round into masquerading as one
            staleness = max(round(now - ts, 3), 0.001)
            self._stamp_scrape_health(m.name, False, staleness)
            return m.name, text, staleness
        self._stamp_scrape_health(m.name, False, None)
        return m.name, None, None

    def _stamp_scrape_health(
        self, name: str, live: bool, staleness: float | None
    ) -> None:
        """Mirror per-member scrape health into the router's OWN
        registry: the federation exposition always
        stamped these, but only as ephemeral text — a dead member's
        cached counters rode /v1/metrics/fleet with nothing durable
        saying "this is a corpse".  As labeled gauges they ride the
        router scrape AND the TSDB self-scrape, so an absence/threshold
        rule over ``fleet_scrape_ok`` is trustworthy end-to-end."""
        self.metrics.set_labeled_gauge(
            "fleet_scrape_ok", "backend", name, 1.0 if live else 0.0
        )
        if staleness is not None:
            self.metrics.set_labeled_gauge(
                "fleet_scrape_staleness_seconds", "backend", name,
                staleness,
            )

    async def _metrics_fleet(self, req: Request) -> Response:
        """GET /v1/metrics/fleet — metrics federation: one
        scrape target for the whole fleet.  Every member's /v1/metrics
        families re-export with a ``backend="host:port"`` label spliced
        in (ONE TYPE/HELP header per family across all members — the
        exposition lint's uniqueness rule), plus ``fleet_*`` rollups
        and per-member scrape-health gauges.  Because the histogram
        families share one fixed bucket vocabulary, downstream
        aggregation (sum by le) yields the TRUE fleet-wide p99 — the
        thing per-process quantiles mathematically cannot."""
        members = list(self.members.values())
        results = await asyncio.gather(
            *(self._scrape_member(m) for m in members)
        )
        # family -> kind line, help line, ordered sample lines; plus
        # the label-free-counter rollups, collected in the SAME walk
        order: list[str] = []
        kinds: dict[str, str] = {}
        helps: dict[str, str] = {}
        samples: dict[str, list[str]] = {}
        rollup: dict[str, float] = {}
        for name, text, _staleness in results:
            if text is None:
                continue
            current: str | None = None
            cur_kind: str | None = None
            label = f'backend="{escape_label(name)}"'
            for line in text.splitlines():
                if not line:
                    continue
                if line.startswith("# TYPE "):
                    parts = line.split(" ")
                    if len(parts) != 4:
                        continue
                    current, cur_kind = parts[2], parts[3]
                    if current not in kinds:
                        kinds[current] = cur_kind
                        order.append(current)
                    continue
                if line.startswith("# HELP "):
                    fam = line.split(" ", 3)[2]
                    helps.setdefault(fam, line)
                    continue
                if line.startswith("#") or current is None:
                    continue
                # splice the backend label into the sample line: after
                # '{' when a label block exists, else a fresh block.
                # Insertion at the block's HEAD is escape-safe — no
                # existing label value is crossed.
                metric, _, rest = line.partition(" ")
                if "{" in metric:
                    mname, _, tail = metric.partition("{")
                    rewritten = f"{mname}{{{label},{tail} {rest}"
                else:
                    rewritten = f"{metric}{{{label}}} {rest}"
                    if cur_kind == "counter":
                        # rollup: label-free counters summed across
                        # members — the fleet totals a dashboard wants
                        # without PromQL (exported as a gauge: a member
                        # restart legitimately lowers the sum)
                        try:
                            rollup[metric] = (
                                rollup.get(metric, 0.0) + float(rest)
                            )
                        except ValueError:
                            pass
                samples.setdefault(current, []).append(rewritten)
        lines: list[str] = []
        for fam in order:
            if fam in helps:
                lines.append(helps[fam])
            lines.append(f"# TYPE {fam} {kinds[fam]}")
            lines.extend(samples.get(fam, ()))
        if rollup:
            lines.append(
                "# HELP fleet_counter_sum label-free counters summed "
                "across scraped members"
            )
            lines.append("# TYPE fleet_counter_sum gauge")
            for fam, v in sorted(rollup.items()):
                lines.append(
                    f'fleet_counter_sum{{family="{fam}"}} {v:g}'
                )
        lines.append("# HELP fleet_scrape_ok live scrape succeeded")
        lines.append("# TYPE fleet_scrape_ok gauge")
        for name, text, staleness in results:
            ok = 1 if staleness == 0.0 else 0
            lines.append(
                f'fleet_scrape_ok{{backend="{escape_label(name)}"}}'
                f" {ok}"
            )
        lines.append(
            "# HELP fleet_scrape_staleness_seconds age of the "
            "exposition re-exported per member (0 = live)"
        )
        lines.append("# TYPE fleet_scrape_staleness_seconds gauge")
        for name, text, staleness in results:
            # never-scraped members stamp +Inf: an
            # ABSENT staleness sample next to a present (cached) counter
            # set read as "live and idle" — a member dead from birth
            # must be visibly, infinitely stale instead of invisible
            val = "+Inf" if staleness is None else f"{staleness:g}"
            lines.append(
                "fleet_scrape_staleness_seconds"
                f'{{backend="{escape_label(name)}"}} {val}'
            )
        lines.append("# TYPE fleet_backends_scraped gauge")
        lines.append(
            "fleet_backends_scraped "
            f"{sum(1 for _n, t, _s in results if t is not None)}"
        )
        self.metrics.inc_counter("fleet_scrapes_total")
        return Response.text(
            "\n".join(lines) + "\n",
            content_type="text/plain; version=0.0.4",
        )

    # ------------------------------------------- fleet memory

    def _tsdb_samples(self) -> dict:
        """One self-scrape tick's flattened sample set: the router
        registry, the live SLO burn gauges, the autoscaler's registry
        under an ``autoscaler_`` prefix (two registries, one series
        universe — no family collisions), and per-member ring state
        straight from the probe loop, so an absence or threshold rule
        sees membership without anyone hitting the federation scrape."""
        samples = flatten_snapshot(self.metrics.snapshot())
        for t in self.slos:
            for window, rate in t.burn_rates().items():
                samples[
                    ("slo_burn_rate", f"slo={t.name},window={window}")
                ] = (KIND_GAUGE, rate)
        if self.autoscaler is not None:
            auto = flatten_snapshot(self.autoscaler.metrics.snapshot())
            for (fam, label), kv in auto.items():
                samples[(f"autoscaler_{fam}", label)] = kv
        samples[("fleet_members", "")] = (
            KIND_GAUGE, float(len(self.members)),
        )
        for m in self.members.values():
            samples[("fleet_member_in_ring", f"backend={m.name}")] = (
                KIND_GAUGE, 1.0 if m.in_ring else 0.0,
            )
        return samples

    def _incident_bundle(self, ctx: dict) -> dict:
        """The router's black box: the triggering rule + its query
        window, the router recorder's slow/error rings, ring membership
        with per-member state, and the autoscale journal tail — the
        fleet-shaped forensics a backend bundle cannot see."""
        rule = ctx.get("rule") or {}
        bundle = dict(ctx)
        if rule.get("kind") == "threshold":
            bundle["window"] = self.tsdb.query(
                rule.get("family", ""), rule.get("label") or None,
                range_s=rule.get("range_s", 60.0),
            )
        else:
            bundle["window"] = self.tsdb.query(
                "requests_total", None, range_s=120.0
            )
        if self.recorder is not None:
            bundle["slow"] = self.recorder.query(slow=True, limit=16)
            bundle["errors"] = self.recorder.query(error=True, limit=16)
        bundle["members"] = {
            m.name: {
                "state": m.state,
                "in_ring": m.in_ring,
                "source": self._member_source.get(m.name, "static"),
                "announced_drain": m.announced_drain,
            }
            for m in self.members.values()
        }
        if self.autoscaler is not None:
            bundle["autoscale"] = self.autoscaler.ready_block()
            if self.autoscaler.journal is not None:
                from deconv_api_tpu_torch.serving.autoscale import (
                    DecisionJournal,
                )

                bundle["autoscale_journal"] = DecisionJournal.replay(
                    self.autoscaler.journal.path
                )[-16:]
        if self.alert_engine is not None:
            bundle["alerts"] = self.alert_engine.snapshot()
        return bundle

    def _tsdb_tick(self) -> None:
        """Ingest + evaluate + record (sync — the loop task calls it;
        tests drive it directly under an injected clock)."""
        self.tsdb.ingest(self._tsdb_samples())
        if self.alert_engine is None:
            return
        for ctx in self.alert_engine.evaluate():
            if self.incidents is not None:
                rule_name = (ctx.get("rule") or {}).get("name", "rule")
                # best-effort durable surface: a failed write returns
                # None (counted in the durable families by the store)
                if self.incidents.record(
                    rule_name, self._incident_bundle(ctx)
                ) is not None:
                    self.metrics.inc_counter("incidents_recorded_total")
                else:
                    self.metrics.inc_counter("incident_write_errors_total")
                    slog.event(
                        _log, "incident_write_failed",
                        level=40, rule=rule_name,
                    )

    async def _tsdb_loop(self) -> None:
        interval = self.tsdb_interval_s
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
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the tick must not die
                self.metrics.inc_counter("tsdb_tick_errors_total")
                slog.event(
                    _log, "tsdb_tick_error",
                    level=40, error=f"{type(e).__name__}: {e}",
                )
            # the self-scrape's own cost: the drill's ≤1% duty-cycle
            # budget reads scrape_seconds_total / elapsed
            self.tsdb.scrapes_total += 1
            self.tsdb.scrape_seconds_total += time.perf_counter() - t0

    def _bad_request(self, message: str, rid: str) -> Response:
        return Response.json(
            {"error": "bad_request", "message": message,
             "request_id": rid},
            400,
        )

    async def _metrics_history(self, req: Request) -> Response:
        """GET /v1/metrics/history — the router's OWN history under
        ``router``, federated per-backend histories under ``backends``
        (the /v1/metrics/fleet shape applied to retention).
        ``backend=<name>`` restricts the fan-out to one member;
        ``backend=none`` skips it (router-local only)."""
        q = dict(req.query)
        backend_sel = q.pop("backend", "all")
        family = q.get("family", "")
        label = q.get("label")
        try:
            range_s = float(q.get("range_s", "60"))
            step_raw = q.get("step_s", "")
            step_s = float(step_raw) if step_raw else None
        except ValueError:
            return self._bad_request(
                "range_s/step_s must be numeric", req.id
            )
        if range_s <= 0 or (step_s is not None and step_s <= 0):
            return self._bad_request("range_s/step_s must be > 0", req.id)
        if family:
            own: dict = {
                "family": family,
                "range_s": range_s,
                "series": self.tsdb.query(
                    family, label, range_s=range_s, step_s=step_s
                ),
            }
        else:
            own = {
                "families": self.tsdb.families(),
                "stats": self.tsdb.stats(),
            }
        body: dict = {"router": own}
        if backend_sel != "none":
            targets = [
                m for m in self.members.values()
                if backend_sel in ("all", m.name)
            ]
            if not targets and backend_sel != "all":
                return self._bad_request(
                    f"unknown backend {backend_sel!r}", req.id
                )
            path = "/v1/metrics/history"
            if q:
                path += "?" + urllib.parse.urlencode(q)

            async def fetch(m: BackendMember):
                try:
                    status, _h, b = await raw_request(
                        m.host, m.port, "GET", path, {}, b"",
                        self.walk_timeout_s,
                    )
                    if status == 200:
                        return m.name, json.loads(b.decode("utf-8"))
                    # a member without its own TSDB answers 404 — a
                    # federation hole, not an error
                    return m.name, {"error": f"status_{status}"}
                except (_BackendError, ValueError):
                    return m.name, {"error": "unreachable"}

            results = await asyncio.gather(*(fetch(m) for m in targets))
            body["backends"] = {name: doc for name, doc in results}
        return Response.json(body)

    async def _alerts_route(self, req: Request) -> Response:
        """GET /v1/alerts — the router engine's rule states plus every
        member's alert document federated under ``backends`` (each key
        is the ``backend=`` label the fleet exposition uses): one
        surface answers "is anything firing anywhere".  ``?self=1``
        skips the fan-out."""
        if self.alert_engine is not None:
            own = self.alert_engine.snapshot()
        else:
            own = {
                "rules": [], "firing": 0, "pending": 0,
                "evals_total": 0, "eval_errors_total": 0,
            }
        body: dict = {"router": own}
        firing = int(own.get("firing", 0))
        if req.query.get("self", "") not in ("1", "true"):

            async def fetch(m: BackendMember):
                try:
                    status, _h, b = await raw_request(
                        m.host, m.port, "GET", "/v1/alerts", {}, b"",
                        self.walk_timeout_s,
                    )
                    if status == 200:
                        return m.name, json.loads(b.decode("utf-8"))
                    return m.name, {"error": f"status_{status}"}
                except (_BackendError, ValueError):
                    return m.name, {"error": "unreachable"}

            results = await asyncio.gather(
                *(fetch(m) for m in self.members.values())
            )
            body["backends"] = {name: doc for name, doc in results}
            for doc in body["backends"].values():
                if isinstance(doc.get("firing"), int):
                    firing += doc["firing"]
        body["firing_anywhere"] = firing
        return Response.json(body)

    async def _debug_incidents(self, req: Request) -> Response:
        """GET /v1/debug/incidents — the router's black box (exact
        route shadows proxying: a BACKEND's bundles live on the backend,
        ask it directly).  ``?id=`` fetches one digest-verified bundle;
        without it, the summary list."""
        inc_id = req.query.get("id", "")
        if inc_id:
            doc = self.incidents.load(inc_id)
            if doc is None:
                return self._bad_request(
                    f"unknown incident {inc_id!r}", req.id
                )
            return Response.json(doc)
        return Response.json({
            "incidents": self.incidents.list(),
            "writes_total": self.incidents.writes_total,
            "corrupt_total": self.incidents.corrupt_total,
            "swept_total": self.incidents.swept_total,
        })

    async def _metrics_route(self, _req: Request) -> Response:
        text = self.metrics.prometheus()
        if self.recorder is not None:
            # router trace-spine block: span seconds/count
            # aggregates + ring occupancy, the backend precedent
            text += self.recorder.prometheus("router")
        text += slo_prometheus(self.slos, "router")
        if self.alert_engine is not None:
            # rule lifecycle states as gauges — the fleet's
            # alarm rides the same scrape as everything it watches
            text += self.alert_engine.prometheus("router")
        if self.autoscaler is not None:
            # the controller's own registry (autoscaler_* families) rides
            # the router scrape — decisions land on the same federation
            # plane they were made from
            text += self.autoscaler.metrics.prometheus()
        if self.worker is not None:
            # SO_REUSEPORT multi-router: every sample line
            # carries worker="N" so the federation plane's sum over
            # interchangeable workers stays truthful (N processes
            # answer this scrape round-robin behind one port)
            text = _splice_worker_label(text, self.worker)
        return Response.text(
            text,
            content_type="text/plain; version=0.0.4",
        )

    # ------------------------------------------------------------ lifecycle

    async def start(
        self,
        host: str = "0.0.0.0",
        port: int = 8100,
        *,
        reuse_port: bool = False,
    ) -> int:
        bound = await self.server.start(host, port, reuse_port=reuse_port)
        self.bound = (host, bound)
        # one immediate sweep so a fully-healthy fleet serves from the
        # first request instead of waiting out a probe interval
        await self.probe_once()
        self._probe_task = asyncio.create_task(self._probe_loop())
        if self.autoscaler is not None:
            self.autoscaler.start()
        if self.tsdb is not None and self._tsdb_task is None:
            self._tsdb_task = asyncio.get_running_loop().create_task(
                self._tsdb_loop(), name="router-tsdb-scrape"
            )
        return bound

    def begin_drain(self) -> None:
        self.draining = True
        self.server.draining = True

    async def stop(self, grace_s: float = 5.0) -> None:
        self.begin_drain()
        if self.autoscaler is not None:
            await self.autoscaler.stop()
        if self._tsdb_task is not None:
            self._tsdb_task.cancel()
            try:
                await self._tsdb_task
            except asyncio.CancelledError:
                pass
            self._tsdb_task = None
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except asyncio.CancelledError:
                pass
            self._probe_task = None
        for pool in self.pools.values():
            # drop the idle keep-alive sockets so backend listeners are
            # not held open through their own shutdown grace
            pool.flush()
        await self.server.stop(grace_s)


async def _serve_forever(
    router: FleetRouter,
    host: str,
    port: int,
    reuse_port: bool = False,
) -> None:
    import signal

    bound = await router.start(host, port, reuse_port=reuse_port)
    slog.configure()
    slog.event(
        _log, "router_start", host=host, port=bound,
        backends=sorted(router.members),
        **({"worker": router.worker} if router.worker is not None else {}),
    )
    print(
        f"deconv fleet router on {host}:{bound} over "
        f"{len(router.members)} backends",
        flush=True,
    )
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_ev.set)
        except NotImplementedError:  # pragma: no cover — non-unix hosts
            pass
    await stop_ev.wait()
    slog.event(_log, "router_shutdown")
    await router.stop()


def main(argv: list[str] | None = None) -> int:
    """``deconv-api-tpu fleet-router`` — the router-tier entrypoint."""
    import argparse

    p = argparse.ArgumentParser(description="deconv fleet router")
    p.add_argument(
        "--backends", default="",
        help="comma-separated host:port backend list (optional when "
        "--membership-file or --fleet-token lets backends join "
        "dynamically)",
    )
    p.add_argument(
        "--membership-file", default="", metavar="PATH",
        help="shared membership view (JSON, watched every probe tick "
        "and persisted tmp-then-rename on registrations/drains): N "
        "routers over one file converge on one member set — same ring "
        "seed, same key ownership, interchangeable behind any TCP LB",
    )
    p.add_argument(
        "--fleet-token", default="",
        help="shared secret authenticating POST /v1/internal/register "
        "(backend self-registration + drain announcements); empty "
        "disables the registration surface entirely",
    )
    p.add_argument(
        "--hot-key-top-k", type=int, default=0,
        help="replicate the K hottest keys (by EWMA request rate) to "
        "--hot-key-replicas ring owners, spreading their reads; 0 "
        "(default) keeps the classic one-owner-per-key topology",
    )
    p.add_argument(
        "--hot-key-replicas", type=int, default=2,
        help="ring owners a promoted hot key spreads reads over "
        "(default 2)",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument(
        "--workers", type=int, default=1,
        help="accept-loop processes sharing --port via SO_REUSEPORT: "
        "each is a full stateless router over the same "
        "merge-safe membership file, with worker=N labeled metrics; "
        "default 1 (no fork)",
    )
    p.add_argument(
        "--connection-pool", choices=("on", "off"), default="on",
        help="persistent per-backend keep-alive connection pools for "
        "forwards and probes; 'off' pins the "
        "prior dial-per-forward transport byte-identical",
    )
    p.add_argument(
        "--pool-size", type=int, default=8,
        help="max idle keep-alive connections retained per backend "
        "(default 8; in-flight checkouts beyond this dial fresh)",
    )
    p.add_argument(
        "--pool-idle-s", type=float, default=30.0,
        help="idle seconds before a pooled connection is reaped on the "
        "probe cadence (default 30)",
    )
    p.add_argument(
        "--stream-relay-min-bytes", type=int, default=262144,
        help="content-length at or above which a proxied 200 relays "
        "chunk-by-chunk instead of buffering (default 262144; 0 "
        "disables the streaming relay)",
    )
    p.add_argument(
        "--vnodes", type=int, default=64,
        help="virtual nodes per backend (movement granularity; default 64)",
    )
    p.add_argument(
        "--probe-interval-s", type=float, default=2.0,
        help="seconds between /readyz health sweeps",
    )
    p.add_argument(
        "--probe-timeout-s", type=float, default=2.0,
        help="per-probe timeout",
    )
    p.add_argument(
        "--eject-threshold", type=int, default=3,
        help="consecutive probe/forward failures before ejection",
    )
    p.add_argument(
        "--cooldown-s", type=float, default=5.0,
        help="seconds an ejected backend cools before its half-open probe",
    )
    p.add_argument(
        "--forward-timeout-s", type=float, default=330.0,
        help="per-forward client timeout (cover the slowest route's "
        "server-side timeout; dreams default 300s)",
    )
    p.add_argument(
        "--no-peer-fill", action="store_true",
        help="never attach x-peer-fill hints on rebalanced keys",
    )
    p.add_argument(
        "--tail-tolerance", choices=("on", "off"), default="on",
        help="gray-failure outlier ejection + hedged requests; 'off' "
        "pins topology and routing byte-identical to a router "
        "without them",
    )
    p.add_argument(
        "--slow-eject-k", type=float, default=4.0,
        help="a member whose windowed p95 exceeds K x its peers' "
        "median p95 is demoted to 'slow' (default 4.0)",
    )
    p.add_argument(
        "--slow-restore-k", type=float, default=2.0,
        help="a slow member back under K x the peer median is restored "
        "(hysteresis; default 2.0, clamped <= --slow-eject-k)",
    )
    p.add_argument(
        "--slow-min-samples", type=int, default=20,
        help="windowed samples required before a member can be judged "
        "slow (default 20; clamped so probe RTTs alone can sustain it "
        "— an idle or demoted member must stay judgeable)",
    )
    p.add_argument(
        "--slow-hold-s", type=float, default=10.0,
        help="minimum seconds in 'slow' before restoration is even "
        "considered (anti-flap; default 10)",
    )
    p.add_argument(
        "--slow-floor-ms", type=float, default=25.0,
        help="absolute p95 floor below which no member is ever judged "
        "slow (sub-ms jitter is noise, not gray failure; default 25)",
    )
    p.add_argument(
        "--slow-canary-every", type=int, default=64,
        help="every Nth demoted keyed pick still goes to the slow "
        "primary (unhedged) as restore evidence for device-level gray "
        "failures whose probes stay fast; 0 disables (default 64)",
    )
    p.add_argument(
        "--latency-window-s", type=float, default=30.0,
        help="sliding window for the per-backend latency digests "
        "(default 30)",
    )
    p.add_argument(
        "--hedge-budget-pct", type=float, default=5.0,
        help="hedge at most this percent of eligible requests (token "
        "bucket; 0 disables hedging; default 5)",
    )
    p.add_argument(
        "--hedge-min-delay-ms", type=float, default=30.0,
        help="floor under the p95-derived hedge delay (default 30)",
    )
    p.add_argument(
        "--fault-injection", action="store_true",
        help="enable the router's fleet.* network-fault sites and the "
        "POST /v1/debug/faults arming endpoint",
    )
    p.add_argument(
        "--fault", action="append", default=[], metavar="SITE=SPEC",
        help="arm a fleet.* fault site at boot (spec grammar: p<prob>|"
        "n<count>[:<param>][@<backend host:port>]); repeatable",
    )
    p.add_argument(
        "--fault-seed", type=int, default=0,
        help="seed for probabilistic fault specs (chaos replays)",
    )
    p.add_argument(
        "--trace-ring", type=int, default=256,
        help="router flight-recorder ring size per class (recent/slow/"
        "error rings + GET /v1/debug/requests + /v1/debug/trace/{id} "
        "assembly; 0 disables router tracing entirely — default 256)",
    )
    p.add_argument(
        "--trace-slow-ms", type=float, default=100.0,
        help="router-side latency threshold for the slow-trace ring "
        "(default 100)",
    )
    p.add_argument(
        "--trace-sample", type=float, default=1.0,
        help="head-sample rate for the router's recent-trace ring "
        "(0..1, default 1.0; slow/error traces always kept)",
    )
    p.add_argument(
        "--slo", default="", metavar="NAME=MS:PCT[:ROUTE],...",
        help="router latency SLO objects "
        "('name=<threshold_ms>:<objective_pct>[:<route>]'): burn-rate "
        "gauges on /metrics + an slo block on /readyz (default none)",
    )
    p.add_argument(
        "--autoscale", choices=("off", "advisory", "enforce"),
        default="off",
        help="closed-loop elasticity: advisory decides and journals "
        "only; enforce acts via --autoscale-launch-cmd; off (the "
        "default) constructs no controller",
    )
    p.add_argument(
        "--autoscale-interval-s", type=float, default=5.0,
        help="controller poll/decide interval (default 5)",
    )
    p.add_argument(
        "--autoscale-min", type=int, default=1,
        help="floor the controller never scales below (default 1)",
    )
    p.add_argument(
        "--autoscale-max", type=int, default=4,
        help="ceiling the controller never scales above (default 4)",
    )
    p.add_argument(
        "--autoscale-journal", default="", metavar="PATH",
        help="fsync'd JSONL decision journal (replayed on restart to "
        "restore cooldown anchors)",
    )
    p.add_argument(
        "--autoscale-launch-cmd", default="",
        help="backend launch argv template, {port} substituted "
        "(enforce mode; empty = advisory launcher)",
    )
    p.add_argument(
        "--autoscale-cooldown-up-s", type=float, default=30.0,
        help="minimum seconds between scale-ups (default 30)",
    )
    p.add_argument(
        "--autoscale-cooldown-down-s", type=float, default=120.0,
        help="minimum seconds between scale-downs (default 120)",
    )
    p.add_argument(
        "--autoscale-up-burn", type=float, default=0.9,
        help="5m SLO burn rate that reads as hot (default 0.9)",
    )
    p.add_argument(
        "--autoscale-up-queue", type=float, default=4.0,
        help="mean per-backend job pressure that reads as hot "
        "(default 4)",
    )
    p.add_argument(
        "--autoscale-qos-budget-ms", type=float, default=800.0,
        help="per-backend device-ms/s capacity budget gating "
        "scale-down (default 800)",
    )
    p.add_argument(
        "--tsdb", choices=("off", "on"), default="off",
        help="embedded metric history: a self-scrape task "
        "samples the router registry into bounded ring buffers, "
        "queryable at GET /v1/metrics/history with per-backend "
        "federation; off (default) constructs none of it",
    )
    p.add_argument(
        "--tsdb-interval-s", type=float, default=1.0,
        help="self-scrape interval for the raw tier (default 1.0; the "
        "rollup tier is 15x coarser)",
    )
    p.add_argument(
        "--alerts", default="", metavar="JSON|PATH",
        help="declarative alert rules (inline JSON or a file path), "
        "validated at boot; non-empty implies --tsdb on",
    )
    p.add_argument(
        "--incidents-dir", default="", metavar="PATH",
        help="directory for digest-verified incident bundles snapshot "
        "on firing transitions (GET /v1/debug/incidents); empty = "
        "evaluate but never record",
    )
    p.add_argument(
        "--incidents-retention-s", type=float, default=86400.0,
        help="seconds an incident bundle survives the sweep "
        "(default 86400)",
    )
    args = p.parse_args(argv)
    if args.slo:
        try:
            # validate BEFORE binding a listener on a typo'd objective
            parse_slos(
                args.slo,
                observable_routes=frozenset(
                    (*_ROUTE_FAMILIES, "/v1/jobs/{id}", "other")
                ),
            )
        except ValueError as e:
            p.error(str(e))
    if args.alerts:
        try:
            # validate BEFORE binding a listener on a typo'd rule
            parse_alert_rules(
                args.alerts,
                known_slos=frozenset(
                    s.split("=", 1)[0].strip()
                    for s in args.slo.split(",") if s.strip()
                ),
            )
        except ValueError as e:
            p.error(str(e))
    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    if not backends and not args.membership_file and not args.fleet_token:
        p.error(
            "--backends is required unless --membership-file or "
            "--fleet-token lets backends join dynamically"
        )
    faults_spec = ",".join(args.fault)
    if faults_spec:
        from deconv_api_tpu_torch.serving.faults import parse_fault_specs

        try:
            # validate BEFORE binding a listener on a typo'd site
            parse_fault_specs(faults_spec)
        except ValueError as e:
            p.error(str(e))
    if args.autoscale != "off" and args.workers > 1:
        # N SO_REUSEPORT workers would mean N independent controllers
        # sizing one fleet — run the controller as a sidecar instead
        # (the autoscaler subcommand) when the data plane is multi-worker
        p.error("--autoscale requires --workers 1 (use the autoscaler "
                "sidecar with a multi-worker router)")

    def _build(worker: int | None = None) -> FleetRouter:
        return FleetRouter(
            backends,
            vnodes=args.vnodes,
            probe_interval_s=args.probe_interval_s,
            probe_timeout_s=args.probe_timeout_s,
            eject_threshold=args.eject_threshold,
            cooldown_s=args.cooldown_s,
            peer_fill=not args.no_peer_fill,
            forward_timeout_s=args.forward_timeout_s,
            membership_file=args.membership_file,
            fleet_token=args.fleet_token,
            hot_key_top_k=args.hot_key_top_k,
            hot_key_replicas=args.hot_key_replicas,
            tail_tolerance=args.tail_tolerance == "on",
            slow_eject_k=args.slow_eject_k,
            slow_restore_k=args.slow_restore_k,
            slow_min_samples=args.slow_min_samples,
            slow_hold_s=args.slow_hold_s,
            slow_floor_ms=args.slow_floor_ms,
            slow_canary_every=args.slow_canary_every,
            latency_window_s=args.latency_window_s,
            hedge_budget_pct=args.hedge_budget_pct,
            hedge_min_delay_ms=args.hedge_min_delay_ms,
            fault_injection=args.fault_injection,
            faults_spec=faults_spec,
            fault_seed=args.fault_seed,
            trace_ring=args.trace_ring,
            trace_slow_ms=args.trace_slow_ms,
            trace_sample=args.trace_sample,
            slos=args.slo,
            connection_pool=args.connection_pool == "on",
            pool_size=args.pool_size,
            pool_idle_s=args.pool_idle_s,
            stream_relay_min_bytes=args.stream_relay_min_bytes,
            tsdb=args.tsdb,
            tsdb_interval_s=args.tsdb_interval_s,
            alerts=args.alerts,
            incidents_dir=args.incidents_dir,
            incidents_retention_s=args.incidents_retention_s,
            autoscale=args.autoscale,
            autoscale_opts={
                "interval_s": args.autoscale_interval_s,
                "journal_path": args.autoscale_journal,
                "launch_cmd": args.autoscale_launch_cmd,
                "engine_opts": {
                    "min_backends": args.autoscale_min,
                    "max_backends": args.autoscale_max,
                    "cooldown_up_s": args.autoscale_cooldown_up_s,
                    "cooldown_down_s": args.autoscale_cooldown_down_s,
                    "up_burn": args.autoscale_up_burn,
                    "up_queue": args.autoscale_up_queue,
                    "qos_device_ms_budget": args.autoscale_qos_budget_ms,
                },
            },
            worker=worker,
        )

    try:
        # a router the flags cannot build (a bad setting) is a usage
        # error before anything binds or forks
        router = _build(worker=0 if args.workers > 1 else None)
    except ValueError as e:
        p.error(str(e))
    if args.workers > 1:
        # SO_REUSEPORT multi-router: fork AFTER parsing and
        # BEFORE any event loop exists; each child builds its own
        # router (own loop, own pools, own metrics registry carrying a
        # worker= label) and binds the SAME fixed port.
        if args.port == 0:
            p.error("--workers > 1 needs a fixed --port (the processes "
                    "share one port via SO_REUSEPORT)")
        import signal

        pids: list[int] = []
        for k in range(args.workers):
            pid = os.fork()
            if pid == 0:
                code = 0
                try:
                    asyncio.run(_serve_forever(
                        _build(worker=k), args.host, args.port,
                        reuse_port=True,
                    ))
                except BaseException:  # noqa: BLE001 — child must exit
                    code = 1
                finally:
                    os._exit(code)
            pids.append(pid)

        def _relay(signum, _frame):
            for pid in pids:
                try:
                    os.kill(pid, signum)
                except OSError:
                    pass

        signal.signal(signal.SIGTERM, _relay)
        signal.signal(signal.SIGINT, _relay)
        rc = 0
        for pid in pids:
            try:
                _, status = os.waitpid(pid, 0)
            except OSError:
                continue
            if status != 0:
                rc = 1
        return rc
    asyncio.run(_serve_forever(router, args.host, args.port))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
