"""Closed-loop elasticity: the autoscale control plane (a copy of
``deconv_api_tpu/serving/autoscale.py``, with its pieces, names, metric
families and journal format).

A controller that polls the router's federation plane, decides, and acts:
backends self-register and announce their drain (``serving/app.py``),
boot warm from the kernel-library store (``serving/aot.py``) and the L2
response cache, and publish SLO burn and job pressure that the router
federates (``GET /v1/metrics/fleet``).  Scale-down is as first-class as
scale-up: an idle card costs as much as a busy one.

Pieces, each testable alone:

- ``parse_exposition`` / ``FleetSignals``: a forgiving Prometheus text
  reader over the router's federation output.  The controller consumes
  only that surface, the bytes an operator's monitoring reads, so the
  embedded and the sidecar controller see the same signals: multi-window
  SLO burn rates (``router_slo_burn_rate{slo=,window=}``), per-backend job
  pressure (``deconv_jobs_active{backend=}``), per-tenant device-ms
  counters, per-backend warm-hit counters and scrape health.

- ``DecisionEngine``: a pure decision over signals and a clock.  Scale up
  on a sustained hot signal (burn or queue depth over its threshold for
  ``up_consecutive`` polls), down on a sustained cold one, with a cooldown
  per direction and an up-recent guard: the hysteresis that keeps an
  oscillating signal from flapping the fleet.  A scale-down must also fit
  the per-tenant QoS budget: the device-ms demand the fleet carries must
  still fit on N-1 backends, else ``reason=qos-budget``.

- ``ArrivalHistory``: bounded per-tenant arrival buckets (tenants beyond
  ``max_tenants`` fold into ``other``) feeding a short-horizon
  least-squares rate forecast.  A projected ramp (``forecast >=
  predict_ramp x current``) launches ONE backend ahead of the load.
  ``TsdbArrivalHistory`` reads the same history back from the router's
  TSDB when it has one.

- ``DecisionJournal``: every decision fsync'd to JSONL before it acts
  (``durable.Journal``: append-only, torn-tail-tolerant replay).  A
  restarted controller replays it to restore its cooldown anchors.

- ``BackendLauncher``: the actuator.  ``AdvisoryLauncher`` (the default)
  only records intents; ``SubprocessLauncher`` spawns processes from an
  argv template (``{port}`` substituted).

- ``AutoscaleController``: the loop.  One ``tick()`` = poll, parse,
  decide, journal, act, fail-static: any error (the
  ``autoscale.decision_error`` fault site included) counts
  ``autoscaler_errors_total`` and changes nothing.  A scale-up measures
  boot-to-first-warm-hit (launch, self-registration, the first warm
  counter on the federation plane: an AOT store hit at boot, an L2 or a
  cache hit) as ``autoscaler_boot_to_warm_seconds``.  A scale-down
  announces the drain, waits for the jobs tier (a backend whose ``/v1/jobs``
  still shows ``running`` or ``parked`` jobs is never reaped), then
  reaps, leaving the L2 directory for the next boot.

Metric families (a registry of its own, prefix ``autoscaler_``, appended
to the router's exposition): ``autoscaler_decisions_total{action=,reason=}``,
``autoscaler_fleet_size``, ``autoscaler_pending_launches``,
``autoscaler_boot_to_warm_seconds`` (histogram),
``autoscaler_errors_total``, ``autoscaler_launch_failures_total``,
``autoscaler_reap_blocked_total``.

``--autoscale off`` (the default) constructs nothing: no controller, no
arrival recording, no config or readyz block, no metric families.

Imports no torch, like the router.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import shlex
import socket
import subprocess
import time
from typing import Callable

from deconv_api_tpu_torch.serving import durable
from deconv_api_tpu_torch.serving import faults as faults_mod
from deconv_api_tpu_torch.serving import fleet as fleet_mod
from deconv_api_tpu_torch.serving.metrics import Metrics
from deconv_api_tpu_torch.utils import slog

_log = logging.getLogger("deconv.autoscale")

MODES = ("off", "advisory", "enforce")

# ------------------------------------------------------------- signals

# One exposition sample line: name, optional {labels}, value.  NaN/Inf
# spellings are accepted by float() directly; timestamps (a third
# field) are not emitted by this stack and are rejected by the \s*$.
_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{([^}]*)\})?"
    r"\s+([^\s]+)\s*$"
)
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Prometheus text format -> ``[(family, labels, value), ...]``.

    Deliberately forgiving: comment/TYPE/HELP lines and anything
    unparseable are skipped, not errors — the controller reads a
    federation surface that splices N backends' expositions together,
    and one backend's malformed line must not blind it to the rest."""
    out: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        labels = {
            k: _unescape(v) for k, v in _LABEL_RE.findall(m.group(2) or "")
        }
        out.append((m.group(1), labels, value))
    return out


# The warm-hit vocabulary: any of these counters moving on a freshly
# launched backend means the warm-boot path (the kernel-library store,
# the L2 cache) delivered; the boot-to-first-warm-hit clock stops on the
# first one.
WARM_HIT_FAMILIES = (
    "deconv_cache_hits_total",
    "deconv_cache_l2_hits_total",
    "deconv_aot_cache_hits_total",
)


class FleetSignals:
    """One poll's view of the federation plane, pre-digested for the
    decision engine.  All fields are plain data — the parse is the only
    logic, so a canned exposition text IS a full test fixture."""

    __slots__ = (
        "burn", "queue_depth", "jobs_running", "jobs_parked",
        "device_ms", "scrape_ok", "backends_scraped", "requests_total",
        "warm_hits",
    )

    def __init__(self) -> None:
        self.burn: dict[tuple[str, str], float] = {}
        self.queue_depth: dict[str, float] = {}
        self.jobs_running: dict[str, float] = {}
        self.jobs_parked: dict[str, float] = {}
        self.device_ms: dict[str, float] = {}
        self.scrape_ok: dict[str, bool] = {}
        self.backends_scraped: int = 0
        self.requests_total: float = 0.0
        self.warm_hits: dict[str, float] = {}

    @classmethod
    def from_exposition(cls, text: str) -> "FleetSignals":
        s = cls()
        for family, labels, value in parse_exposition(text):
            backend = labels.get("backend", "")
            if family == "router_slo_burn_rate":
                slo = labels.get("slo", "")
                window = labels.get("window", "")
                # N SO_REUSEPORT workers export one gauge each; the
                # fleet's burn is the WORST worker's view
                key = (slo, window)
                s.burn[key] = max(s.burn.get(key, 0.0), value)
            elif family == "deconv_jobs_active" and backend:
                s.queue_depth[backend] = value
            elif family == "deconv_jobs_running" and backend:
                s.jobs_running[backend] = value
            elif family == "deconv_jobs_parked" and backend:
                s.jobs_parked[backend] = value
            elif family == "deconv_tenant_device_ms_total":
                tenant = labels.get("tenant", "default")
                s.device_ms[tenant] = s.device_ms.get(tenant, 0.0) + value
            elif family == "fleet_scrape_ok" and backend:
                s.scrape_ok[backend] = value >= 1.0
            elif family == "fleet_backends_scraped":
                s.backends_scraped = int(value)
            elif family == "router_requests_total" and not labels:
                s.requests_total += value
            elif family in WARM_HIT_FAMILIES and backend:
                s.warm_hits[backend] = s.warm_hits.get(backend, 0.0) + value
        return s

    def burn_max(self, window: str = "5m") -> float:
        """Worst burn rate across SLOs for one window (0.0 when no SLOs
        are configured — burn then never drives a decision and queue
        depth is the only hot signal)."""
        vals = [v for (_slo, w), v in self.burn.items() if w == window]
        return max(vals, default=0.0)

    def queue_mean(self) -> float:
        """Mean per-backend job pressure over backends the federation
        actually scraped OK on this poll — a vanished backend's last-good
        splice must not drag the mean."""
        vals = [
            v for b, v in self.queue_depth.items()
            if self.scrape_ok.get(b, True)
        ]
        if not vals:
            return 0.0
        return sum(vals) / len(vals)


# ------------------------------------------------------------- arrivals


class ArrivalHistory:
    """Bounded per-tenant arrival counts in fixed wall buckets, feeding
    the short-horizon rate forecast.

    Memory is explicitly bounded (the tenant-cardinality rule):
    at most ``max_buckets`` buckets, and per bucket at most
    ``max_tenants`` distinct tenants — the long tail folds into
    ``other``.  ``record`` is O(1) and runs on the proxy hot path, so
    it must stay an append/increment, nothing more."""

    def __init__(
        self,
        *,
        bucket_s: float = 5.0,
        max_buckets: int = 64,
        max_tenants: int = 32,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.bucket_s = max(0.5, float(bucket_s))
        self.max_buckets = max(4, int(max_buckets))
        self.max_tenants = max(1, int(max_tenants))
        self._clock = clock
        # bucket index -> {tenant: count}; plain dict ordered by insert,
        # trimmed from the front — deque-of-dicts without the dance
        self._buckets: dict[int, dict[str, int]] = {}

    def record(self, tenant: str, n: int = 1) -> None:
        idx = int(self._clock() / self.bucket_s)
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = {}
            while len(self._buckets) > self.max_buckets:
                self._buckets.pop(next(iter(self._buckets)))
        if tenant not in b and len(b) >= self.max_tenants:
            tenant = "other"
        b[tenant] = b.get(tenant, 0) + n

    def _rates(self, n: int) -> list[float]:
        """Total req/s for the last ``n`` COMPLETE buckets (the current
        partial bucket would read artificially low)."""
        cur = int(self._clock() / self.bucket_s)
        out = []
        for idx in range(cur - n, cur):
            counts = self._buckets.get(idx, {})
            out.append(sum(counts.values()) / self.bucket_s)
        return out

    def rate(self, n: int = 3) -> float:
        """Current arrival rate: mean over the last n complete buckets."""
        rates = self._rates(n)
        if not rates:
            return 0.0
        return sum(rates) / len(rates)

    def forecast(self, horizon_s: float, n: int = 6) -> tuple[float, float]:
        """(current rate, projected rate at now+horizon): least-squares
        slope over the last ``n`` complete bucket rates, extrapolated
        ``horizon_s`` ahead and clamped at zero.  Coarse on purpose —
        the decision only needs "a ramp is coming", not its shape."""
        rates = self._rates(n)
        cur = self.rate()
        if len(rates) < 3:
            return cur, cur
        xs = [i * self.bucket_s for i in range(len(rates))]
        mean_x = sum(xs) / len(xs)
        mean_y = sum(rates) / len(rates)
        sxx = sum((x - mean_x) ** 2 for x in xs)
        if sxx <= 0:
            return cur, cur
        slope = sum(
            (x - mean_x) * (y - mean_y) for x, y in zip(xs, rates)
        ) / sxx
        projected = max(0.0, cur + slope * float(horizon_s))
        return cur, projected


class TsdbArrivalHistory:
    """ArrivalHistory's interface backed by the router's embedded TSDB
    ("the forecaster reads the same history the operator queries").

    ``record`` increments a per-tenant ``arrivals_total`` counter in
    the ROUTER's metrics registry (bounded cardinality: the tenant tail
    folds into ``other``, the tenant-cardinality rule); the router's self-scrape
    tick turns that into rate series, and ``rate``/``forecast`` read
    those series back — so ``GET /v1/metrics/history?family=
    arrivals_total`` shows exactly the per-tenant arrival curves the
    predictive scale-up acted on, and the decision journal's forecast
    numbers are reproducible from the same query after the fact.

    The private accumulator (ArrivalHistory) remains the tsdb=off
    fallback: byte-parity demands the off path not grow new state."""

    def __init__(
        self,
        tsdb,
        metrics: Metrics,
        *,
        bucket_s: float = 5.0,
        max_tenants: int = 32,
    ):
        self.tsdb = tsdb
        self.metrics = metrics
        # a forecast bucket can't be finer than the scrape tick
        self.bucket_s = max(float(bucket_s), tsdb.interval_s)
        self.max_tenants = max(1, int(max_tenants))
        self._tenants: set[str] = set()
        # pre-register so the family exists from the first scrape
        self.metrics.inc_labeled("arrivals_total", "tenant", "default", 0)

    def record(self, tenant: str, n: int = 1) -> None:
        t = tenant or "default"
        if t not in self._tenants:
            if len(self._tenants) >= self.max_tenants:
                t = "other"
            self._tenants.add(t)
        self.metrics.inc_labeled("arrivals_total", "tenant", t, n)

    def _rates(self, n: int) -> list[float]:
        """Aggregate req/s per forecast bucket for the last ``n``
        complete buckets, oldest first — ArrivalHistory._rates'
        contract, reconstructed from the TSDB's raw rate ticks."""
        tick = self.tsdb.interval_s
        series = self.tsdb.query(
            "arrivals_total", None, range_s=(n + 1) * self.bucket_s
        )
        # sum across tenant series per scrape tick (ages within one
        # query share the same fractional offset, so the rounded tick
        # ordinal is a stable join key)
        per_tick: dict[int, float] = {}
        for ent in series:
            for p in ent["points"]:
                key = round(p[0] / tick)
                per_tick[key] = per_tick.get(key, 0.0) + p[1]
        # fold ticks into buckets; bucket 0 is the current partial one
        # and is skipped, like ArrivalHistory's current wall bucket
        per_bucket: dict[int, list[float]] = {}
        for key, rate in per_tick.items():
            per_bucket.setdefault(int(key * tick / self.bucket_s), []).append(
                rate
            )
        out = []
        for b in range(n, 0, -1):
            vals = per_bucket.get(b)
            out.append(sum(vals) / len(vals) if vals else 0.0)
        return out

    def rate(self, n: int = 3) -> float:
        rates = self._rates(n)
        if not rates:
            return 0.0
        return sum(rates) / len(rates)

    def forecast(self, horizon_s: float, n: int = 6) -> tuple[float, float]:
        """Same least-squares extrapolation as ArrivalHistory.forecast,
        over TSDB-reconstructed bucket rates."""
        rates = self._rates(n)
        cur = self.rate()
        if len(rates) < 3:
            return cur, cur
        xs = [i * self.bucket_s for i in range(len(rates))]
        mean_x = sum(xs) / len(xs)
        mean_y = sum(rates) / len(rates)
        sxx = sum((x - mean_x) ** 2 for x in xs)
        if sxx <= 0:
            return cur, cur
        slope = sum(
            (x - mean_x) * (y - mean_y) for x, y in zip(xs, rates)
        ) / sxx
        projected = max(0.0, cur + slope * float(horizon_s))
        return cur, projected


# ------------------------------------------------------------- journal


class DecisionJournal(durable.Journal):
    """Append-only fsync'd JSONL of every decision, on the shared
    ``durable.Journal`` body: the record is DURABLE
    before the action runs, so a controller that dies mid-action can
    never have acted on a decision it has no memory of.  FAIL-LOUD
    durable surface — an append that cannot fsync raises
    ``DurableWriteError`` out of the controller tick rather than
    acting on an unremembered decision; a journal written by a NEWER
    binary raises ``FutureVersionError`` at replay (refuse rather than
    misparse)."""

    _FORMAT = "autoscale.journal"
    _VERSION = 1

    def __init__(self, path: str, *, metrics=None):
        super().__init__(
            path,
            durable.Surface("autoscale.journal", metrics=metrics),
            fmt=self._FORMAT,
            version=self._VERSION,
        )

    @staticmethod
    def replay(path: str) -> list[dict]:
        """All intact data records; a torn tail (the crash-mid-append
        case) or an interleaved bad line is skipped, never an error.
        The version-header record is validated and excluded."""
        records, _torn = durable.Journal.replay(
            path, DecisionJournal._FORMAT, DecisionJournal._VERSION
        )
        return records


# ------------------------------------------------------------- engine


class Decision:
    """One evaluation's verdict: ``action`` in (up|down|hold), a
    closed-vocabulary ``reason`` (the decisions_total label — bounded
    cardinality by construction), and free-form detail for the journal."""

    __slots__ = ("action", "reason", "detail")

    def __init__(self, action: str, reason: str, **detail):
        self.action = action
        self.reason = reason
        self.detail = detail

    def to_dict(self) -> dict:
        return {"action": self.action, "reason": self.reason, **self.detail}


class DecisionEngine:
    """Pure scale decision over (signals, fleet size, clock): all the
    hysteresis lives here, none of the actuation.

    Hot = burn >= ``up_burn`` OR mean queue >= ``up_queue``; cold =
    burn <= ``down_burn`` AND mean queue <= ``down_queue``.  A decision
    fires only after ``up_consecutive``/``down_consecutive`` SUSTAINED
    polls, then arms the direction's cooldown; scale-down additionally
    refuses while a scale-up is recent (a spike that just added
    capacity must not be un-added the moment it passes) and while the
    measured device-ms demand would not fit on N-1 backends (the QoS
    budget gate)."""

    def __init__(
        self,
        *,
        up_burn: float = 0.9,
        up_queue: float = 4.0,
        down_burn: float = 0.2,
        down_queue: float = 0.5,
        up_consecutive: int = 2,
        down_consecutive: int = 5,
        cooldown_up_s: float = 30.0,
        cooldown_down_s: float = 120.0,
        min_backends: int = 1,
        max_backends: int = 4,
        qos_device_ms_budget: float = 800.0,
        predict_horizon_s: float = 30.0,
        predict_ramp: float = 2.0,
        predict_min_rate: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.up_burn = float(up_burn)
        self.up_queue = float(up_queue)
        self.down_burn = float(down_burn)
        self.down_queue = float(down_queue)
        self.up_consecutive = max(1, int(up_consecutive))
        self.down_consecutive = max(1, int(down_consecutive))
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.min_backends = max(1, int(min_backends))
        self.max_backends = max(self.min_backends, int(max_backends))
        self.qos_device_ms_budget = float(qos_device_ms_budget)
        self.predict_horizon_s = float(predict_horizon_s)
        self.predict_ramp = float(predict_ramp)
        self.predict_min_rate = float(predict_min_rate)
        self._clock = clock
        self._up_streak = 0
        self._down_streak = 0
        # cooldown anchors; restored from the journal on restart
        self.last_up_ts = float("-inf")
        self.last_down_ts = float("-inf")
        # previous per-tenant cumulative device-ms sample, for rates
        self._last_device_ms: tuple[float, dict[str, float]] | None = None

    # -- demand rate ---------------------------------------------------

    def device_ms_rates(self, signals: FleetSignals) -> dict[str, float]:
        """Per-tenant device-ms/s from cumulative counter deltas.  A
        negative delta (backend restart / membership change reset the
        sum) clamps to zero — one poll of under-reading beats a bogus
        spike."""
        now = self._clock()
        prev = self._last_device_ms
        self._last_device_ms = (now, dict(signals.device_ms))
        if prev is None:
            return {}
        dt = now - prev[0]
        if dt <= 0:
            return {}
        return {
            tenant: max(0.0, (cum - prev[1].get(tenant, 0.0)) / dt)
            for tenant, cum in signals.device_ms.items()
        }

    # -- evaluation ----------------------------------------------------

    def evaluate(
        self,
        signals: FleetSignals,
        fleet_size: int,
        *,
        pending: int = 0,
        arrivals: ArrivalHistory | None = None,
    ) -> Decision:
        now = self._clock()
        effective = fleet_size + pending
        burn = signals.burn_max("5m")
        qmean = signals.queue_mean()
        rates = self.device_ms_rates(signals)
        demand_ms = sum(rates.values())
        hot = burn >= self.up_burn or qmean >= self.up_queue
        cold = burn <= self.down_burn and qmean <= self.down_queue
        self._up_streak = self._up_streak + 1 if hot else 0
        self._down_streak = self._down_streak + 1 if cold else 0

        base = {
            "burn_5m": round(burn, 4),
            "queue_mean": round(qmean, 3),
            "fleet_size": fleet_size,
            "pending": pending,
            "demand_device_ms_s": round(demand_ms, 1),
        }

        if self._up_streak >= self.up_consecutive:
            if effective >= self.max_backends:
                return Decision("hold", "at-max", **base)
            if now - self.last_up_ts < self.cooldown_up_s:
                return Decision("hold", "cooldown-up", **base)
            self.last_up_ts = now
            self._up_streak = 0
            reason = "burn" if burn >= self.up_burn else "queue"
            return Decision("up", reason, **base)

        # predictive pre-scale: one backend ahead of a projected ramp,
        # under the same cooldown as a reactive up — never a second one
        if (
            arrivals is not None
            and effective < self.max_backends
            and now - self.last_up_ts >= self.cooldown_up_s
        ):
            cur, projected = arrivals.forecast(self.predict_horizon_s)
            if (
                cur >= self.predict_min_rate
                and projected >= self.predict_ramp * cur
            ):
                self.last_up_ts = now
                return Decision(
                    "up", "predictive",
                    rate=round(cur, 2), projected=round(projected, 2),
                    **base,
                )

        if self._down_streak >= self.down_consecutive:
            if effective <= self.min_backends:
                return Decision("hold", "at-min", **base)
            if now - self.last_down_ts < self.cooldown_down_s:
                return Decision("hold", "cooldown-down", **base)
            if now - self.last_up_ts < self.cooldown_down_s:
                # just scaled up: the signal going quiet does not prove
                # the added capacity is surplus yet
                return Decision("hold", "up-recent", **base)
            if effective > 1 and (
                demand_ms / (effective - 1) > self.qos_device_ms_budget
            ):
                return Decision("hold", "qos-budget", **base)
            self.last_down_ts = now
            self._down_streak = 0
            return Decision("down", "idle", **base)

        return Decision("hold", "steady", **base)

    def restore(self, records: list[dict], now: float) -> None:
        """Restore cooldown anchors from replayed journal records.  A
        recorded clock ahead of OUR clock (the previous process lived
        on a different monotonic epoch) clamps to now — the conservative
        read: a full cooldown after restart, never a skipped one."""
        for rec in records:
            ts = rec.get("clock")
            if not isinstance(ts, (int, float)):
                continue
            ts = min(float(ts), now)
            if rec.get("action") == "up":
                self.last_up_ts = max(self.last_up_ts, ts)
            elif rec.get("action") == "down":
                self.last_down_ts = max(self.last_down_ts, ts)


# ------------------------------------------------------------ launchers


class LaunchError(RuntimeError):
    """A launch attempt failed before the backend existed — retryable,
    and by construction never counted as fleet capacity."""


class LaunchedBackend:
    __slots__ = ("name", "handle", "t_launch")

    def __init__(self, name: str, handle=None, t_launch: float = 0.0):
        self.name = name          # host:port
        self.handle = handle      # actuator-private (subprocess.Popen)
        self.t_launch = t_launch  # controller clock at launch


class BackendLauncher:
    """The actuator interface a real deployment implements: ``launch``
    returns the new backend's ``host:port`` (or None for an advisory
    actuator that only records intent); ``reap`` tears one down AFTER
    the controller has drained it and proven the jobs tier empty."""

    async def launch(self) -> LaunchedBackend | None:
        raise NotImplementedError

    async def reap(self, name: str, handle=None) -> None:
        raise NotImplementedError


class AdvisoryLauncher(BackendLauncher):
    """Dry-run actuator: records every intent, changes nothing.  The
    rollout mode — run the controller against production signals,
    read its journal/metrics, and only then hand it a real launcher."""

    def __init__(self) -> None:
        self.intents: list[str] = []

    async def launch(self) -> LaunchedBackend | None:
        self.intents.append("launch")
        return None

    async def reap(self, name: str, handle=None) -> None:
        self.intents.append(f"reap {name}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class SubprocessLauncher(BackendLauncher):
    """Real-process actuator for drills and single-host deployments:
    ``argv_template`` elements are ``str.format``-ed with ``port`` (and
    ``host``), e.g.::

        python -m deconv_api_tpu_torch serve --port {port} \\
            --aot-dir /srv/aot --l2-dir /srv/l2/b{port} \\
            --fleet-routers 127.0.0.1:8100 --fleet-token T

    The launched process is expected to self-register — the
    launcher's job ends at a live PID; registration, warmth, and reap
    gating are the controller's."""

    def __init__(
        self,
        argv_template: list[str] | str,
        *,
        host: str = "127.0.0.1",
        env: dict | None = None,
        cwd: str | None = None,
    ):
        if isinstance(argv_template, str):
            argv_template = shlex.split(argv_template)
        if not argv_template:
            raise ValueError("launch command must not be empty")
        self.argv_template = list(argv_template)
        self.host = host
        self.env = env
        self.cwd = cwd
        self.procs: dict[str, subprocess.Popen] = {}

    async def launch(self) -> LaunchedBackend:
        port = _free_port()
        argv = [
            a.format(port=port, host=self.host) for a in self.argv_template
        ]
        try:
            proc = subprocess.Popen(
                argv,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                env=self.env,
                cwd=self.cwd,
            )
        except OSError as e:
            raise LaunchError(f"spawn failed: {e}") from e
        await asyncio.sleep(0.05)
        if proc.poll() is not None:
            raise LaunchError(
                f"backend exited rc={proc.returncode} before serving"
            )
        name = f"{self.host}:{port}"
        self.procs[name] = proc
        return LaunchedBackend(name, handle=proc)

    async def reap(self, name: str, handle=None) -> None:
        proc = handle or self.procs.pop(name, None)
        self.procs.pop(name, None)
        if proc is None:
            return
        proc.terminate()
        for _ in range(50):
            if proc.poll() is not None:
                return
            await asyncio.sleep(0.1)
        proc.kill()
        proc.wait(timeout=5)


# ----------------------------------------------------------- controller


class AutoscaleController:
    """The loop: poll the federation plane, decide, journal, act.

    Embedded (``router=`` set): polls the router's own
    ``_metrics_fleet`` handler in-process, drains via the router's
    member state, counts fleet size from the live ring.  Sidecar
    (``router_addr=`` set): the exact same loop over HTTP — the
    federation scrape, and drain announcements through the
    token-authenticated ``POST /v1/internal/register`` surface.

    ``mode`` is ``advisory`` (decide + journal + publish, never act) or
    ``enforce`` (act through the launcher).  Construction with
    ``mode="off"`` is a caller bug — the escape hatch is the ABSENCE of
    this object (fleet.py holds ``autoscaler=None``), not a disabled
    instance."""

    def __init__(
        self,
        *,
        mode: str = "advisory",
        router=None,
        router_addr: str = "",
        fleet_token: str = "",
        interval_s: float = 5.0,
        journal_path: str = "",
        launch_cmd: str = "",
        launcher: BackendLauncher | None = None,
        engine: DecisionEngine | None = None,
        engine_opts: dict | None = None,
        faults: "faults_mod.FaultRegistry | None" = None,
        metrics: Metrics | None = None,
        launch_retries: int = 3,
        retry_backoff_s: float = 1.0,
        warm_timeout_s: float = 120.0,
        drain_grace_s: float = 60.0,
        drain_settle_s: float = 1.0,
        jobs_poll_timeout_s: float = 5.0,
        arrival_bucket_s: float = 5.0,
        tsdb=None,
        tsdb_metrics: Metrics | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if mode not in ("advisory", "enforce"):
            raise ValueError(
                f"autoscale mode {mode!r}: expected advisory|enforce "
                "(off means: do not construct a controller)"
            )
        if router is None and not router_addr:
            raise ValueError(
                "controller needs a router (embedded) or router_addr "
                "(sidecar)"
            )
        self.mode = mode
        self.router = router
        self.router_addr = router_addr
        self.fleet_token = fleet_token
        self.interval_s = max(0.05, float(interval_s))
        self._clock = clock
        self.faults = faults
        self.metrics = metrics or Metrics(prefix="autoscaler", core=False)
        self.engine = engine or DecisionEngine(
            clock=clock, **(engine_opts or {})
        )
        if launcher is None:
            launcher = (
                SubprocessLauncher(launch_cmd)
                if launch_cmd
                else AdvisoryLauncher()
            )
        self.launcher = launcher
        self.launch_retries = max(0, int(launch_retries))
        self.retry_backoff_s = max(0.0, float(retry_backoff_s))
        self.warm_timeout_s = float(warm_timeout_s)
        self.drain_grace_s = float(drain_grace_s)
        self.drain_settle_s = max(0.0, float(drain_settle_s))
        self.jobs_poll_timeout_s = float(jobs_poll_timeout_s)
        # With a router-side TSDB, the forecaster reads
        # per-tenant arrival history from it (TsdbArrivalHistory) — the
        # same series an operator queries at /v1/metrics/history — and
        # the private accumulator stays the tsdb=off fallback.
        if tsdb is not None:
            self.arrivals = TsdbArrivalHistory(
                tsdb, tsdb_metrics or self.metrics,
                bucket_s=arrival_bucket_s,
            )
        else:
            self.arrivals = ArrivalHistory(
                bucket_s=arrival_bucket_s, clock=clock
            )
        self.journal = (
            DecisionJournal(journal_path, metrics=self.metrics)
            if journal_path else None
        )
        if journal_path:
            self.engine.restore(
                DecisionJournal.replay(journal_path), clock()
            )
        # launches awaiting first warm hit: name -> LaunchedBackend.
        # ONE launch in flight at a time — a retry replaces, never
        # stacks, so fleet size is never double-counted.
        self.pending: dict[str, LaunchedBackend] = {}
        # drain watchers: name -> asyncio.Task
        self.draining: dict[str, asyncio.Task] = {}
        self._task: asyncio.Task | None = None
        self._last_decision: dict | None = None
        self._last_signals: FleetSignals | None = None
        self.ticks_total = 0
        # pre-register every counter family at zero: the lint and rate()
        # queries must see them from the first scrape, fired or not
        for fam in ("errors_total", "launch_failures_total",
                    "reap_blocked_total", "reaped_total"):
            self.metrics.inc_counter(fam, 0)
        self.metrics.inc_labeled(
            "decisions_total", ("action", "reason"), ("hold", "steady"), 0
        )
        self.metrics.set_gauge("fleet_size", 0)
        self.metrics.set_gauge("pending_launches", 0)

    # -- surfaces ------------------------------------------------------

    def record_arrival(self, tenant: str) -> None:
        """Proxy hot-path hook (fleet.py): one O(1) bucket increment."""
        self.arrivals.record(tenant or "default")

    def config_block(self) -> dict:
        e = self.engine
        return {
            "mode": self.mode,
            "interval_s": self.interval_s,
            "min_backends": e.min_backends,
            "max_backends": e.max_backends,
            "up_burn": e.up_burn,
            "up_queue": e.up_queue,
            "down_burn": e.down_burn,
            "down_queue": e.down_queue,
            "up_consecutive": e.up_consecutive,
            "down_consecutive": e.down_consecutive,
            "cooldown_up_s": e.cooldown_up_s,
            "cooldown_down_s": e.cooldown_down_s,
            "qos_device_ms_budget": e.qos_device_ms_budget,
            "predict_horizon_s": e.predict_horizon_s,
            "predict_ramp": e.predict_ramp,
            "journal": self.journal.path if self.journal else None,
            "launcher": type(self.launcher).__name__,
        }

    def ready_block(self) -> dict:
        s = self._last_signals
        return {
            "mode": self.mode,
            "ticks": self.ticks_total,
            "pending_launches": len(self.pending),
            "draining": sorted(self.draining),
            "burn_5m_max": round(s.burn_max("5m"), 4) if s else None,
            "queue_mean": round(s.queue_mean(), 3) if s else None,
            "last_decision": self._last_decision,
            "errors_total": self.metrics.counter("errors_total"),
        }

    # -- polling -------------------------------------------------------

    async def _poll_text(self) -> str:
        if self.router is not None:
            resp = await self.router._metrics_fleet(None)
            body = resp.body
            return body.decode() if isinstance(body, bytes) else str(body)
        host, _, port = self.router_addr.rpartition(":")
        status, _h, body = await fleet_mod.raw_request(
            host, int(port), "GET", "/v1/metrics/fleet", {}, b"",
            self.jobs_poll_timeout_s,
        )
        if status != 200:
            raise RuntimeError(f"federation scrape: HTTP {status}")
        return body.decode(errors="replace")

    def _fleet_size(self, signals: FleetSignals) -> int:
        if self.router is not None:
            return sum(
                1 for m in self.router.members.values()
                if m.in_ring and not m.announced_drain
            )
        # sidecar: the scraped-OK backends ARE the live fleet, minus
        # the ones we are currently draining
        return sum(
            1 for b, ok in signals.scrape_ok.items()
            if ok and b not in self.draining
        )

    # -- the loop ------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await self.tick()
            await asyncio.sleep(self.interval_s)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for t in list(self.draining.values()):
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
        self.draining.clear()
        if self.journal is not None:
            self.journal.close()

    async def tick(self) -> None:
        """One control iteration, fail-STATIC: any error — a scrape
        gone wrong, a parse surprise, the ``autoscale.decision_error``
        chaos site — counts ``autoscaler_errors_total`` and changes
        nothing.  The fleet a broken controller manages keeps its last
        size; flapping is strictly worse than stasis."""
        try:
            await self._tick_inner()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — fail-static by contract
            self.metrics.inc_counter("errors_total")
            slog.event(
                _log, "autoscale_tick_error", level=logging.WARNING,
                error=str(e),
            )

    async def _tick_inner(self) -> None:
        self.ticks_total += 1
        if self.faults is not None:
            act = self.faults.check("autoscale.decision_error")
            if act is not None:
                raise RuntimeError("injected decision error")
        signals = FleetSignals.from_exposition(await self._poll_text())
        self._last_signals = signals
        fleet_size = self._fleet_size(signals)
        self.metrics.set_gauge("fleet_size", fleet_size)
        self.metrics.set_gauge("pending_launches", len(self.pending))
        self._check_pending_warm(signals)
        decision = self.engine.evaluate(
            signals, fleet_size,
            pending=len(self.pending) + len(self.draining),
            arrivals=self.arrivals,
        )
        self._last_decision = decision.to_dict()
        if decision.action != "hold" or decision.reason != "steady":
            # every decision that is (or blocks) an action is journaled
            # and counted; the steady-state hold is neither
            self.metrics.inc_labeled(
                "decisions_total", ("action", "reason"),
                (decision.action, decision.reason),
            )
            self._journal({
                "kind": "decision", **decision.to_dict(),
                "mode": self.mode, "clock": self._clock(),
            })
        if self.mode != "enforce":
            return
        if decision.action == "up":
            await self._scale_up(decision)
        elif decision.action == "down":
            await self._scale_down(decision)

    def _journal(self, record: dict) -> None:
        if self.journal is not None:
            self.journal.append(record)
        if self.router is not None and self.router.recorder is not None:
            # decision spans on the router's flight-recorder spine: the
            # controller's actions are debuggable next to the requests
            # they were taken for
            tr = fleet_mod.RequestTrace(
                f"autoscale-{self.ticks_total:06d}", "autoscale"
            )
            tr.annotate(**{
                k: v for k, v in record.items() if k != "kind"
            })
            tr.finish(200)
            self.router.recorder.record(tr)

    # -- scale up ------------------------------------------------------

    async def _scale_up(self, decision: Decision) -> None:
        if self.pending:
            return  # one launch in flight; never stack (no double-count)
        lb: LaunchedBackend | None = None
        for attempt in range(self.launch_retries + 1):
            try:
                if self.faults is not None:
                    act = self.faults.check("autoscale.launch_fail")
                    if act is not None:
                        raise LaunchError("injected launch failure")
                lb = await self.launcher.launch()
                break
            except Exception as e:  # noqa: BLE001 — retry with backoff
                self.metrics.inc_counter("launch_failures_total")
                self._journal({
                    "kind": "launch_failed", "attempt": attempt,
                    "error": str(e), "clock": self._clock(),
                })
                if attempt >= self.launch_retries:
                    self.metrics.inc_counter("errors_total")
                    return
                await asyncio.sleep(
                    self.retry_backoff_s * (2 ** attempt)
                )
        if lb is None:
            return  # advisory launcher: intent recorded, nothing to track
        lb.t_launch = self._clock()
        self.pending[lb.name] = lb
        self.metrics.set_gauge("pending_launches", len(self.pending))
        self._journal({
            "kind": "launched", "backend": lb.name,
            "reason": decision.reason, "clock": self._clock(),
        })

    def _check_pending_warm(self, signals: FleetSignals) -> None:
        """Stop the boot-to-first-warm-hit clock: the launched backend
        has self-registered (it appears on the federation plane) AND a
        warm-hit counter moved.  Registration is part of the measured
        path on purpose — the metric is the operator's answer to "how
        long until a launch actually absorbs load warm"."""
        for name, lb in list(self.pending.items()):
            registered = signals.scrape_ok.get(name, False)
            if self.router is not None:
                m = self.router.members.get(name)
                registered = m is not None and m.in_ring
            if registered and signals.warm_hits.get(name, 0.0) > 0:
                dt = self._clock() - lb.t_launch
                self.metrics.observe_hist(
                    "boot_to_warm_seconds", "backend", name, dt
                )
                self.metrics.set_gauge("last_boot_to_warm_seconds", dt)
                self._journal({
                    "kind": "warm", "backend": name,
                    "boot_to_warm_s": round(dt, 3),
                    "clock": self._clock(),
                })
                del self.pending[name]
            elif self._clock() - lb.t_launch > self.warm_timeout_s:
                self.metrics.inc_counter("errors_total")
                self._journal({
                    "kind": "warm_timeout", "backend": name,
                    "clock": self._clock(),
                })
                del self.pending[name]
        self.metrics.set_gauge("pending_launches", len(self.pending))

    # -- scale down ----------------------------------------------------

    def _pick_victim(self, signals: FleetSignals) -> str | None:
        """Lowest job pressure wins; prefer backends this controller's
        launcher owns a handle for (it can actually reap those)."""
        if self.router is not None:
            candidates = [
                m.name for m in self.router.members.values()
                if m.in_ring and not m.announced_drain
                and m.name not in self.draining
            ]
        else:
            candidates = [
                b for b, ok in signals.scrape_ok.items()
                if ok and b not in self.draining
            ]
        candidates = [c for c in candidates if c not in self.pending]
        if not candidates:
            return None
        owned = getattr(self.launcher, "procs", {})
        candidates.sort(
            key=lambda n: (n not in owned, signals.queue_depth.get(n, 0.0))
        )
        return candidates[0]

    async def _scale_down(self, decision: Decision) -> None:
        if self.draining:
            return  # one drain at a time: losses compound, savings don't
        signals = self._last_signals
        victim = self._pick_victim(signals) if signals else None
        if victim is None:
            return
        await self._announce_drain(victim)
        self._journal({
            "kind": "drain_announced", "backend": victim,
            "reason": decision.reason, "clock": self._clock(),
        })
        self.draining[victim] = asyncio.create_task(
            self._drain_and_reap(victim)
        )

    async def _announce_drain(self, name: str) -> None:
        if self.router is not None:
            m = self.router.members.get(name)
            if m is not None:
                self.router._mark_announced_drain(m, "autoscale")
                self.router._persist_membership()
            return
        host, _, port = self.router_addr.rpartition(":")
        await fleet_mod.raw_request(
            host, int(port), "POST", "/v1/internal/register",
            {
                "x-fleet-token": self.fleet_token,
                "content-type": "application/x-www-form-urlencoded",
            },
            f"backend={name}&action=drain".encode(),
            self.jobs_poll_timeout_s,
        )

    async def _jobs_clear(self, name: str) -> bool:
        """The jobs-tier reap gate: ``/v1/jobs`` must show ZERO
        running/parked jobs.  Unreachable or malformed reads as NOT
        clear — a backend that cannot prove its jobs are terminal or
        re-claimed is never reaped on a guess."""
        host, _, port = name.rpartition(":")
        try:
            status, _h, body = await fleet_mod.raw_request(
                host, int(port), "GET", "/v1/jobs", {}, b"",
                self.jobs_poll_timeout_s,
            )
            if status != 200:
                return False
            counts = json.loads(body).get("counts", {})
        except Exception:  # noqa: BLE001 — unreachable = cannot prove
            return False
        return (
            counts.get("running", 0) + counts.get("parked", 0)
        ) == 0

    async def _drain_and_reap(self, name: str) -> None:
        try:
            deadline = self._clock() + self.drain_grace_s
            clear = False
            while self._clock() < deadline:
                clear = await self._jobs_clear(name)
                if clear:
                    break
                await asyncio.sleep(min(1.0, self.interval_s))
            if not clear:
                # fail static: the backend keeps running (and keeps its
                # drain announcement — no new keyed traffic), the
                # operator sees the blocked reap on the plane
                self.metrics.inc_counter("reap_blocked_total")
                self._journal({
                    "kind": "reap_blocked", "backend": name,
                    "clock": self._clock(),
                })
                return
            # in-flight settle: the jobs tier is provably empty; give
            # already-accepted responses a beat to flush before SIGTERM
            await asyncio.sleep(self.drain_settle_s)
            lb = self.pending.pop(name, None)
            await self.launcher.reap(
                name, lb.handle if lb is not None else None
            )
            self.metrics.inc_counter("reaped_total")
            self._journal({
                "kind": "reaped", "backend": name, "clock": self._clock(),
            })
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — fail-static
            self.metrics.inc_counter("errors_total")
            slog.event(
                _log, "autoscale_reap_error", level=logging.WARNING,
                backend=name, error=str(e),
            )
        finally:
            self.draining.pop(name, None)


# -------------------------------------------------------------- sidecar


def main(argv: list[str] | None = None) -> int:
    """``python -m deconv_api_tpu_torch autoscaler`` — the sidecar entrypoint: the SAME
    controller the router embeds, run out-of-process against a router's
    federation surface.  Advisory by default; ``--mode enforce`` with a
    ``--launch-cmd`` makes it a real actuator."""
    import argparse

    p = argparse.ArgumentParser(description="deconv fleet autoscaler")
    p.add_argument(
        "--router", required=True, metavar="HOST:PORT",
        help="router whose /v1/metrics/fleet federation surface to poll",
    )
    p.add_argument(
        "--mode", choices=("advisory", "enforce"), default="advisory",
        help="advisory: decide+journal only; enforce: act via launcher",
    )
    p.add_argument("--interval-s", type=float, default=5.0)
    p.add_argument(
        "--journal", default="", metavar="PATH",
        help="fsync'd JSONL decision journal (replayed on restart)",
    )
    p.add_argument(
        "--launch-cmd", default="",
        help="backend launch argv template, {port} substituted "
        "(enforce mode)",
    )
    p.add_argument(
        "--fleet-token", default=os.environ.get("FLEET_TOKEN", ""),
        help="shared secret for drain announcements "
        "(env FLEET_TOKEN)",
    )
    p.add_argument("--min-backends", type=int, default=1)
    p.add_argument("--max-backends", type=int, default=4)
    p.add_argument("--up-burn", type=float, default=0.9)
    p.add_argument("--up-queue", type=float, default=4.0)
    p.add_argument("--down-burn", type=float, default=0.2)
    p.add_argument("--down-queue", type=float, default=0.5)
    p.add_argument("--cooldown-up-s", type=float, default=30.0)
    p.add_argument("--cooldown-down-s", type=float, default=120.0)
    p.add_argument("--qos-budget-ms", type=float, default=800.0)
    p.add_argument(
        "--once", action="store_true",
        help="single tick; print the decision as JSON and exit "
        "(cron-mode / smoke test)",
    )
    args = p.parse_args(argv)

    ctl = AutoscaleController(
        mode=args.mode,
        router_addr=args.router,
        fleet_token=args.fleet_token,
        interval_s=args.interval_s,
        journal_path=args.journal,
        launch_cmd=args.launch_cmd,
        engine_opts={
            "min_backends": args.min_backends,
            "max_backends": args.max_backends,
            "up_burn": args.up_burn,
            "up_queue": args.up_queue,
            "down_burn": args.down_burn,
            "down_queue": args.down_queue,
            "cooldown_up_s": args.cooldown_up_s,
            "cooldown_down_s": args.cooldown_down_s,
            "qos_device_ms_budget": args.qos_budget_ms,
        },
    )

    async def _run() -> int:
        if args.once:
            await ctl.tick()
            print(json.dumps(ctl.ready_block(), sort_keys=True))
            if ctl.journal is not None:
                ctl.journal.close()
            return 0
        slog.configure()
        slog.event(
            _log, "autoscaler_start", router=args.router, mode=args.mode,
        )
        import signal

        stop_ev = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop_ev.set)
            except NotImplementedError:  # pragma: no cover — non-unix
                pass
        ctl.start()
        await stop_ev.wait()
        await ctl.stop()
        return 0

    return asyncio.run(_run())


if __name__ == "__main__":
    raise SystemExit(main())
