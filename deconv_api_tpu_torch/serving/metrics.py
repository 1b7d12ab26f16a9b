"""Request/batch metrics with a Prometheus-style text exposition (a copy of
``escape_label``, ``_Reservoir``, ``Metrics`` and the latency SLOs
(``SloTracker``, ``parse_slos``, ``slo_prometheus``, ``SLO_WINDOWS``) of
``deconv_api_tpu/serving/metrics.py``, with the same family names and
exposition text).

The service keeps one registry per dispatcher stream: ``deconv`` (``POST
/`` and ``/v1/deconv``, and the weight manager's families) and ``dream``.
``GET /metrics`` concatenates their expositions: request latency quantiles,
batch sizes, images/s, per-stage seconds, and the named and labeled
counters and gauges.
"""

from __future__ import annotations

import bisect
import collections
import re
import threading
import time
from typing import Callable

# Fixed latency-histogram bucket bounds in SECONDS: quantile reservoirs
# cannot be aggregated across processes, fixed buckets add up.  The +Inf
# bucket is implicit (index len(HIST_BUCKETS_S)).
HIST_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote and newline
    must be escaped inside the quoted value (exposition format spec)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class _Reservoir:
    """Bounded sliding-window sample for quantiles (the caller holds the
    lock).  The deque eviction is O(1); the sorted list's insort/pop are
    O(n) memmoves, about 1 us per sample at cap 4096, against requests
    measured in milliseconds."""

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._sorted: list[float] = []
        self._ring: collections.deque[float] = collections.deque()

    def add(self, v: float) -> None:
        if len(self._ring) >= self._cap:
            old = self._ring.popleft()
            i = bisect.bisect_left(self._sorted, old)
            self._sorted.pop(i)
        self._ring.append(v)
        bisect.insort(self._sorted, v)

    def quantile(self, q: float) -> float:
        if not self._sorted:
            return 0.0
        i = min(len(self._sorted) - 1, int(q * len(self._sorted)))
        return self._sorted[i]

    def __len__(self) -> int:
        return len(self._sorted)


class Metrics:
    def __init__(self, prefix: str = "deconv", *, core: bool = True):
        # core=False: only the generic counter/gauge/labeled/stage
        # families, without the request/batch pipeline families
        self._prefix = prefix
        self._core = core
        self._lock = threading.Lock()
        self._started = time.time()
        self.requests_total = 0
        self.errors_total: dict[str, int] = {}
        self.images_total = 0
        self.batches_total = 0
        self._latency = _Reservoir()
        self._batch_size = _Reservoir()
        self._compute = _Reservoir()
        self._cadence = _Reservoir()
        self._queue_wait = _Reservoir()
        self._stage: dict[str, _Reservoir] = {}
        self._gauges: dict[str, float] = {}
        self._counters: dict[str, int] = {}
        # family -> (label name, {label value: count}); one label name (or
        # one tuple of names) per family, like errors_total{code=...}
        self._labeled: dict[str, tuple[str, dict[str, int]]] = {}
        # family -> (label name, {label value: gauge}), e.g.
        # resident_models{lane=...}
        self._labeled_gauges: dict[str, tuple[str, dict[str, float]]] = {}
        # family -> (label names, {label values: [per-bucket counts, sum,
        # count, exemplars]}): counts are stored per bucket and cumulated
        # at render, so every exposition is le-monotone
        self._hists: dict[str, tuple[tuple, dict]] = {}

    def observe_request(self, latency_s: float, error_code: str | None = None) -> None:
        with self._lock:
            self.requests_total += 1
            self._latency.add(latency_s)
            if error_code:
                self.errors_total[error_code] = self.errors_total.get(error_code, 0) + 1

    def observe_batch(self, size: int, compute_s: float, queue_s: float) -> int:
        """Record one executed batch; returns the batch id, the monotone
        ordinal of this batch on this metrics stream."""
        with self._lock:
            self.batches_total += 1
            self.images_total += size
            self._batch_size.add(float(size))
            self._compute.add(compute_s)
            self._queue_wait.add(queue_s)
            return self.batches_total

    def observe_cadence(self, cadence_s: float) -> None:
        """Interval between consecutive batch completions while more work
        was in flight: the dispatcher's sustained per-batch rate."""
        with self._lock:
            self._cadence.add(cadence_s)

    def cadence_p50(self) -> float:
        with self._lock:
            return self._cadence.quantile(0.50)

    def compute_p50(self) -> float:
        """Median per-batch compute seconds."""
        with self._lock:
            return self._compute.quantile(0.50)

    def batch_size_p50(self) -> float:
        """Median executed batch size."""
        with self._lock:
            return self._batch_size.quantile(0.50)

    def observe_stage(self, stage: str, seconds: float) -> None:
        """Per-stage request timing (decode, encode, weight_page_in)."""
        with self._lock:
            self._stage.setdefault(stage, _Reservoir()).add(seconds)

    def inc_counter(self, name: str, n: int = 1) -> None:
        """Named monotonic counters, exposed in the JSON snapshot under
        "counters" and as `# TYPE <prefix>_<name> counter` lines."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def inc_labeled(self, family: str, label, value, n: float = 1) -> None:
        """Labeled monotonic counters: one counter family, one sample line
        per label value.  ``label`` and ``value`` are both strings, or
        matching tuples for a multi-label family; increments may be
        fractional."""
        if isinstance(label, tuple) != isinstance(value, tuple):
            raise TypeError("label and value must both be str or both tuple")
        if isinstance(label, tuple) and len(label) != len(value):
            raise ValueError(
                f"labeled family {family!r}: {len(label)} label names "
                f"but {len(value)} values"
            )
        with self._lock:
            stored_label, series = self._labeled.setdefault(family, (label, {}))
            if stored_label != label:
                raise ValueError(
                    f"labeled family {family!r} already uses label "
                    f"{stored_label!r}"
                )
            series[value] = series.get(value, 0) + n

    def labeled(self, family: str) -> dict:
        """{label value(s): count} for one labeled-counter family."""
        with self._lock:
            _, series = self._labeled.get(family, ("", {}))
            return dict(series)

    def observe_hist(
        self, family: str, label, value, seconds: float, exemplar: str | None = None,
    ) -> None:
        """Fixed-bucket latency histogram observation (``HIST_BUCKETS_S``
        for every family).  ``label``/``value`` follow ``inc_labeled``;
        ``exemplar`` is a request id, each bucket keeping the most recent
        one, rendered as an OpenMetrics exemplar."""
        if isinstance(label, tuple) != isinstance(value, tuple):
            raise TypeError("label and value must both be str or both tuple")
        if isinstance(label, tuple) and len(label) != len(value):
            raise ValueError(
                f"histogram family {family!r}: {len(label)} label names "
                f"but {len(value)} values"
            )
        i = bisect.bisect_left(HIST_BUCKETS_S, seconds)
        with self._lock:
            stored_label, series = self._hists.setdefault(family, (label, {}))
            if stored_label != label:
                raise ValueError(
                    f"histogram family {family!r} already uses label "
                    f"{stored_label!r}"
                )
            h = series.get(value)
            if h is None:
                h = series[value] = [
                    [0] * (len(HIST_BUCKETS_S) + 1), 0.0, 0,
                    [None] * (len(HIST_BUCKETS_S) + 1),
                ]
            h[0][i] += 1
            h[1] += seconds
            h[2] += 1
            if exemplar is not None:
                h[3][i] = (exemplar, seconds)

    def hist_series(self, family: str) -> dict:
        """{label values: {"buckets": per-bucket counts, "sum": seconds,
        "count": n}} for one histogram family."""
        with self._lock:
            _, series = self._hists.get(family, ((), {}))
            return {
                k: {"buckets": list(h[0]), "sum": h[1], "count": h[2]}
                for k, h in series.items()
            }

    def set_labeled_gauge(self, family: str, label: str, value: str, v: float) -> None:
        """Labeled instantaneous gauges: one gauge family, one sample line
        per label value."""
        with self._lock:
            _, series = self._labeled_gauges.setdefault(family, (label, {}))
            series[value] = float(v)

    def labeled_gauge(self, family: str) -> dict[str, float]:
        """{label value: gauge} for one labeled-gauge family."""
        with self._lock:
            _, series = self._labeled_gauges.get(family, ("", {}))
            return dict(series)

    def set_gauge(self, name: str, value: float) -> None:
        """Instantaneous gauges (e.g. warmup_seconds)."""
        with self._lock:
            self._gauges[name] = float(value)

    def snapshot(self, *, _join_labeled: bool = True) -> dict:
        # _join_labeled=False is prometheus()'s view: "labeled" and
        # "histograms" keep their raw tuple keys instead of the JSON-able
        # comma join
        with self._lock:
            up = time.time() - self._started
            return {
                "uptime_s": up,
                "requests_total": self.requests_total,
                "errors_total": dict(self.errors_total),
                "images_total": self.images_total,
                "batches_total": self.batches_total,
                "images_per_sec": self.images_total / up if up > 0 else 0.0,
                "latency_p50_s": self._latency.quantile(0.50),
                "latency_p99_s": self._latency.quantile(0.99),
                "batch_size_p50": self._batch_size.quantile(0.50),
                "compute_p50_s": self._compute.quantile(0.50),
                "batch_cadence_p50_s": self._cadence.quantile(0.50),
                "queue_wait_p50_s": self._queue_wait.quantile(0.50),
                "stages": {
                    k: {"p50_s": r.quantile(0.5), "p99_s": r.quantile(0.99)}
                    for k, r in self._stage.items()
                },
                "gauges": dict(self._gauges),
                "counters": dict(self._counters),
                "labeled": (
                    {
                        fam: (
                            list(label) if isinstance(label, tuple) else label,
                            {
                                (",".join(k) if isinstance(k, tuple) else k): v
                                for k, v in series.items()
                            },
                        )
                        for fam, (label, series) in self._labeled.items()
                    }
                    if _join_labeled
                    else {
                        fam: (label, dict(series))
                        for fam, (label, series) in self._labeled.items()
                    }
                ),
                "labeled_gauges": {
                    fam: (label, dict(series))
                    for fam, (label, series) in self._labeled_gauges.items()
                },
                "histograms": (
                    {
                        fam: (
                            list(label) if isinstance(label, tuple) else label,
                            {
                                (",".join(k) if isinstance(k, tuple) else k): {
                                    "buckets": list(h[0]),
                                    "sum": round(h[1], 6),
                                    "count": h[2],
                                }
                                for k, h in series.items()
                            },
                        )
                        for fam, (label, series) in self._hists.items()
                    }
                    if _join_labeled
                    else {
                        fam: (
                            label,
                            {
                                k: [list(h[0]), h[1], h[2], list(h[3])]
                                for k, h in series.items()
                            },
                        )
                        for fam, (label, series) in self._hists.items()
                    }
                ),
            }

    def prometheus(self) -> str:
        p = self._prefix
        s = self.snapshot(_join_labeled=False)
        lines = [] if not self._core else [
            f"# TYPE {p}_requests_total counter",
            f"{p}_requests_total {s['requests_total']}",
            f"# TYPE {p}_images_total counter",
            f"{p}_images_total {s['images_total']}",
            f"# TYPE {p}_batches_total counter",
            f"{p}_batches_total {s['batches_total']}",
            f"# TYPE {p}_request_latency_seconds summary",
            f'{p}_request_latency_seconds{{quantile="0.5"}} {s["latency_p50_s"]:.6f}',
            f'{p}_request_latency_seconds{{quantile="0.99"}} {s["latency_p99_s"]:.6f}',
            f"# TYPE {p}_images_per_sec gauge",
            f"{p}_images_per_sec {s['images_per_sec']:.3f}",
            f"# TYPE {p}_batch_size summary",
            f'{p}_batch_size{{quantile="0.5"}} {s["batch_size_p50"]:.1f}',
            f"# HELP {p}_batch_compute_seconds dispatch-to-fetch wall; "
            "overlaps other batches when pipelined — see batch_cadence_seconds",
            f"# TYPE {p}_batch_compute_seconds summary",
            f'{p}_batch_compute_seconds{{quantile="0.5"}} {s["compute_p50_s"]:.6f}',
            f"# TYPE {p}_batch_cadence_seconds summary",
            f'{p}_batch_cadence_seconds{{quantile="0.5"}} '
            f'{s["batch_cadence_p50_s"]:.6f}',
            f"# TYPE {p}_queue_wait_seconds summary",
            f'{p}_queue_wait_seconds{{quantile="0.5"}} {s["queue_wait_p50_s"]:.6f}',
        ]
        if s["errors_total"]:
            lines.append(f"# HELP {p}_errors_total requests failed, by taxonomy code")
            lines.append(f"# TYPE {p}_errors_total counter")
            for code, n in sorted(s["errors_total"].items()):
                lines.append(f'{p}_errors_total{{code="{escape_label(code)}"}} {n}')
        if s["stages"]:
            lines.append(f"# HELP {p}_stage_seconds per-request pipeline stage wall time")
            lines.append(f"# TYPE {p}_stage_seconds summary")
            for stage, q in sorted(s["stages"].items()):
                esc = escape_label(stage)
                lines.append(f'{p}_stage_seconds{{stage="{esc}",quantile="0.5"}} {q["p50_s"]:.6f}')
                lines.append(f'{p}_stage_seconds{{stage="{esc}",quantile="0.99"}} {q["p99_s"]:.6f}')
        for name, n in sorted(s["counters"].items()):
            lines.append(f"# TYPE {p}_{name} counter")
            lines.append(f"{p}_{name} {n}")
        # labeled counters: one TYPE header per family
        for fam, (label, series) in sorted(s["labeled"].items()):
            lines.append(f"# TYPE {p}_{fam} counter")
            names = label if isinstance(label, tuple) else (label,)
            for value, n in sorted(series.items()):
                values = value if isinstance(value, tuple) else (value,)
                block = ",".join(f'{k}="{escape_label(v)}"' for k, v in zip(names, values))
                # ints render exact; float accumulators round to 3dp
                num = f"{int(n)}" if float(n).is_integer() else f"{n:.3f}"
                lines.append(f"{p}_{fam}{{{block}}} {num}")
        # fixed-bucket histograms: cumulative le= buckets + _sum/_count per
        # labelset, each bucket with its most recent exemplar
        for fam, (label, series) in sorted(s["histograms"].items()):
            lines.append(f"# HELP {p}_{fam} fixed-bucket latency histogram (seconds)")
            lines.append(f"# TYPE {p}_{fam} histogram")
            names = label if isinstance(label, tuple) else (label,)
            for value, (buckets, total, count, exem) in sorted(series.items()):
                values = value if isinstance(value, tuple) else (value,)
                block = ",".join(f'{k}="{escape_label(v)}"' for k, v in zip(names, values))
                cum = 0
                for i, (bound, n) in enumerate(zip(HIST_BUCKETS_S, buckets)):
                    cum += n
                    line = f'{p}_{fam}_bucket{{{block},le="{bound:g}"}} {cum}'
                    if exem[i] is not None:
                        rid, obs = exem[i]
                        line += f' # {{trace_id="{escape_label(rid)}"}} {obs:.6f}'
                    lines.append(line)
                line = f'{p}_{fam}_bucket{{{block},le="+Inf"}} {count}'
                if exem[-1] is not None:
                    rid, obs = exem[-1]
                    line += f' # {{trace_id="{escape_label(rid)}"}} {obs:.6f}'
                lines.append(line)
                lines.append(f"{p}_{fam}_sum{{{block}}} {total:.6f}")
                lines.append(f"{p}_{fam}_count{{{block}}} {count}")
        # labeled gauges: one TYPE header per family, one line per value
        for fam, (label, series) in sorted(s["labeled_gauges"].items()):
            lines.append(f"# TYPE {p}_{fam} gauge")
            for value, v in sorted(series.items()):
                lines.append(f'{p}_{fam}{{{label}="{escape_label(value)}"}} {v:g}')
        for name, v in sorted(s["gauges"].items()):
            lines.append(f"# TYPE {p}_{name} gauge")
            lines.append(f"{p}_{name} {v:g}")
        return "\n".join(lines) + "\n"


# ----------------------------------------------------------------- SLOs

# Burn-rate windows: the classic fast/slow multiwindow pair.
# The 5m window catches a sharp regression within minutes; the 1h
# window catches a slow bleed that never trips the fast alarm.  A burn
# rate of 1.0 means the error budget is being spent exactly at the rate
# that exhausts it over the SLO period; >1 is overspend.
SLO_WINDOWS: dict[str, float] = {"5m": 300.0, "1h": 3600.0}

# Route-agnostic marker: an SLO with no route constraint.
_SLO_ANY_ROUTE = ""


class SloTracker:
    """One latency SLO: ``objective_pct`` of requests must finish under
    ``threshold_ms`` (5xx responses count as breaches regardless of
    latency — a fast 500 is not "within objective").

    Burn rates come from time-bucketed good/bad counters (10 s buckets,
    pruned past the longest window) under an injectable clock, so the
    math is deterministic in tests: over a window,

        burn = (bad / total) / (1 - objective)

    i.e. the observed error rate as a multiple of the rate that spends
    the error budget exactly.  An empty window reports 0.0 — no
    traffic, no burn.  Single-consumer: the serving
    event loop feeds and reads it; cumulative totals are plain ints."""

    def __init__(
        self,
        name: str,
        threshold_ms: float,
        objective_pct: float,
        route: str = _SLO_ANY_ROUTE,
        *,
        clock: Callable[[], float] = time.monotonic,
        bucket_s: float = 10.0,
    ):
        if not 0 < objective_pct < 100:
            raise ValueError(
                f"slo {name!r}: objective_pct must be in (0, 100), "
                f"got {objective_pct!r}"
            )
        if threshold_ms <= 0:
            raise ValueError(
                f"slo {name!r}: threshold_ms must be positive, "
                f"got {threshold_ms!r}"
            )
        self.name = name
        self.threshold_ms = float(threshold_ms)
        self.objective_pct = float(objective_pct)
        self.route = route
        self._budget = 1.0 - self.objective_pct / 100.0
        self._clock = clock
        self._bucket_s = float(bucket_s)
        # (bucket ordinal, total, bad), append-only at the right edge
        self._buckets: collections.deque[list] = collections.deque()
        self.requests_total = 0
        self.breaches_total = 0

    def matches(self, route: str) -> bool:
        return self.route == _SLO_ANY_ROUTE or self.route == route

    def observe(self, latency_s: float, status: int) -> None:
        bad = status >= 500 or latency_s * 1e3 > self.threshold_ms
        self.requests_total += 1
        if bad:
            self.breaches_total += 1
        ordinal = int(self._clock() / self._bucket_s)
        if self._buckets and self._buckets[-1][0] == ordinal:
            b = self._buckets[-1]
        else:
            self._buckets.append([ordinal, 0, 0])
            b = self._buckets[-1]
            self._prune(ordinal)
        b[1] += 1
        if bad:
            b[2] += 1

    def _prune(self, now_ordinal: int) -> None:
        horizon = max(SLO_WINDOWS.values()) / self._bucket_s
        while self._buckets and self._buckets[0][0] < now_ordinal - horizon:
            self._buckets.popleft()

    def _window_counts(self, window_s: float) -> tuple[int, int]:
        now_ordinal = int(self._clock() / self._bucket_s)
        cut = now_ordinal - window_s / self._bucket_s
        total = bad = 0
        for ordinal, t, b in reversed(self._buckets):
            if ordinal <= cut:
                break
            total += t
            bad += b
        return total, bad

    def burn_rates(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, window_s in SLO_WINDOWS.items():
            total, bad = self._window_counts(window_s)
            out[name] = (
                round((bad / total) / self._budget, 4) if total else 0.0
            )
        return out

    def snapshot(self) -> dict:
        return {
            "threshold_ms": self.threshold_ms,
            "objective_pct": self.objective_pct,
            "route": self.route or "*",
            "requests_total": self.requests_total,
            "breaches_total": self.breaches_total,
            "burn": self.burn_rates(),
        }


def parse_slos(
    spec: str,
    clock: Callable[[], float] = time.monotonic,
    observable_routes: "frozenset[str] | None" = None,
) -> list[SloTracker]:
    """Parse the ``slos`` config knob: comma-separated
    ``name=<threshold_ms>:<objective_pct>[:<route>]`` entries, e.g.
    ``api=250:99,deconv=100:99.9:/v1/deconv``.  A route-qualified SLO
    observes only that route family; unqualified ones observe every
    request on the surface.  Raises ValueError on any malformed entry —
    validated at boot, never silently dropped.  ``observable_routes``
    (when the caller knows its observation vocabulary) extends that
    promise to route scopes: an SLO pinned to a route the surface never
    observes would burn 0.0 forever while the route breaches — a typo'd
    route is a boot error, not a dead objective."""
    trackers: list[SloTracker] = []
    seen: set[str] = set()
    for entry in (e.strip() for e in spec.split(",") if e.strip()):
        name, sep, rest = entry.partition("=")
        name = name.strip()
        if not sep or not re.fullmatch(r"[A-Za-z0-9_\-]{1,64}", name):
            raise ValueError(
                f"slo entry {entry!r}: expected "
                "name=<threshold_ms>:<objective_pct>[:<route>]"
            )
        if name in seen:
            raise ValueError(f"duplicate slo name {name!r}")
        seen.add(name)
        parts = rest.split(":", 2)
        if len(parts) < 2:
            raise ValueError(
                f"slo {name!r}: expected <threshold_ms>:<objective_pct>"
            )
        try:
            threshold_ms = float(parts[0])
            objective_pct = float(parts[1])
        except ValueError:
            raise ValueError(
                f"slo {name!r}: threshold/objective must be numeric, "
                f"got {rest!r}"
            ) from None
        route = parts[2].strip() if len(parts) == 3 else _SLO_ANY_ROUTE
        if route and not route.startswith("/"):
            raise ValueError(
                f"slo {name!r}: route must start with '/', got {route!r}"
            )
        if route and observable_routes is not None and (
            route not in observable_routes
        ):
            raise ValueError(
                f"slo {name!r}: route {route!r} is never observed on "
                f"this surface (observable: "
                f"{', '.join(sorted(observable_routes))})"
            )
        trackers.append(
            SloTracker(name, threshold_ms, objective_pct, route, clock=clock)
        )
    return trackers


def slo_prometheus(trackers: list[SloTracker], prefix: str) -> str:
    """Exposition block for a set of SLO trackers: monotone
    good/breach totals plus the multi-window burn-rate gauges — lints
    clean next to any registry's output.  Empty list renders nothing."""
    if not trackers:
        return ""
    p = prefix
    lines = [
        f"# HELP {p}_slo_requests_total requests observed per SLO",
        f"# TYPE {p}_slo_requests_total counter",
    ]
    for t in trackers:
        lines.append(
            f'{p}_slo_requests_total{{slo="{escape_label(t.name)}"}} '
            f"{t.requests_total}"
        )
    lines.append(
        f"# HELP {p}_slo_breaches_total requests over threshold or 5xx"
    )
    lines.append(f"# TYPE {p}_slo_breaches_total counter")
    for t in trackers:
        lines.append(
            f'{p}_slo_breaches_total{{slo="{escape_label(t.name)}"}} '
            f"{t.breaches_total}"
        )
    lines.append(
        f"# HELP {p}_slo_burn_rate error-budget spend rate per window "
        "(1.0 = spending exactly the budget)"
    )
    lines.append(f"# TYPE {p}_slo_burn_rate gauge")
    for t in trackers:
        for window, rate in sorted(t.burn_rates().items()):
            lines.append(
                f'{p}_slo_burn_rate{{slo="{escape_label(t.name)}",'
                f'window="{window}"}} {rate:g}'
            )
    return "\n".join(lines) + "\n"
