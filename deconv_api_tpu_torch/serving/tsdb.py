"""Embedded metric history: fixed-interval ring-buffer TSDB (a copy of
``deconv_api_tpu/serving/tsdb.py``).

A scrape sees only now.  This module gives each process its own memory: a periodic self-scrape
task flattens the existing ``Metrics.snapshot()`` into per-series ring
buffers with two downsampling tiers,

- **raw**: one sample per scrape tick (default 1 s × 600 slots), and
- **rollup**: min/mean/max over ``ROLLUP_MULT`` raw ticks (default
  15 s × 960 slots — four hours of history),

so memory is bounded BY CONSTRUCTION: ``max_series`` series × two
fixed-length rings, no allocation growth under sustained load, no
timestamps stored per point (slot position IS the timestamp).  The
clock is injectable — every lifecycle test runs on a hand-cranked
clock, never wall sleeps (the SloTracker discipline).

Series taxonomy follows the exposition:

- counters (``requests_total``, ``errors_total{code=}``, named and
  labeled counter families, histogram ``_bucket``/``_count``/``_sum``
  series) are stored **as rates**: the ingest diffs consecutive
  cumulative values and stores delta/elapsed, so a query reads req/s
  directly and a counter reset (process restart) clamps to the new
  cumulative value rather than producing a negative spike.
- gauges (``gauges.*``, labeled gauges, latency quantile summaries,
  SLO burn rates) are stored as-is.

Queries are served from whichever tier covers the asked range/step
(``GET /v1/metrics/history`` in app.py).  The alert engine (serving/alerts.py) evaluates its rules
over ``window_agg``/``last_age`` on the same scrape tick.

Everything here is plain-Python and lock-protected: the sampler runs on
the event loop, queries arrive from request handlers, and tests drive
both from the main thread.
"""

from __future__ import annotations

import threading
import time

from deconv_api_tpu_torch.serving.metrics import HIST_BUCKETS_S
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.tsdb")

KIND_COUNTER = "counter"
KIND_GAUGE = "gauge"

# Tier geometry: 1s×600 raw, 15s×960 rolled at the default
# 1 s scrape interval.  The rollup interval is a MULTIPLE of the raw
# interval (not an independent knob) so every raw sample folds into
# exactly one rollup window and a test can shrink both tiers
# together by shrinking one interval.
RAW_SLOTS = 600
ROLLUP_SLOTS = 960
ROLLUP_MULT = 15

# Series-universe cap: beyond this the ingest drops NEW series (and
# counts the drops) rather than growing without bound.
MAX_SERIES = 2048


class _Series:
    """One (family, label) series: raw ring + rollup ring + the
    counter-diff and rollup-fold accumulators.  Rings are parallel
    ordinal/value lists; a slot is valid for a read at ordinal ``o``
    only when its stored ordinal matches the expected one (stale
    entries from a previous wrap are self-invalidating — no sweeps)."""

    __slots__ = (
        "kind", "last_cum", "last_ord",
        "raw_ord", "raw_val",
        "roll_ord", "roll_min", "roll_mean", "roll_max",
        "acc",
    )

    def __init__(self, kind: str, raw_slots: int, roll_slots: int):
        self.kind = kind
        self.last_cum: float | None = None   # counters: last cumulative
        self.last_ord: int | None = None
        self.raw_ord = [-1] * raw_slots
        self.raw_val = [0.0] * raw_slots
        self.roll_ord = [-1] * roll_slots
        self.roll_min = [0.0] * roll_slots
        self.roll_mean = [0.0] * roll_slots
        self.roll_max = [0.0] * roll_slots
        # current rollup window accumulator: [roll_ordinal, min, sum, n, max]
        self.acc: list | None = None


class Tsdb:
    """Two-tier ring-buffer store over flattened metric samples.

    ``interval_s`` is the scrape cadence the ingest assumes; the
    sampler task ticks at this period and calls ``ingest`` with the
    flattened snapshot.  ``clock`` is monotonic-seconds-like and
    injectable."""

    def __init__(
        self,
        interval_s: float = 1.0,
        *,
        raw_slots: int = RAW_SLOTS,
        rollup_slots: int = ROLLUP_SLOTS,
        rollup_mult: int = ROLLUP_MULT,
        max_series: int = MAX_SERIES,
        clock=time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError(f"tsdb interval_s must be > 0, got {interval_s}")
        if rollup_mult < 2:
            raise ValueError(f"tsdb rollup_mult must be >= 2, got {rollup_mult}")
        self.interval_s = float(interval_s)
        self.rollup_s = self.interval_s * rollup_mult
        self._raw_slots = int(raw_slots)
        self._roll_slots = int(rollup_slots)
        self._mult = int(rollup_mult)
        self._max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str], _Series] = {}
        self.samples_total = 0
        self.series_clipped_total = 0
        self.scrapes_total = 0
        self.scrape_seconds_total = 0.0

    # ------------------------------------------------------------ ingest

    def ingest(
        self,
        samples: dict[tuple[str, str], tuple[str, float]],
        now: float | None = None,
    ) -> None:
        """One scrape tick: ``{(family, label): (kind, value)}`` where
        counter values are CUMULATIVE (the ingest does the rate diff).

        Idempotent per ordinal: a second ingest landing in the same
        interval slot overwrites it (last-writer-wins) rather than
        double-counting."""
        if now is None:
            now = self._clock()
        ordinal = int(now / self.interval_s)
        with self._lock:
            for key, (kind, value) in samples.items():
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self._max_series:
                        self.series_clipped_total += 1
                        continue
                    s = self._series[key] = _Series(
                        kind, self._raw_slots, self._roll_slots
                    )
                v = float(value)
                if s.kind == KIND_COUNTER:
                    cum = v
                    if s.last_cum is None or s.last_ord is None:
                        # first sight: no rate yet, just anchor the diff
                        s.last_cum, s.last_ord = cum, ordinal
                        continue
                    if ordinal <= s.last_ord:
                        continue
                    delta = cum - s.last_cum
                    if delta < 0:
                        # counter reset (restart): the new cumulative IS
                        # the activity since the reset
                        delta = cum
                    v = delta / ((ordinal - s.last_ord) * self.interval_s)
                    s.last_cum, s.last_ord = cum, ordinal
                self._store(s, ordinal, v)
                self.samples_total += 1

    def _store(self, s: _Series, ordinal: int, v: float) -> None:
        idx = ordinal % self._raw_slots
        s.raw_ord[idx] = ordinal
        s.raw_val[idx] = v
        r_ord = ordinal // self._mult
        if s.acc is None:
            s.acc = [r_ord, v, v, 1, v]
        elif s.acc[0] == r_ord:
            acc = s.acc
            if v < acc[1]:
                acc[1] = v
            acc[2] += v
            acc[3] += 1
            if v > acc[4]:
                acc[4] = v
        else:
            self._flush_acc(s)
            s.acc = [r_ord, v, v, 1, v]

    def _flush_acc(self, s: _Series) -> None:
        if s.acc is None:
            return
        r_ord, mn, total, n, mx = s.acc
        idx = r_ord % self._roll_slots
        s.roll_ord[idx] = r_ord
        s.roll_min[idx] = mn
        s.roll_mean[idx] = total / n
        s.roll_max[idx] = mx
        s.acc = None

    # ------------------------------------------------------------- query

    def families(self) -> dict:
        """Catalog: {family: {"kind": ..., "labels": [...]}} — the
        no-param answer of /v1/metrics/history."""
        out: dict[str, dict] = {}
        with self._lock:
            for (fam, label), s in self._series.items():
                ent = out.setdefault(fam, {"kind": s.kind, "labels": []})
                if label not in ent["labels"]:
                    ent["labels"].append(label)
        for ent in out.values():
            ent["labels"].sort()
        return out

    def query(
        self,
        family: str,
        label: str | None = None,
        range_s: float = 60.0,
        step_s: float | None = None,
        now: float | None = None,
    ) -> list[dict]:
        """Series points over the trailing ``range_s`` window.

        Tier selection: the raw ring serves ranges it still covers
        unless the caller asks for a step at or beyond the rollup
        interval; everything else comes from the rollup ring.  Points
        are ``[age_s, value]`` (raw) or ``[age_s, min, mean, max]``
        (rollup), newest first, ``age_s`` relative to ``now`` — age
        addressing keeps federated per-backend histories comparable
        without trusting anyone's wall clock."""
        if now is None:
            now = self._clock()
        range_s = float(range_s)
        raw_window = self._raw_slots * self.interval_s
        use_rollup = range_s > raw_window or (
            step_s is not None and float(step_s) >= self.rollup_s
        )
        out = []
        with self._lock:
            for (fam, lab), s in self._series.items():
                if fam != family:
                    continue
                if label is not None and lab != label:
                    continue
                ent = {
                    "family": fam,
                    "label": lab,
                    "kind": s.kind,
                    "tier": "rollup" if use_rollup else "raw",
                    "interval_s": self.rollup_s if use_rollup else self.interval_s,
                    "points": [],
                }
                if use_rollup:
                    # the open accumulator window is readable too — an
                    # alert should not wait a full rollup interval to
                    # see the sample that just landed
                    newest = int(now / self.interval_s) // self._mult
                    span = max(1, int(range_s / self.rollup_s))
                    pts = ent["points"]
                    for r_ord in range(newest, newest - span - 1, -1):
                        if r_ord < 0:
                            break
                        if s.acc is not None and s.acc[0] == r_ord:
                            _, mn, total, n, mx = s.acc
                            pts.append([
                                round(now - (r_ord + 1) * self.rollup_s, 6),
                                mn, total / n, mx,
                            ])
                            continue
                        idx = r_ord % self._roll_slots
                        if s.roll_ord[idx] != r_ord:
                            continue
                        age = now - (r_ord + 1) * self.rollup_s
                        pts.append([
                            round(age, 6),
                            s.roll_min[idx], s.roll_mean[idx],
                            s.roll_max[idx],
                        ])
                else:
                    newest = int(now / self.interval_s)
                    span = max(1, int(range_s / self.interval_s))
                    pts = ent["points"]
                    for o in range(newest, newest - span - 1, -1):
                        if o < 0:
                            break
                        idx = o % self._raw_slots
                        if s.raw_ord[idx] != o:
                            continue
                        pts.append([
                            round(now - o * self.interval_s, 6),
                            s.raw_val[idx],
                        ])
                out.append(ent)
        out.sort(key=lambda e: e["label"])
        return out

    def window_agg(
        self,
        family: str,
        label: str,
        range_s: float,
        agg: str = "mean",
        now: float | None = None,
    ) -> float | None:
        """One number over the trailing window — the alert engine's
        read.  ``None`` when the window holds no samples (which is what
        the absence rule kind keys on)."""
        series = self.query(family, label, range_s=range_s, now=now)
        vals: list[float] = []
        for ent in series:
            if ent["tier"] == "raw":
                vals.extend(p[1] for p in ent["points"])
            else:
                # rollup points carry min/mean/max; pick the component
                # that keeps the aggregate conservative for its verb
                for p in ent["points"]:
                    if agg == "min":
                        vals.append(p[1])
                    elif agg == "max":
                        vals.append(p[3])
                    else:
                        vals.append(p[2])
        if not vals:
            return None
        if agg == "min":
            return min(vals)
        if agg == "max":
            return max(vals)
        if agg == "sum":
            return sum(vals)
        if agg == "last":
            return vals[0]
        return sum(vals) / len(vals)

    def last_age(
        self, family: str, label: str, now: float | None = None
    ) -> float | None:
        """Age in seconds of the newest stored sample for one series,
        ``None`` if the series has never been seen — the staleness
        primitive the absence rule kind evaluates."""
        if now is None:
            now = self._clock()
        with self._lock:
            s = self._series.get((family, label))
            if s is None:
                return None
            best: int | None = None
            if s.kind == KIND_COUNTER and s.last_ord is not None:
                best = s.last_ord
            for o in s.raw_ord:
                if o >= 0 and (best is None or o > best):
                    best = o
            if best is None:
                return None
            return max(0.0, now - best * self.interval_s)

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "max_series": self._max_series,
                "samples_total": self.samples_total,
                "series_clipped_total": self.series_clipped_total,
                "scrapes_total": self.scrapes_total,
                "scrape_seconds_total": round(self.scrape_seconds_total, 6),
                "interval_s": self.interval_s,
                "rollup_s": self.rollup_s,
                "raw_slots": self._raw_slots,
                "rollup_slots": self._roll_slots,
            }


# ------------------------------------------------------------- flatten

def flatten_snapshot(snap: dict) -> dict[tuple[str, str], tuple[str, float]]:
    """``Metrics.snapshot()`` -> ``{(family, label): (kind, value)}``.

    The flattening mirrors the text exposition's series universe so an
    operator can move between ``/v1/metrics`` and
    ``/v1/metrics/history`` without a mental renaming table: histogram
    labelsets get ``_bucket``/``_sum``/``_count`` derived families with
    an ``le=`` label component, labeled families join their tuples into
    the same ``k=v,k2=v2`` label string the federation splice uses."""
    out: dict[tuple[str, str], tuple[str, float]] = {}

    def put(fam: str, label: str, kind: str, value) -> None:
        out[(fam, label)] = (kind, float(value))

    if "requests_total" in snap:
        put("requests_total", "", KIND_COUNTER, snap["requests_total"])
        put("images_total", "", KIND_COUNTER, snap.get("images_total", 0))
        put("batches_total", "", KIND_COUNTER, snap.get("batches_total", 0))
        put("latency_p50_s", "", KIND_GAUGE, snap.get("latency_p50_s", 0.0))
        put("latency_p99_s", "", KIND_GAUGE, snap.get("latency_p99_s", 0.0))
        put(
            "queue_wait_p50_s", "", KIND_GAUGE,
            snap.get("queue_wait_p50_s", 0.0),
        )
    for code, n in (snap.get("errors_total") or {}).items():
        put("errors_total", f"code={code}", KIND_COUNTER, n)
    for name, n in (snap.get("counters") or {}).items():
        put(name, "", KIND_COUNTER, n)
    for name, v in (snap.get("gauges") or {}).items():
        put(name, "", KIND_GAUGE, v)

    def label_block(names, joined_key: str) -> str:
        ns = names if isinstance(names, (list, tuple)) else (names,)
        vs = joined_key.split(",") if len(ns) > 1 else [joined_key]
        if len(vs) != len(ns):
            # a label VALUE containing ',' would mis-split; keep the
            # raw joined form rather than guessing
            return f"{ns[0]}={joined_key}"
        return ",".join(f"{n}={v}" for n, v in zip(ns, vs))

    for fam, (names, series) in (snap.get("labeled") or {}).items():
        for key, n in series.items():
            put(fam, label_block(names, key), KIND_COUNTER, n)
    for fam, (name, series) in (snap.get("labeled_gauges") or {}).items():
        for key, v in series.items():
            put(fam, f"{name}={key}", KIND_GAUGE, v)
    for fam, (names, series) in (snap.get("histograms") or {}).items():
        for key, h in series.items():
            block = label_block(names, key)
            sep = "," if block else ""
            put(f"{fam}_count", block, KIND_COUNTER, h["count"])
            put(f"{fam}_sum", block, KIND_COUNTER, h["sum"])
            cum = 0
            for bound, n in zip(HIST_BUCKETS_S, h["buckets"]):
                cum += n
                put(
                    f"{fam}_bucket", f"{block}{sep}le={bound:g}",
                    KIND_COUNTER, cum,
                )
            put(
                f"{fam}_bucket", f"{block}{sep}le=+Inf",
                KIND_COUNTER, h["count"],
            )
    return out
