"""Declarative alert engine + incident black-box recorder (a copy of
``deconv_api_tpu/serving/alerts.py``).

The TSDB (serving/tsdb.py) gives the process a memory; this module
gives it an alarm and a flight-data recorder.  Three pieces:

- **Rule grammar** (``parse_alert_rules``): inline JSON or a file path,
  validated at boot exactly like ``slos`` — an unknown
  key, a typo'd kind, or a burn rule naming an SLO the server does not
  track fails the process at startup instead of arming a dead alarm.
  Three rule kinds:

  * ``threshold`` — aggregate one TSDB series over a trailing window
    and compare: ``{"name": "...", "kind": "threshold", "family":
    "errors_total", "label": "code=INTERNAL", "agg": "mean", "op":
    ">", "value": 0.5, "range_s": 60, "for_s": 30}``.
  * ``burn`` — the classic multi-window error-budget pair over the
    SLO trackers (serving/metrics.py): fires only when EVERY listed window overspends
    (``{"kind": "burn", "slo": "api", "windows": {"5m": 14.0}}``) —
    the fast window catches the spike, the slow window (when listed)
    keeps a brief blip from paging.
  * ``absence`` — staleness: fires when a series has not been sampled
    for ``stale_s`` seconds (or has never been seen).

- **AlertEngine**: evaluated on the scrape tick with ``for_s``
  hold-downs and a pending→firing→resolved lifecycle under an
  injectable clock.  Evaluation is **fail-static**: a crashing rule
  evaluation (or the armed ``alerts.eval_error`` fault site)
  increments ``alerts_eval_errors_total`` and leaves every rule's
  state EXACTLY where it was — a firing alert never flaps to resolved
  because the evaluator died.

- **IncidentStore**: a rule transitioning to firing snapshots a
  digest-verified incident bundle (``durable.frame``, tmp-then-rename):
  triggering rule + its query window, the flight recorder's slow/error
  rings and the config view.  Bundles are listable at
  ``/v1/debug/incidents``, retention-swept, and replayable after a
  restart — a torn write fails its digest and reads as absent, never
  as an error.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from deconv_api_tpu_torch.serving import durable, faults
from deconv_api_tpu_torch.serving.metrics import SLO_WINDOWS, escape_label
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.alerts")

RULE_KINDS = ("threshold", "burn", "absence")
OPS = (">", ">=", "<", "<=")
AGGS = ("mean", "min", "max", "sum", "last")
SEVERITIES = ("info", "warn", "page")

_NAME_RE = re.compile(r"[A-Za-z0-9_\-]{1,64}\Z")

# Lifecycle states, exported as the alert_state{rule=} gauge values.
STATE_OK = 0
STATE_PENDING = 1
STATE_FIRING = 2
_STATE_NAMES = {STATE_OK: "ok", STATE_PENDING: "pending", STATE_FIRING: "firing"}

_THRESHOLD_KEYS = {
    "name", "kind", "severity", "for_s",
    "family", "label", "agg", "op", "value", "range_s",
}
_BURN_KEYS = {"name", "kind", "severity", "for_s", "slo", "windows"}
_ABSENCE_KEYS = {
    "name", "kind", "severity", "for_s", "family", "label", "stale_s",
}


class AlertRule:
    """One validated rule.  Plain attribute bag — the parse function is
    the only constructor path, so every instance is well-formed."""

    def __init__(self, raw: dict):
        self.name: str = raw["name"]
        self.kind: str = raw["kind"]
        self.severity: str = raw.get("severity", "warn")
        self.for_s: float = float(raw.get("for_s", 0.0))
        self.family: str = raw.get("family", "")
        self.label: str = raw.get("label", "")
        self.agg: str = raw.get("agg", "mean")
        self.op: str = raw.get("op", ">")
        self.value: float = float(raw.get("value", 0.0))
        self.range_s: float = float(raw.get("range_s", 60.0))
        self.slo: str = raw.get("slo", "")
        self.windows: dict[str, float] = {
            k: float(v) for k, v in (raw.get("windows") or {}).items()
        }
        self.stale_s: float = float(raw.get("stale_s", 30.0))

    def spec(self) -> dict:
        """The rule as it would appear in the config file — the
        /v1/alerts and incident-bundle echo."""
        out = {
            "name": self.name, "kind": self.kind,
            "severity": self.severity, "for_s": self.for_s,
        }
        if self.kind == "threshold":
            out.update(
                family=self.family, label=self.label, agg=self.agg,
                op=self.op, value=self.value, range_s=self.range_s,
            )
        elif self.kind == "burn":
            out.update(slo=self.slo, windows=dict(self.windows))
        else:
            out.update(
                family=self.family, label=self.label, stale_s=self.stale_s,
            )
        return out


def parse_alert_rules(
    spec: str, *, known_slos: "frozenset[str] | None" = None
) -> list[AlertRule]:
    """Parse the ``alerts`` config knob: inline JSON (starts with ``{``
    or ``[``) or a path to a JSON file.  Top level is ``{"rules": [...]}`` or a bare list.
    Raises ValueError on anything malformed; boot-validated, never
    silently dropped."""
    raw = spec.strip()
    if not raw:
        return []
    if not raw.startswith(("{", "[")):
        try:
            with open(raw, encoding="utf-8") as f:
                raw = f.read()
        except OSError as e:
            raise ValueError(f"alerts file {spec!r}: {e}") from None
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError(f"alerts spec: invalid JSON ({e})") from None
    if isinstance(doc, dict):
        extra = set(doc) - {"rules"}
        if extra:
            raise ValueError(
                f"alerts spec: unknown top-level keys {sorted(extra)}"
            )
        doc = doc.get("rules", [])
    if not isinstance(doc, list):
        raise ValueError("alerts spec: want a list of rules")
    rules: list[AlertRule] = []
    seen: set[str] = set()
    for i, ent in enumerate(doc):
        if not isinstance(ent, dict):
            raise ValueError(f"alerts rule #{i}: want an object")
        name = ent.get("name")
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(
                f"alerts rule #{i}: name must match [A-Za-z0-9_-]{{1,64}}"
            )
        if name in seen:
            raise ValueError(f"alerts rule {name!r}: duplicate name")
        seen.add(name)
        kind = ent.get("kind")
        if kind not in RULE_KINDS:
            raise ValueError(
                f"alerts rule {name!r}: kind must be one of "
                f"{', '.join(RULE_KINDS)}, got {kind!r}"
            )
        allowed = {
            "threshold": _THRESHOLD_KEYS,
            "burn": _BURN_KEYS,
            "absence": _ABSENCE_KEYS,
        }[kind]
        extra = set(ent) - allowed
        if extra:
            raise ValueError(
                f"alerts rule {name!r}: unknown keys {sorted(extra)} "
                f"for kind {kind!r}"
            )
        sev = ent.get("severity", "warn")
        if sev not in SEVERITIES:
            raise ValueError(
                f"alerts rule {name!r}: severity must be one of "
                f"{', '.join(SEVERITIES)}, got {sev!r}"
            )
        for num_key in ("for_s", "value", "range_s", "stale_s"):
            if num_key in ent and not isinstance(ent[num_key], (int, float)):
                raise ValueError(
                    f"alerts rule {name!r}: {num_key} must be numeric"
                )
        if float(ent.get("for_s", 0)) < 0:
            raise ValueError(f"alerts rule {name!r}: for_s must be >= 0")
        if kind == "threshold":
            if not ent.get("family"):
                raise ValueError(
                    f"alerts rule {name!r}: threshold needs a family"
                )
            if ent.get("op", ">") not in OPS:
                raise ValueError(
                    f"alerts rule {name!r}: op must be one of "
                    f"{', '.join(OPS)}"
                )
            if ent.get("agg", "mean") not in AGGS:
                raise ValueError(
                    f"alerts rule {name!r}: agg must be one of "
                    f"{', '.join(AGGS)}"
                )
            if "value" not in ent:
                raise ValueError(
                    f"alerts rule {name!r}: threshold needs a value"
                )
            if float(ent.get("range_s", 60.0)) <= 0:
                raise ValueError(
                    f"alerts rule {name!r}: range_s must be > 0"
                )
        elif kind == "burn":
            if not ent.get("slo"):
                raise ValueError(f"alerts rule {name!r}: burn needs an slo")
            if known_slos is not None and ent["slo"] not in known_slos:
                raise ValueError(
                    f"alerts rule {name!r}: slo {ent['slo']!r} is not "
                    f"tracked here (known: "
                    f"{', '.join(sorted(known_slos)) or 'none'})"
                )
            windows = ent.get("windows")
            if not isinstance(windows, dict) or not windows:
                raise ValueError(
                    f"alerts rule {name!r}: burn needs windows "
                    '{"5m": <burn>, ...}'
                )
            for w, thr in windows.items():
                if w not in SLO_WINDOWS:
                    raise ValueError(
                        f"alerts rule {name!r}: unknown burn window {w!r} "
                        f"(known: {', '.join(SLO_WINDOWS)})"
                    )
                if not isinstance(thr, (int, float)) or float(thr) <= 0:
                    raise ValueError(
                        f"alerts rule {name!r}: burn threshold for {w!r} "
                        "must be a positive number"
                    )
        else:  # absence
            if not ent.get("family"):
                raise ValueError(
                    f"alerts rule {name!r}: absence needs a family"
                )
            if float(ent.get("stale_s", 30.0)) <= 0:
                raise ValueError(
                    f"alerts rule {name!r}: stale_s must be > 0"
                )
        rules.append(AlertRule(ent))
    return rules


class AlertEngine:
    """Rule evaluation + lifecycle over one Tsdb.

    ``evaluate()`` runs on the scrape tick (after the ingest, same
    task) and returns the NEWLY-FIRING rules' contexts so the caller
    can write incident bundles without the engine knowing what a
    bundle holds.  All state transitions happen under the injectable
    clock; nothing here sleeps or does I/O."""

    def __init__(
        self,
        rules: list[AlertRule],
        tsdb,
        *,
        slos=(),
        clock=time.monotonic,
    ):
        self.rules = list(rules)
        self.tsdb = tsdb
        self._slos = {t.name: t for t in (slos or ())}
        self._clock = clock
        self._lock = threading.Lock()
        self.eval_errors_total = 0
        self.evals_total = 0
        self._st: dict[str, dict] = {
            r.name: {
                "state": STATE_OK,
                "since": None,          # entered current state at (clock)
                "pending_since": None,
                "value": None,
                "fires_total": 0,
                "resolved_total": 0,
                "eval_errors": 0,
                "last_error": None,
            }
            for r in self.rules
        }

    # -------------------------------------------------------- conditions

    def _condition(self, rule: AlertRule, now: float):
        """-> (cond: bool, observed value).  Raises on evaluator faults
        (caught fail-static by evaluate)."""
        faults.raise_if_armed("alerts.eval_error")
        if rule.kind == "threshold":
            v = self.tsdb.window_agg(
                rule.family, rule.label, rule.range_s, rule.agg, now=now
            )
            if v is None:
                return False, None
            ok = {
                ">": v > rule.value,
                ">=": v >= rule.value,
                "<": v < rule.value,
                "<=": v <= rule.value,
            }[rule.op]
            return ok, v
        if rule.kind == "burn":
            tracker = self._slos.get(rule.slo)
            if tracker is None:
                raise LookupError(f"slo {rule.slo!r} not tracked")
            rates = tracker.burn_rates()
            worst = max(
                (rates.get(w, 0.0) for w in rule.windows), default=0.0
            )
            cond = all(
                rates.get(w, 0.0) > thr for w, thr in rule.windows.items()
            )
            return cond, worst
        # absence: never-seen counts as absent — that is the point
        age = self.tsdb.last_age(rule.family, rule.label, now=now)
        return (age is None or age > rule.stale_s), age

    # --------------------------------------------------------- lifecycle

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One tick.  Returns contexts for rules that JUST transitioned
        to firing (the incident-bundle trigger).  Fail-static: a rule
        whose condition evaluation raises keeps its current state."""
        if now is None:
            now = self._clock()
        fired: list[dict] = []
        with self._lock:
            self.evals_total += 1
            for rule in self.rules:
                st = self._st[rule.name]
                try:
                    cond, value = self._condition(rule, now)
                except Exception as e:  # fail-static, by contract
                    self.eval_errors_total += 1
                    st["eval_errors"] += 1
                    st["last_error"] = f"{type(e).__name__}: {e}"
                    slog.event(
                        _log, "alert_eval_error", rule=rule.name,
                        error=st["last_error"],
                    )
                    continue
                st["value"] = value
                if cond:
                    if st["state"] == STATE_OK:
                        st["state"] = STATE_PENDING
                        st["since"] = now
                        st["pending_since"] = now
                    if (
                        st["state"] == STATE_PENDING
                        and now - st["pending_since"] >= rule.for_s
                    ):
                        st["state"] = STATE_FIRING
                        st["since"] = now
                        st["fires_total"] += 1
                        slog.event(
                            _log, "alert_firing", rule=rule.name,
                            severity=rule.severity, value=value,
                        )
                        fired.append({
                            "rule": rule.spec(),
                            "value": value,
                            "fired_at": now,
                        })
                else:
                    if st["state"] == STATE_FIRING:
                        st["resolved_total"] += 1
                        slog.event(
                            _log, "alert_resolved", rule=rule.name,
                            severity=rule.severity,
                        )
                    # a pending rule whose condition clears simply
                    # returns to ok — the hold-down IS the flap filter
                    if st["state"] != STATE_OK:
                        st["state"] = STATE_OK
                        st["since"] = now
                        st["pending_since"] = None
        return fired

    # ---------------------------------------------------------- surfaces

    def snapshot(self, now: float | None = None) -> dict:
        if now is None:
            now = self._clock()
        rules = []
        firing = pending = 0
        with self._lock:
            for rule in self.rules:
                st = self._st[rule.name]
                state = _STATE_NAMES[st["state"]]
                if st["state"] == STATE_FIRING:
                    firing += 1
                elif st["state"] == STATE_PENDING:
                    pending += 1
                rules.append({
                    "name": rule.name,
                    "kind": rule.kind,
                    "severity": rule.severity,
                    "state": state,
                    "since_s": (
                        round(now - st["since"], 3)
                        if st["since"] is not None else None
                    ),
                    "for_s": rule.for_s,
                    "value": st["value"],
                    "fires_total": st["fires_total"],
                    "resolved_total": st["resolved_total"],
                    "eval_errors": st["eval_errors"],
                    "last_error": st["last_error"],
                    "spec": rule.spec(),
                })
            return {
                "rules": rules,
                "firing": firing,
                "pending": pending,
                "evals_total": self.evals_total,
                "eval_errors_total": self.eval_errors_total,
            }

    def firing(self) -> list[str]:
        with self._lock:
            return sorted(
                name for name, st in self._st.items()
                if st["state"] == STATE_FIRING
            )

    def prometheus(self, prefix: str) -> str:
        """``alert_state{rule=}`` (0 ok / 1 pending / 2 firing) plus
        fire/resolve/eval-error totals — every family pre-registered
        per rule so the exposition lint holds from the first scrape."""
        p = prefix
        snap = self.snapshot()
        lines = [
            f"# HELP {p}_alert_state alert lifecycle state "
            "(0=ok 1=pending 2=firing)",
            f"# TYPE {p}_alert_state gauge",
        ]
        state_num = {"ok": STATE_OK, "pending": STATE_PENDING,
                     "firing": STATE_FIRING}
        for r in snap["rules"]:
            lines.append(
                f'{p}_alert_state{{rule="{escape_label(r["name"])}"}} '
                f"{state_num[r['state']]}"
            )
        lines.append(f"# TYPE {p}_alerts_fired_total counter")
        for r in snap["rules"]:
            lines.append(
                f'{p}_alerts_fired_total{{rule="{escape_label(r["name"])}"}} '
                f"{r['fires_total']}"
            )
        lines.append(f"# TYPE {p}_alerts_resolved_total counter")
        for r in snap["rules"]:
            lines.append(
                f'{p}_alerts_resolved_total'
                f'{{rule="{escape_label(r["name"])}"}} '
                f"{r['resolved_total']}"
            )
        lines.append(f"# TYPE {p}_alerts_eval_errors_total counter")
        lines.append(
            f"{p}_alerts_eval_errors_total {snap['eval_errors_total']}"
        )
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------- incidents

_INC_NAME_RE = re.compile(r"inc-\d+-\d+-[A-Za-z0-9_\-]{1,64}\.json\Z")


class IncidentStore:
    """Digest-verified incident bundles on disk — the black box.

    File format: one ``durable.frame`` artifact per bundle —
    a versioned ``{"format": "alerts.incidents", "version", "len",
    "digest"}`` header line followed by the JSON payload.  Writes go
    through ``durable.atomic_write`` (tmp + fsync + rename + dir fsync)
    so a bundle either exists whole or not at all; a torn/corrupted
    file fails its digest on read and is treated as ABSENT (counted,
    logged, never an error) — restart replay tolerates a torn tail by
    construction.  BEST-EFFORT durable surface: a failed write returns
    None instead of raising (the black box must never take down the
    thing it is recording), counted in ``durable_write_errors_total
    {surface="alerts.incidents"}``; a FUTURE-version bundle reads as
    absent without deletion."""

    _FORMAT = "alerts.incidents"
    _VERSION = 1

    def __init__(
        self,
        root: str,
        *,
        retention_s: float = 86400.0,
        max_bundles: int = 64,
        clock=time.time,
        metrics=None,
    ):
        self.root = root
        self.retention_s = float(retention_s)
        self.max_bundles = int(max_bundles)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self.writes_total = 0
        self.corrupt_total = 0
        self.swept_total = 0
        self.surface = durable.Surface("alerts.incidents", metrics=metrics)
        os.makedirs(root, exist_ok=True)
        # stale .tmp from a writer that died mid-bundle: the uniform
        # boot sweep (the periodic sweep() also sheds them)
        durable.sweep_tmp(root)

    def record(self, rule_name: str, bundle: dict) -> str | None:
        """Write one bundle durably; returns its incident id, or None
        when the write could not be made durable (best-effort — the
        caller counts, the request path never sees an exception)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        ts_ms = int(self._clock() * 1000)
        safe = re.sub(r"[^A-Za-z0-9_\-]", "_", rule_name)[:64] or "rule"
        inc_id = f"inc-{ts_ms}-{seq}-{safe}"
        payload = json.dumps(
            {"id": inc_id, "ts_unix": ts_ms / 1000.0, **bundle},
            sort_keys=True,
        ).encode()
        path = os.path.join(self.root, inc_id + ".json")
        data = durable.frame(self._FORMAT, self._VERSION, payload)
        if not durable.atomic_write(path, data, surface=self.surface):
            return None
        self.writes_total += 1
        slog.event(
            _log, "incident_recorded", id=inc_id, bytes=len(payload)
        )
        return inc_id

    def _read(self, path: str) -> dict | None:
        raw = durable.read_bytes(path, "alerts.incidents")
        if raw is None:
            return None
        try:
            framed = durable.unframe(raw, self._FORMAT, self._VERSION)
        except durable.FutureVersionError:
            # fail-static (best-effort): a newer binary's bundle reads
            # as absent — never deleted, never counted corrupt
            return None
        if framed is None:
            self.corrupt_total += 1
            slog.event(
                _log, "incident_digest_mismatch",
                file=os.path.basename(path),
            )
            return None
        try:
            return json.loads(framed[1])
        except json.JSONDecodeError:
            self.corrupt_total += 1
            return None

    def list(self) -> list[dict]:
        """Summaries of every intact bundle, newest first.  Corrupt or
        torn files are skipped (counted in ``corrupt_total``)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if not _INC_NAME_RE.match(name):
                continue
            doc = self._read(os.path.join(self.root, name))
            if doc is None:
                continue
            out.append({
                "id": doc.get("id", name[:-5]),
                "ts_unix": doc.get("ts_unix"),
                "rule": (doc.get("rule") or {}).get("name"),
                "severity": (doc.get("rule") or {}).get("severity"),
                "value": doc.get("value"),
            })
        out.sort(key=lambda d: (d.get("ts_unix") or 0, d["id"]), reverse=True)
        return out

    def load(self, inc_id: str) -> dict | None:
        """Full digest-verified bundle, None when absent/corrupt."""
        name = inc_id + ".json"
        if not _INC_NAME_RE.match(name):
            return None
        return self._read(os.path.join(self.root, name))

    def sweep(self) -> int:
        """Drop bundles past retention (and the oldest beyond
        ``max_bundles``), plus any orphaned ``.tmp`` halves.  Returns
        the number removed."""
        removed = durable.sweep_tmp(self.root)
        now = self._clock()
        entries = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return removed
        for name in names:
            path = os.path.join(self.root, name)
            if not _INC_NAME_RE.match(name):
                continue
            try:
                ts_ms = int(name.split("-")[1])
            except (IndexError, ValueError):
                continue
            entries.append((ts_ms, path))
        entries.sort(reverse=True)
        for i, (ts_ms, path) in enumerate(entries):
            if i >= self.max_bundles or now - ts_ms / 1000.0 > self.retention_s:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        if removed:
            self.swept_total += removed
            slog.event(_log, "incident_sweep", removed=removed)
        return removed
