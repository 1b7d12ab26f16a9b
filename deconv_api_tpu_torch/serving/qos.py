"""Multi-tenant QoS: identity, priority classes, device-time budgets and
deficit-round-robin fair queueing (a copy of
``deconv_api_tpu/serving/qos.py``).

- **Tenant identity**: ``tenant_of(headers)`` reads the ``x-api-key`` or
  ``x-tenant`` header, validated against the request-id grammar
  (``RID_RE``); anonymous or malformed identity maps to the default
  tenant rather than a 400.  An ``x-api-key`` that is not a configured
  tenant name is pseudonymized to ``key-<digest>`` before it can reach a
  metric label or a log line, and past ``MAX_TENANTS`` live tenants
  unconfigured names collapse to the default tenant.
- **Priority classes**: ``interactive`` > ``standard`` > ``bulk``.  A
  class is a DRR weight, a shed rank (overload evicts bulk first) and a
  deadline-jump privilege (a near-deadline interactive item pops ahead of
  the rotation; bulk never jumps).
- **Token-bucket rate limits in device-milliseconds**: each metered
  tenant's bucket refills at ``rate_ms`` device-ms per wall second and
  holds at most ``burst_ms``.  Admission debits the tenant's EWMA-measured
  per-request device cost (1 ms until measured); an empty bucket answers
  429 ``tenant_over_quota`` with a Retry-After from the refill rate.  The
  batcher reports each executed item's share of its batch's wall through
  ``charge()``.  Cache hits refund the provisional debit down to a fixed
  ``hit_cost_ms``.
- **In-flight budgets**: ``max_inflight`` concurrent admitted requests per
  tenant.
- **DRR queues**: ``DrrQueue`` replaces the batcher's FIFO with
  per-(tenant, class) queues served deficit-round-robin, the quantum
  scaled by the class weight.  Single consumer by contract.
- **Fail-open admission**: the ``qos.admission_raise`` fault site (and any
  unexpected admission crash) degrades to the default tenant with no
  metering.

Everything is inert unless ``qos`` is on: the batcher keeps its plain
``asyncio.Queue`` and the routes skip the admission wrap.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import faults
from deconv_api_tpu_torch.serving.trace import RID_RE
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.qos")

# Priority classes, strongest first.  The weight is the DRR quantum
# multiplier: per rotation an interactive queue may serve 8 items for
# every 1 a bulk queue serves (when both are backlogged).
CLASSES = ("interactive", "standard", "bulk")
DEFAULT_WEIGHTS = {"interactive": 8, "standard": 4, "bulk": 1}

# The identity every anonymous (or unparseable) request maps onto.
DEFAULT_TENANT = "default"

# Provisional device-cost debit for a tenant nobody has measured yet
# (the EWMA replaces it after the first executed batch).
SEED_COST_MS = 1.0

# Cardinality guard: tenant names arrive in attacker-chosen headers, and
# every distinct name would otherwise pin a _Tenant, a DRR queue slot,
# and a label series in three metric families FOREVER.  Past this many
# live tenants, unconfigured identities collapse to the default tenant —
# configured tenants and anyone already metered keep their own state.
MAX_TENANTS = 1024

# EWMA smoothing for a tenant's per-request device cost — same constant
# family as the lane cost signal (serving/batcher.py _EWMA_ALPHA).
_EWMA_ALPHA = 0.2


def parse_weights(raw: str) -> dict[str, int]:
    """``interactive=8,standard=4,bulk=1`` -> validated weights dict.
    Unnamed classes keep their defaults; unknown class names or weights
    < 1 are config errors (a zero weight would starve that class's DRR
    rotation forever — that is what shed order is for)."""
    weights = dict(DEFAULT_WEIGHTS)
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, val = part.partition("=")
        name = name.strip()
        if not eq or name not in CLASSES:
            raise ValueError(
                f"bad qos weight {part!r}: want <class>=<int> with class in "
                f"{', '.join(CLASSES)}"
            )
        try:
            w = int(val)
        except ValueError:
            raise ValueError(f"qos weight for {name!r} must be an int") from None
        if w < 1:
            raise ValueError(f"qos weight for {name!r} must be >= 1")
        weights[name] = w
    return weights


@dataclass
class TenantSpec:
    """One tenant's policy.  0 disables the respective limit — the
    default tenant ships unmetered so turning qos on without a tenant
    file changes scheduling (fair queues) but rejects nobody."""

    tclass: str = "standard"
    rate_ms: float = 0.0      # bucket refill, device-ms per wall second
    burst_ms: float = 0.0     # bucket capacity (0 with rate>0 = rate*1s)
    max_inflight: int = 0     # concurrent admitted requests
    max_jobs: int = 0         # queued+running async jobs (the jobs tier)


def parse_tenant_specs(raw: str) -> dict[str, TenantSpec]:
    """The ``tenants`` knob: inline JSON (starts with ``{``) or a path
    to a JSON file.  Shape: ``{"name": {"class": "bulk", "rate_ms": 50,
    "burst_ms": 200, "max_inflight": 32, "max_jobs": 4}, ...}``.  A
    ``"*"`` entry is the template for tenants not named explicitly
    (anonymous traffic still maps to ``default``).  Unknown keys,
    unknown classes, and negative budgets are boot-time config errors —
    a typo'd quota must not silently admit everything."""
    if not raw:
        return {}
    text = raw
    if not raw.lstrip().startswith("{"):
        if not os.path.exists(raw):
            raise ValueError(f"tenants spec file {raw!r} does not exist")
        with open(raw) as f:
            text = f.read()
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise ValueError(f"unparseable tenants spec: {e}") from None
    if not isinstance(doc, dict):
        raise ValueError("tenants spec must be a JSON object")
    out: dict[str, TenantSpec] = {}
    for name, entry in doc.items():
        if name != "*" and not RID_RE.match(name):
            raise ValueError(
                f"tenant name {name!r} must match [A-Za-z0-9._-]{{1,64}}"
            )
        if not isinstance(entry, dict):
            raise ValueError(f"tenant {name!r} spec must be an object")
        spec = TenantSpec()
        for key, value in entry.items():
            if key == "class":
                if value not in CLASSES:
                    raise ValueError(
                        f"tenant {name!r}: class must be one of "
                        f"{', '.join(CLASSES)}, got {value!r}"
                    )
                spec.tclass = value
            elif key in ("rate_ms", "burst_ms"):
                if isinstance(value, bool) or not isinstance(
                    value, (int, float)
                ):
                    raise ValueError(
                        f"tenant {name!r}: {key} must be a number, "
                        f"got {value!r}"
                    )
                if value < 0:
                    raise ValueError(f"tenant {name!r}: {key} must be >= 0")
                setattr(spec, key, float(value))
            elif key in ("max_inflight", "max_jobs"):
                # int(value) would silently truncate a fractional quota
                # (3.9 jobs -> 3) — the docstring promises a boot-time
                # error instead
                if isinstance(value, bool) or not isinstance(value, int):
                    raise ValueError(
                        f"tenant {name!r}: {key} must be an integer, "
                        f"got {value!r}"
                    )
                if value < 0:
                    raise ValueError(f"tenant {name!r}: {key} must be >= 0")
                setattr(spec, key, value)
            else:
                raise ValueError(f"tenant {name!r}: unknown key {key!r}")
        if spec.rate_ms > 0 and spec.burst_ms <= 0:
            spec.burst_ms = spec.rate_ms  # one second of burst by default
        out[name] = spec
    return out


class TokenBucket:
    """Device-time token bucket (injectable clock, so refill tests never
    sleep).  Tokens are device-milliseconds; refill is continuous."""

    def __init__(
        self,
        rate_ms: float,
        burst_ms: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate_ms = float(rate_ms)
        self.burst_ms = float(burst_ms)
        self._clock = clock
        self.tokens = self.burst_ms
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        if now > self._t:
            self.tokens = min(
                self.burst_ms, self.tokens + (now - self._t) * self.rate_ms
            )
        self._t = now

    def take(self, ms: float) -> tuple[bool, float]:
        """(admitted?, seconds until the deficit refills when not)."""
        self._refill()
        if self.tokens >= ms:
            self.tokens -= ms
            return True, 0.0
        deficit = ms - self.tokens
        return False, deficit / self.rate_ms if self.rate_ms > 0 else 60.0

    def credit(self, ms: float) -> None:
        """Refund (cache hit: the provisional device debit never ran)."""
        self._refill()
        self.tokens = min(self.burst_ms, self.tokens + ms)


class _Tenant:
    """One tenant's live state: policy, bucket, in-flight count, and the
    EWMA-measured per-request device cost the admission debit uses."""

    __slots__ = ("name", "spec", "bucket", "inflight", "ewma_ms", "device_ms")

    def __init__(self, name: str, spec: TenantSpec, clock):
        self.name = name
        self.spec = spec
        self.bucket = (
            TokenBucket(spec.rate_ms, spec.burst_ms, clock)
            if spec.rate_ms > 0
            else None
        )
        self.inflight = 0
        self.ewma_ms = 0.0
        self.device_ms = 0.0

    def est_cost_ms(self) -> float:
        return self.ewma_ms if self.ewma_ms > 0 else SEED_COST_MS


@dataclass
class Grant:
    """One admitted request's accounting handle: who it is, what was
    provisionally debited, and whether admission actually metered it
    (fail-open grants release as no-ops)."""

    tenant: str
    tclass: str
    charged_ms: float = 0.0
    metered: bool = False
    failed_open: bool = False
    _released: bool = field(default=False, repr=False)


class QosPolicy:
    """The tenant registry + admission/accounting surface the service
    owns (one per process, shared by every dispatcher and route).

    Thread-safe: admission and release run on the event loop, but
    ``charge`` is called from the batcher's resolve path which can run
    inside fetch tasks racing on the loop, and tests drive it from
    worker threads."""

    def __init__(
        self,
        tenants: str = "",
        *,
        default_class: str = "standard",
        weights: str = "",
        hit_cost_ms: float = 0.05,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if default_class not in CLASSES:
            raise ValueError(
                f"qos_default_class must be one of {', '.join(CLASSES)}, "
                f"got {default_class!r}"
            )
        self.default_class = default_class
        self.weights = parse_weights(weights)
        self.hit_cost_ms = float(hit_cost_ms)
        self._specs = parse_tenant_specs(tenants)
        self._wildcard = self._specs.pop("*", None)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        # fairness-gauge accumulators: device_ms only grows and tenants
        # are never evicted, so max/count/sum maintained per charge()
        # equal the full scan exactly without an O(tenants) walk on the
        # batcher's per-item resolve path
        self._dev_sum = 0.0
        self._dev_max = 0.0
        self._dev_n = 0

    # ------------------------------------------------------- identity

    def tenant_of(self, headers: dict[str, str]) -> str:
        """``x-api-key`` wins over ``x-tenant``; anything failing the
        request-id grammar maps to the default tenant (metering
        metadata, not an auth surface — see module docstring).

        An ``x-api-key`` value that is NOT a configured tenant name is a
        credential by convention — it must never appear verbatim in
        metric labels, log lines, or /v1/config, all of which are
        operator surfaces wider than the key's audience.  Unconfigured
        keys are pseudonymized to a stable ``key-<10 hex>`` digest
        (still one tenant per key, so metering works; the operator can
        recompute the digest from a suspect key when chasing a noisy
        neighbor).  Configured names and ``x-tenant`` values are
        operator-/client-chosen LABELS and pass through verbatim."""
        raw = headers.get("x-api-key") or ""
        from_key = bool(raw)
        if not raw:
            raw = headers.get("x-tenant") or ""
        if not raw or not RID_RE.match(raw):
            return DEFAULT_TENANT
        if from_key and raw not in self._specs:
            digest = hashlib.blake2b(raw.encode(), digest_size=5).hexdigest()
            return f"key-{digest}"
        return raw

    def _state(self, name: str) -> _Tenant:
        if not name:
            # jobs journaled before qos was enabled carry tenant="" —
            # that is default-tenant work, not a tenant named ""
            name = DEFAULT_TENANT
        state = self._tenants.get(name)
        if state is None:
            spec = self._specs.get(name)
            if (
                spec is None
                and name != DEFAULT_TENANT
                and len(self._tenants) >= MAX_TENANTS
            ):
                # MAX_TENANTS cardinality guard: an unconfigured name
                # past the cap is metered as default-tenant traffic
                # rather than pinning new state/label series
                return self._state(DEFAULT_TENANT)
            if spec is None:
                if name != DEFAULT_TENANT and self._wildcard is not None:
                    spec = self._wildcard
                else:
                    spec = TenantSpec(tclass=self.default_class)
            state = self._tenants[name] = _Tenant(name, spec, self._clock)
        return state

    def class_of(self, tenant: str) -> str:
        with self._lock:
            return self._state(tenant).spec.tclass

    # ------------------------------------------------------ admission

    def admit(self, headers: dict[str, str]) -> Grant:
        """Identity + in-flight budget + token-bucket debit, in that
        order.  Raises ``TenantOverQuota`` (429 + Retry-After from the
        bucket's refill) when a budget is exhausted.  An admission-layer
        CRASH — the ``qos.admission_raise`` fault site, or any
        unexpected exception — fails OPEN to an unmetered default-tenant
        grant: a broken accounting layer must degrade to the
        unmetered path, not take the service down (availability over
        accounting)."""
        try:
            faults.raise_if_armed("qos.admission_raise")
            return self._admit_inner(headers)
        except errors.TenantOverQuota:
            raise
        except Exception as e:  # noqa: BLE001 — fail open by design
            slog.event(
                _log, "qos_admission_failed_open", level=logging.ERROR,
                error=f"{type(e).__name__}: {e}",
            )
            if self._metrics is not None:
                self._metrics.inc_counter("qos_admission_errors_total")
            return Grant(
                DEFAULT_TENANT, self.default_class,
                metered=False, failed_open=True,
            )

    def _admit_inner(self, headers: dict[str, str]) -> Grant:
        name = self.tenant_of(headers)
        with self._lock:
            state = self._state(name)
            name = state.name  # may have collapsed (MAX_TENANTS guard)
            spec = state.spec
            if spec.max_inflight > 0 and state.inflight >= spec.max_inflight:
                self._shed_locked(name)
                raise errors.TenantOverQuota(
                    f"tenant {name!r} at its in-flight budget "
                    f"({state.inflight}/{spec.max_inflight})",
                    retry_after_s=state.est_cost_ms() / 1e3,
                    tenant=name,
                )
            est = state.est_cost_ms()
            charged = 0.0
            if state.bucket is not None:
                # a single debit can never exceed the bucket's capacity:
                # a tenant whose measured cost outgrows its burst (one
                # contended batch can inflate the EWMA past a small
                # burst_ms) must degrade to ~rate/burst admissions per
                # second, not starve FOREVER because take(est) can no
                # longer succeed at any token level (standard
                # token-bucket practice)
                est = min(est, state.bucket.burst_ms)
                ok, wait_s = state.bucket.take(est)
                if not ok:
                    self._shed_locked(name)
                    raise errors.TenantOverQuota(
                        f"tenant {name!r} over its device-time budget "
                        f"({spec.rate_ms:g} ms/s)",
                        retry_after_s=wait_s,
                        tenant=name,
                    )
                charged = est
            state.inflight += 1
            tclass = spec.tclass
        if self._metrics is not None:
            self._metrics.inc_labeled(
                "tenant_requests_total", ("tenant", "class"), (name, tclass)
            )
        return Grant(name, tclass, charged_ms=charged, metered=True)

    def release(self, grant: Grant) -> None:
        """End of the request: drop the in-flight slot.  Idempotent, and
        a no-op for fail-open grants (nothing was ever counted)."""
        if grant.failed_open or grant._released:
            return
        grant._released = True
        with self._lock:
            state = self._tenants.get(grant.tenant)
            if state is not None:
                state.inflight = max(0, state.inflight - 1)

    def charge_hit(self, grant: Grant) -> None:
        """Cache hit or coalesced waiter: the provisional device debit
        never runs on the device (a waiter's work is the LEADER's batch
        item, charged by the batcher) — refund it, keep a small fixed
        cost so the hit path is metered traffic, not free laundering
        (module docstring).  Idempotent: the refund drains to zero once
        ``charged_ms`` reaches the hit cost."""
        if grant.failed_open or not grant.metered:
            return
        with self._lock:
            state = self._tenants.get(grant.tenant)
            if state is None or state.bucket is None:
                return
            refund = grant.charged_ms - self.hit_cost_ms
            if refund > 0:
                state.bucket.credit(refund)
            grant.charged_ms = min(grant.charged_ms, self.hit_cost_ms)

    # ----------------------------------------------------- accounting

    def charge(self, tenant: str, cost_s: float) -> None:
        """One executed request's measured share of its batch wall (the
        batcher calls this per item at resolve).  Updates the tenant's
        device-time ledger, its admission-debit EWMA, the
        ``tenant_device_ms_total`` counter, and the fairness gauge."""
        ms = cost_s * 1e3
        with self._lock:
            state = self._state(tenant or DEFAULT_TENANT)
            if ms > 0 and state.device_ms == 0.0:
                self._dev_n += 1
            state.device_ms += ms
            self._dev_sum += ms
            if state.device_ms > self._dev_max:
                self._dev_max = state.device_ms
            state.ewma_ms = (
                ms
                if state.ewma_ms == 0.0
                else (1 - _EWMA_ALPHA) * state.ewma_ms + _EWMA_ALPHA * ms
            )
            fairness = self._fairness_locked()
        if self._metrics is not None:
            self._metrics.inc_labeled(
                "tenant_device_ms_total", "tenant", state.name, round(ms, 3)
            )
            self._metrics.set_gauge("tenant_fairness", fairness)

    def record_shed(self, tenant: str) -> None:
        """Any rejection charged to a tenant — quota 429, overload 503,
        bulk eviction — lands in ``tenant_shed_total{tenant=}``: the
        split the noisy-neighbor drill pins (all shed traffic must be
        charged to the abuser)."""
        with self._lock:
            # through _state so a past-the-cap name sheds as default
            # instead of minting a fresh label series
            self._shed_locked(self._state(tenant).name)

    def _shed_locked(self, tenant: str) -> None:
        if self._metrics is not None:
            self._metrics.inc_labeled("tenant_shed_total", "tenant", tenant)

    def _fairness_locked(self) -> float:
        """max/mean of per-tenant device time across tenants that have
        run anything — 1.0 is a perfectly fair split, like the lane
        imbalance gauge (one reading for "is someone hogging").  Served
        from the per-charge accumulators, so reading it (and charging)
        never walks the tenant table."""
        if self._dev_n == 0 or self._dev_sum <= 0:
            return 1.0
        return round(self._dev_max * self._dev_n / self._dev_sum, 4)

    def drop_tenant(self, name: str) -> None:
        """Forget a tenant's live state — bucket, EWMA, device ledger,
        in-flight count.  Drill/test surgery only (the qos drill
        installs a calibrated budget mid-run; a real fleet reboots or
        reloads): the fairness accumulators assume tenants are never
        evicted, so this is the one place that rebuilds them."""
        with self._lock:
            if self._tenants.pop(name, None) is None:
                return
            used = [
                t.device_ms for t in self._tenants.values() if t.device_ms > 0
            ]
            self._dev_n = len(used)
            self._dev_sum = sum(used)
            self._dev_max = max(used, default=0.0)

    # ----------------------------------------------------- jobs tier

    def job_budget(self, tenant: str) -> int:
        """0 = unlimited; the jobs tier checks queued+running
        jobs for the tenant against this before admitting a submit."""
        with self._lock:
            return self._state(tenant).spec.max_jobs

    # -------------------------------------------------------- surface

    def new_queue(self, clock=time.perf_counter) -> "DrrQueue":
        """One DRR queue per dispatcher (deconv/dream/sweep each own
        their submit queue, exactly like the FIFO they replace)."""
        return DrrQueue(self.weights, clock=clock)

    def snapshot(self) -> dict:
        """Live per-tenant occupancy for /v1/config."""
        with self._lock:
            return {
                "default_class": self.default_class,
                "weights": dict(self.weights),
                "hit_cost_ms": self.hit_cost_ms,
                "tenants": {
                    t.name: {
                        "class": t.spec.tclass,
                        "inflight": t.inflight,
                        "device_ms": round(t.device_ms, 3),
                        "ewma_cost_ms": round(t.ewma_ms, 4),
                        "tokens_ms": (
                            round(t.bucket.tokens, 3)
                            if t.bucket is not None
                            else None
                        ),
                        "rate_ms": t.spec.rate_ms or None,
                    }
                    for t in self._tenants.values()
                },
                "fairness": self._fairness_locked(),
            }

    def counts(self) -> dict:
        with self._lock:
            return {
                "tenants_active": len(self._tenants),
                "inflight": sum(t.inflight for t in self._tenants.values()),
            }


class DrrQueue:
    """Deficit-round-robin multi-queue keyed by (tenant, class), wire-
    compatible with the slice of ``asyncio.Queue`` the batcher uses
    (``put``/``get``/``get_nowait``/``qsize``/``empty``).

    SINGLE CONSUMER by contract: the batcher's one collect loop is the
    only ``get`` caller (puts may come from any task on the loop), which
    is what lets readiness be a bare Event instead of a waiter queue.

    Pop order:
    1. **Deadline jump** — a head-of-queue INTERACTIVE item within
       ``jump_s`` of its deadline pops ahead of the rotation.  Bulk
       (and standard) never jump: the privilege is exactly what the
       interactive class buys.  Expired items still go through the
       batcher's reap boundaries — the jump saves the savable, the reap
       504s the dead, and a jumped-then-expired item is never
       dispatched.
    2. **DRR** — the active queue at the front of the rotation serves
       while its deficit lasts (quantum × class weight added when the
       rotation reaches it), then rotates to the back.  An emptied
       queue leaves the rotation and forfeits its deficit — the
       standard DRR rule that stops an idle tenant banking credit.

    ``evict_bulk`` is the shed-order hook: overload evicts the NEWEST
    item of the deepest bulk queue (the request that would have waited
    longest anyway) so a higher-class arrival can take its place."""

    def __init__(
        self,
        weights: dict[str, int] | None = None,
        *,
        quantum: int = 1,
        jump_s: float = 0.25,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self._weights = dict(weights or DEFAULT_WEIGHTS)
        self._quantum = max(1, int(quantum))
        self._jump_s = float(jump_s)
        self._clock = clock
        self._queues: dict[tuple[str, str], deque] = {}
        self._active: deque[tuple[str, str]] = deque()
        self._in_active: set[tuple[str, str]] = set()
        # insertion-ordered set of the ACTIVE interactive keys — the
        # only class the jump scan can ever select, so the per-pop scan
        # is bounded by interactive tenants, not every active (tenant,
        # class) in the rotation (up to MAX_TENANTS under qos with no
        # spec, all on the collect loop's hot path)
        self._interactive: dict[tuple[str, str], None] = {}
        self._deficit: dict[tuple[str, str], float] = {}
        self._size = 0
        self._ready = asyncio.Event()

    @staticmethod
    def _key_of(item) -> tuple[str, str]:
        return (
            getattr(item, "tenant", "") or DEFAULT_TENANT,
            getattr(item, "tclass", "") or "standard",
        )

    def qsize(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    async def put(self, item) -> None:
        self.put_nowait(item)

    def put_nowait(self, item) -> None:
        key = self._key_of(item)
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        q.append(item)
        if key not in self._in_active:
            self._in_active.add(key)
            self._active.append(key)
            if key[1] == "interactive":
                self._interactive[key] = None
            self._deficit.setdefault(key, 0.0)
        self._size += 1
        self._ready.set()

    async def get(self):
        # single consumer: no await sits between the size check and the
        # clear, so a put on this loop cannot fall into the gap
        while True:
            if self._size:
                return self.get_nowait()
            self._ready.clear()
            await self._ready.wait()

    def get_nowait(self):
        if self._size == 0:
            raise asyncio.QueueEmpty
        item = self._pop_jump()
        if item is None:
            item = self._pop_drr()
        self._size -= 1
        if self._size == 0:
            self._ready.clear()
        return item

    def _deactivate(self, key: tuple[str, str]) -> None:
        # drop the key's queue and deficit entirely — an idle (tenant,
        # class) must not pin an empty deque per dispatcher forever
        self._in_active.discard(key)
        try:
            self._active.remove(key)
        except ValueError:
            pass
        self._interactive.pop(key, None)
        self._deficit.pop(key, None)
        self._queues.pop(key, None)

    def _pop_jump(self):
        if not self._interactive:
            return None
        now = self._clock()
        for key in self._interactive:
            q = self._queues[key]
            if (
                q
                and q[0].deadline is not None
                and q[0].deadline - now <= self._jump_s
            ):
                item = q.popleft()
                if not q:
                    self._deactivate(key)
                return item
        return None

    def _pop_drr(self):
        while True:
            key = self._active[0]
            q = self._queues.get(key)
            if not q:
                # emptied by a jump or an eviction while mid-rotation
                self._deactivate(key)
                continue
            if self._deficit[key] < 1.0:
                self._deficit[key] += self._quantum * self._weights.get(
                    key[1], 1
                )
                self._active.rotate(-1)
                continue
            self._deficit[key] -= 1.0
            item = q.popleft()
            if not q:
                self._deactivate(key)
            return item

    def evict_bulk(self):
        """Newest item of the deepest bulk queue, or None when no bulk
        traffic is queued (the caller then sheds the arrival itself)."""
        best: tuple[str, str] | None = None
        for key, q in self._queues.items():
            if key[1] == "bulk" and q and (
                best is None or len(q) > len(self._queues[best])
            ):
                best = key
        if best is None:
            return None
        q = self._queues[best]
        item = q.pop()
        if not q:
            self._deactivate(best)
        self._size -= 1
        if self._size == 0:
            self._ready.clear()
        return item

    def depths(self) -> dict[str, int]:
        """Queued items per class (operator surface, /v1/config)."""
        out: dict[str, int] = {}
        for (_, tclass), q in self._queues.items():
            if q:
                out[tclass] = out.get(tclass, 0) + len(q)
        return out
