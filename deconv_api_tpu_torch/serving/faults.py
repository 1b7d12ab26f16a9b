"""Fault injection registry: named failure sites, armed on demand (a copy
of ``deconv_api_tpu/serving/faults.py``; the port reaches the codec,
dispatch, batcher, device and HTTP sites).

Large-scale serving systems treat partial failure as a first-class input —
TensorFlow Serving's health-checked worker recovery (arXiv:1605.08695) and
the TPU serving comparison's tail-under-faults methodology (PAPERS.md) both
assume the failure paths are EXERCISABLE.  Ours were not: a codec worker
death, a crashed dispatch task, a flaky device — each could only be
observed by waiting for production to produce it.  This module makes every
such path a named, armable injection site:

- ``SITES``: the registry of known sites.  Each production call site
  consults the registry through the module-level ``check(site)`` hook,
  which is ZERO-COST while disabled — one global load and an ``is None``
  test, no lock, no dict lookup (pinned by tests/test_faults.py).

- ``FaultSpec`` / ``parse_fault_specs``: the arm grammar, shared by the
  ``--fault site=spec`` CLI flag, the ``DECONV_FAULTS`` env var, and the
  ``POST /v1/debug/faults`` one-shot endpoint.  ``spec`` is
  ``p<prob>``/``<prob>`` (fire with that probability per consultation),
  or ``n<count>`` (fire on the next <count> consultations, then
  self-disarm — the "burst" form), optionally ``:<param>`` for
  parameterized sites (milliseconds for the delay/hang/slow-write
  sites), optionally ``@<target>`` restricting the spec to
  one consulting identity — a backend name for the router-side
  ``fleet.*`` sites, a ``fleet_advertise`` name for the device sites.
  Multiple ``site=spec`` pairs join with commas.

- ``FaultRegistry``: lock-protected armed-spec table with a SEEDED
  ``random.Random`` so probabilistic chaos runs are reproducible, and
  per-site injection counters published as
  ``faults_injected_total{site=...}`` through the Metrics registry.

The registry is owned by the service (``DeconvService.faults``) and
installed into the module hook only when ``fault_injection`` is enabled;
a default-configured server never pays more than the disabled hook.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.faults")

# Every known injection site; arming an unknown one is a config error
# (a typo'd site would otherwise arm nothing and the drill would
# silently measure a healthy server).
SITES = (
    "codec.worker_raise",      # codec-pool worker dies mid-task
    "codec.worker_hang",       # codec-pool worker stalls for :param ms
    "dispatch.worker_raise",   # batcher dispatch-worker dies mid-task
    "dispatch.worker_hang",    # batcher dispatch-worker stalls :param ms
    "batcher.dispatch_raise",  # batcher dispatch-stage task crashes
    "device.dispatch_error",   # device batch dispatch raises (:param = lane)
    "device.dispatch_delay_ms",  # device batch dispatch stalls :param ms
    "http.slow_write",         # response write stalls :param ms
    "jobs.runner_crash",       # job runner dies at a checkpoint boundary
    "jobs.journal_write_error",  # LEGACY: alias of fs.fsync_error@jobs.journal
    "qos.admission_raise",     # QoS admission layer crashes (fails OPEN
                               # to the default tenant — availability
                               # over accounting; serving/qos.py)
    # Router-side NETWORK fault sites (serving/fleet.py): the
    # gray failures the backend-side device sites cannot manufacture —
    # a sick NIC, a congested cross-rack path, a half-dead conntrack
    # entry — live between the router and one backend, not inside the
    # backend's dispatch.  All are armable per backend via the
    # ``@<host:port>`` target selector below.
    "fleet.connect_delay_ms",  # router->backend connect stalls :param ms
    "fleet.head_delay_ms",     # response head arrives :param ms late
    "fleet.body_trickle",      # body trickles (:param ms per 64 KiB)
    "fleet.torn_body",         # response torn mid-body (infra failure)
    "fleet.blackhole",         # backend accepts, never answers (timeout)
    # Autoscale control-plane sites (serving/autoscale.py):
    # the controller's failure contract is fail-STATIC — a crashing
    # decision loop degrades to no-op (autoscaler_errors_total, fleet
    # keeps its size), a failed launch retries with backoff without
    # ever double-counting fleet capacity.  Both are drill-armable.
    "autoscale.decision_error",  # decision tick raises mid-evaluation
    "autoscale.launch_fail",     # backend launch attempt fails
    # Alert-engine site (serving/alerts.py): the evaluator's
    # failure contract is fail-STATIC — a crashing rule evaluation
    # increments alerts_eval_errors_total and leaves every rule's
    # lifecycle state EXACTLY where it was (a firing alert never flaps
    # to resolved because the evaluator died).  Drill-armable.
    "alerts.eval_error",         # alert rule evaluation raises mid-tick
    # Filesystem fault sites (serving/durable.py): every
    # durable write and verified read consults these with
    # ``who=<surface>`` (jobs.journal, jobs.spill, cache.l2,
    # fleet.membership, aot.store, autoscale.journal, alerts.incidents,
    # quant.calib), so ``fs.enospc=p1@cache.l2`` starves exactly one
    # surface and leaves the rest of the disk "healthy".
    "fs.enospc",        # write raises ENOSPC before any byte lands
    "fs.eio_read",      # read raises EIO (reads as absent by contract)
    "fs.short_write",   # write silently truncates (digest catches it)
    "fs.fsync_error",   # fsync raises EIO (data not durable)
    "fs.crash_point",   # SIGKILL self at crashpoint :param (durable.CRASH_*)
)

# Legacy spelling of the one older disk fault site.  Arming it
# rewrites to ``fs.fsync_error@jobs.journal`` (see FaultRegistry.arm)
# so old drill scripts and OPERATIONS recipes keep working while the
# fault vocabulary has one owner — durable.py consults only ``fs.*``.
_LEGACY_ALIASES = {
    "jobs.journal_write_error": ("fs.fsync_error", "jobs.journal"),
}


@dataclass
class FaultSpec:
    """One armed site: probability per consultation, optional one-shot
    remaining count (None = until disarmed), optional site parameter,
    optional ``@<target>`` selector restricting the spec to
    one consulting identity — the fleet router consults its sites with
    ``who=<backend host:port>``, so ``fleet.head_delay_ms=p1:150@b0:8000``
    grays exactly one backend's network path and leaves its peers
    untouched (the per-backend analogue of the lane-targeted ``where``)."""

    p: float = 1.0
    n: int | None = None
    param: float | None = None
    target: str | None = None

    def __str__(self) -> str:
        s = f"n{self.n}" if self.n is not None else f"p{self.p:g}"
        if self.param is not None:
            s += f":{self.param:g}"
        if self.target is not None:
            s += f"@{self.target}"
        return s


@dataclass
class FaultAction:
    """A fired fault, handed back to the call site (carries the spec's
    parameter, e.g. the delay in ms)."""

    site: str
    param: float | None = None


def parse_spec(raw: str) -> FaultSpec:
    """``p0.05`` / ``0.05`` / ``n3`` with an optional ``:<param>`` and an
    optional ``@<target>`` selector.  The target splits FIRST (it may
    itself contain ``:`` — backend targets are ``host:port``)."""
    head, at, target = raw.partition("@")
    head, _, param_s = head.partition(":")
    head = head.strip()
    spec = FaultSpec()
    if at:
        target = target.strip()
        if not target:
            raise ValueError(f"bad fault spec {raw!r}: empty @target")
        spec.target = target
    try:
        if head.startswith("n"):
            spec.n = int(head[1:])
            if spec.n <= 0:
                raise ValueError
        else:
            spec.p = float(head[1:] if head.startswith("p") else head)
            if not 0.0 < spec.p <= 1.0:
                raise ValueError
        if param_s:
            spec.param = float(param_s)
    except ValueError:
        raise ValueError(
            f"bad fault spec {raw!r}: want p<0..1], n<count>, or <0..1], "
            "optionally :<param>, optionally @<target>"
        ) from None
    return spec


def parse_fault_specs(raw: str) -> dict[str, FaultSpec]:
    """``site=spec,site=spec,...`` -> validated {site: FaultSpec}."""
    out: dict[str, FaultSpec] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        site, eq, spec = part.partition("=")
        site = site.strip()
        if not eq:
            raise ValueError(f"bad fault arm {part!r}: want site=spec")
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known: {', '.join(SITES)}"
            )
        out[site] = parse_spec(spec.strip())
    return out


class FaultRegistry:
    """Armed-fault table + deterministic RNG + injection accounting.

    ``check(site)`` is the only hot-path surface: returns a
    ``FaultAction`` when the site fires (decrementing one-shot counts,
    self-disarming at zero) and ``None`` otherwise.  All state is
    lock-protected — sites are consulted from the event loop, codec
    worker threads, and the dispatch worker thread."""

    def __init__(self, seed: int = 0, metrics=None):
        self._lock = threading.Lock()
        self._armed: dict[str, FaultSpec] = {}
        self._rng = random.Random(seed)
        self._injected: dict[str, int] = {}
        self._metrics = metrics

    def arm(self, site: str, spec: FaultSpec | str) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known: {', '.join(SITES)}"
            )
        if isinstance(spec, str):
            spec = parse_spec(spec)
        if site in _LEGACY_ALIASES:
            # the legacy disk-fault spelling rewrites onto the
            # fs.* vocabulary (an explicit @target on the old spelling
            # is preserved — it can only have meant the same surface)
            site, target = _LEGACY_ALIASES[site]
            if spec.target is None:
                spec.target = target
        with self._lock:
            self._armed[site] = spec
        slog.event(_log, "fault_armed", site=site, spec=str(spec))
        if self._metrics is not None:
            # the armed site's counter is present at zero from the
            # first scrape after arming (exposition lint)
            self._metrics.inc_labeled("faults_injected_total", "site", site, 0)
        self._publish()

    def arm_string(self, raw: str) -> None:
        """Arm every ``site=spec`` pair of a CLI/env/endpoint string."""
        for site, spec in parse_fault_specs(raw).items():
            self.arm(site, spec)

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site, or every site (None)."""
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)
        slog.event(_log, "fault_disarmed", site=site or "all")
        self._publish()

    def check(
        self,
        site: str,
        where: int | None = None,
        who: str | None = None,
    ) -> FaultAction | None:
        """``where`` is the call site's locality (the executor
        LANE consulting a device site).  A spec armed with a ``:<param>``
        on a lane-targetable site fires only when the param matches —
        ``device.dispatch_error=n8:1`` bursts lane 1 and leaves the rest
        of the pool untouched; non-matching consultations don't consume
        one-shot counts.  ``who`` is the call site's string
        identity — the fleet router's backend name, or a backend's own
        fleet-advertise name — matched against the spec's ``@<target>``
        selector the same way: a targeted spec never fires (and never
        consumes one-shot counts) for anyone else."""
        disarmed = False
        with self._lock:
            spec = self._armed.get(site)
            if spec is None:
                return None
            if spec.target is not None and who != spec.target:
                return None
            if (
                where is not None
                and spec.param is not None
                and int(spec.param) != where
            ):
                return None
            if spec.p < 1.0 and self._rng.random() >= spec.p:
                return None
            if spec.n is not None:
                spec.n -= 1
                if spec.n <= 0:
                    del self._armed[site]
                    disarmed = True
            self._injected[site] = self._injected.get(site, 0) + 1
        if self._metrics is not None:
            self._metrics.inc_labeled("faults_injected_total", "site", site)
        if disarmed:
            # the armed-count gauge only moves when a one-shot spec
            # self-disarms; publishing on every fire would pay an extra
            # lock round-trip per injection on sustained chaos
            self._publish()
        return FaultAction(site, spec.param)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "armed": {s: str(spec) for s, spec in self._armed.items()},
                "injected": dict(self._injected),
            }

    def _publish(self) -> None:
        if self._metrics is not None:
            with self._lock:
                n = len(self._armed)
            self._metrics.set_gauge("faults_armed", n)


# ------------------------------------------------------- module-level hook

# The zero-cost-when-disabled hook: production call sites do
# ``faults.check(site)`` unconditionally; with no registry installed that
# is one module-global load and an ``is None`` branch.  The service
# installs its registry only when cfg.fault_injection is on.
_REGISTRY: FaultRegistry | None = None


def install(registry: FaultRegistry) -> None:
    global _REGISTRY
    _REGISTRY = registry


def uninstall(registry: FaultRegistry | None = None) -> None:
    """Remove the installed registry.  Pass the registry you installed so
    a service tearing down cannot evict one installed after it."""
    global _REGISTRY
    if registry is None or _REGISTRY is registry:
        _REGISTRY = None


def installed() -> FaultRegistry | None:
    return _REGISTRY


def check(
    site: str, where: int | None = None, who: str | None = None
) -> FaultAction | None:
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.check(site, where, who)


def raise_if_armed(
    site: str, where: int | None = None, who: str | None = None
) -> None:
    """Shared raise-form consultation: the site fires -> FaultInjected."""
    act = check(site, where, who)
    if act is not None:
        raise errors.FaultInjected(f"injected fault at {site}")
