"""Async batching dispatcher and batch buckets (a copy of
``deconv_api_tpu/serving/batcher.py``, and the
tail padding of ``deconv_api_tpu/serving/codec_pool.py:assemble``).

Requests ``await submit(image, key, deadline)``; the dispatcher coalesces
them into device batches in a THREE-STAGE pipeline:

- collect: the ``_run`` loop drains the submit queue greedily
  (``_drain_nowait``), waits a straggler window only while a batch is in
  flight (an idle device dispatches at once), drops expired deadlines,
  and hands the batch to a bounded queue;
- dispatch: one task takes collected batches in order, groups them by
  key (one device program each), picks the executor lane whose breaker
  admits the group, and runs ``dispatch_runner(key, images)`` on the
  lane's persistent dispatch worker thread.  The runner enqueues the
  device work WITHOUT waiting for it and returns a thunk;
- fetch: a fetch task runs the thunk on a daemon thread (it waits for
  the device, copies results out, encodes) while later batches dispatch.
  ``pipeline_depth`` bounds the dispatched-but-unfetched batches of a
  lane; depth 1 restores the serial dispatch->fetch->resolve loop with
  ``runner(key, images) -> results``.

Deadlines are dropped at the queue pop and again before dispatch; an
arrival whose queue would take longer than the request timeout to drain
(``_estimated_drain_s``) is shed with a 503 ``overloaded`` and a
``Retry-After``; consecutive failed batches open a lane's
``CircuitBreaker`` (503 ``breaker_open`` while it cools, one half-open
probe after); a crashed collect or dispatch task is restarted
(``_supervised``); ``stop(grace_s)`` drains in-flight fetches within the
grace and fails everything queued.

A dispatched batch runs at the smallest power-of-two bucket that holds it,
its tail filled with copies of its last image, so the set of program shapes
a server ever captures is bounded (1, 2, 4, 8 at ``max_batch`` 8).  Each
row's result depends on its own image alone, so the padding rows are
computed and dropped.
"""

from __future__ import annotations

import asyncio
import collections
import inspect
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import faults
from deconv_api_tpu_torch.serving import trace as trace_mod
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.batcher")


def pad_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch: bounds the set of
    batch shapes ever captured."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def buckets(max_batch: int) -> list[int]:
    """Every bucket a batch of 1..max_batch images lands in."""
    return sorted({pad_bucket(n, max_batch) for n in range(1, max_batch + 1)})


def pad_to_bucket(xs: np.ndarray, bucket: int) -> np.ndarray:
    """(n, ...) images -> (bucket, ...) float32, the tail filled with the
    last image."""
    xs = np.asarray(xs, dtype=np.float32)
    n = len(xs)
    if not 1 <= n <= bucket:
        raise ValueError(f"{n} images do not fit a bucket of {bucket}")
    if n == bucket:
        return np.ascontiguousarray(xs)
    out = np.empty((bucket, *xs.shape[1:]), np.float32)
    out[:n] = xs
    out[n:] = xs[-1]
    return out


class CircuitBreaker:
    """Consecutive-failure circuit breaker around device dispatch.

    The device's documented failure modes (a wedged or dying device)
    make EVERY dispatch fail for a while; without a breaker each doomed
    request still queues, dispatches, and burns its full timeout.  States:

    - CLOSED: normal; ``threshold`` CONSECUTIVE recorded failures open it
      (any success resets the streak).
    - OPEN: ``allow()`` answers False — callers fail fast with 503
      ``breaker_open`` + a Retry-After derived from the remaining
      cooldown — until ``cooldown_s`` elapses.
    - HALF_OPEN: after the cooldown exactly ONE caller is admitted as the
      probe; its success closes the breaker, its failure re-opens (fresh
      cooldown).  Other callers keep failing fast while the probe is in
      flight, so a recovering device sees one batch, not a stampede.

    Shared by all dispatchers that sit on one device (they fail
    together).  Lock-protected: outcomes are recorded from the event
    loop and from worker threads; state transitions publish the
    ``breaker_state`` gauge (0 closed / 1 half-open / 2 open) and a
    ``breaker_open_total`` counter through Metrics, plus slog events.
    ``clock`` is injectable so cooldown tests never sleep."""

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2
    _NAMES = {0: "closed", 1: "half-open", 2: "open"}

    def __init__(
        self,
        threshold: int = 5,
        cooldown_s: float = 5.0,
        *,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0  # consecutive, while closed
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_at = 0.0
        self._publish()

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    @property
    def state_name(self) -> str:
        return self._NAMES[self.state]

    def accepting(self) -> bool:
        """Would a request arriving now be admitted (or at least be the
        recovery probe)?  This — not raw state — is what /readyz must
        report: state only transitions OPEN→HALF_OPEN inside allow(),
        so a load balancer that pulls traffic on 'open' would starve the
        breaker of the very probe that closes it.  Reporting ready once
        the cooldown has elapsed lets one routed request run the probe."""
        with self._lock:
            if self._state != self.OPEN:
                return True
            return self._clock() >= self._opened_at + self.cooldown_s

    def admit_hint(self) -> tuple[bool, float]:
        """(would a request arriving now be admitted?, retry-after when
        not) — WITHOUT claiming the half-open probe.  The lane pool asks
        this at submit time (fail fast only when every lane is open and
        cooling); the probe itself is claimed by ``allow()`` at dispatch
        time, on the lane the scheduler actually picked."""
        with self._lock:
            if self._state != self.OPEN:
                return True, 0.0
            remaining = self._opened_at + self.cooldown_s - self._clock()
            return remaining <= 0, max(remaining, 1.0)

    def allow(self) -> tuple[bool, float]:
        """(admit this request?, retry-after seconds when not)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True, 0.0
            remaining = self._opened_at + self.cooldown_s - self._clock()
            if self._state == self.OPEN and remaining <= 0:
                # cooldown over: half-open, admit exactly one probe
                self._state = self.HALF_OPEN
                self._probe_inflight = True
                self._probe_at = self._clock()
                self._transition("breaker_half_open")
                return True, 0.0
            if self._state == self.HALF_OPEN and (
                not self._probe_inflight
                # a probe that never reported back (shed, reaped, or
                # lost before dispatch) must not wedge the breaker
                # half-open forever; its claim expires after a cooldown
                or self._clock() - self._probe_at >= self.cooldown_s
            ):
                self._probe_inflight = True
                self._probe_at = self._clock()
                return True, 0.0
            return False, max(remaining, 1.0)

    def record_success(self) -> None:
        with self._lock:
            if self._state == self.OPEN:
                # a straggler dispatched BEFORE the open; the open
                # window holds until the cooldown + probe decide, so a
                # lucky straggler can never flap the breaker shut
                return
            self._failures = 0
            self._probe_inflight = False
            if self._state == self.HALF_OPEN:
                self._state = self.CLOSED
                self._transition("breaker_close")

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == self.HALF_OPEN:
                # failed probe: straight back to open, fresh cooldown
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._transition("breaker_reopen")
                return
            if self._state == self.OPEN:
                return  # in-flight stragglers from before the open
            self._failures += 1
            if self._failures >= self.threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._transition("breaker_open")

    def _transition(self, event: str) -> None:
        # called under the lock; logging/gauge publication are cheap
        slog.event(
            _log, event, level=logging.WARNING,
            state=self._NAMES[self._state], failures=self._failures,
            cooldown_s=self.cooldown_s,
        )
        if self._metrics is not None and self._state == self.OPEN:
            self._metrics.inc_counter("breaker_open_total")
        self._publish()

    def _publish(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("breaker_state", self._state)


# EWMA smoothing for a lane's observed batch cost, and the seed cost a
# lane with no history pretends to have: with no observation every idle
# lane ties at load 0 and the pick's least-pick tiebreak round-robins,
# which is exactly what warms every lane.
_EWMA_ALPHA = 0.2
_EWMA_SEED_S = 1e-3


class ExecutorLane:
    """One executor lane's shared state: the load signal (in-flight depth
    + EWMA batch cost) and the lane's own circuit breaker.

    The lane is SHARED by every dispatcher that can schedule onto its
    chip (deconv/dream/sweep sit on the same devices, so their load and
    failures are correlated per chip); the per-dispatcher pieces — the
    lane's dispatch worker thread and fetch-permit budget — live on the
    dispatcher.  Lock-protected: outcomes are recorded from the event
    loop and from fetch completions racing on it."""

    def __init__(self, index: int, breaker: CircuitBreaker | None = None):
        self.index = index
        self.breaker = breaker
        self._lock = threading.Lock()
        self.inflight = 0  # dispatched-but-unfinished groups on this chip
        self.ewma_s = 0.0  # smoothed dispatch->done wall per batch
        self.batches = 0  # executed batches (the occupancy ledger)
        self.picks = 0  # scheduler picks (ties round-robin on this)

    def load(self) -> float:
        """Estimated pending seconds on this lane — the least-loaded
        scheduling signal: queued depth times what a batch has been
        costing here lately."""
        with self._lock:
            return self.inflight * (self.ewma_s or _EWMA_SEED_S)

    def note_dispatched(self) -> None:
        with self._lock:
            self.inflight += 1
            self.picks += 1

    def note_done(self, wall_s: float, ok: bool = True) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            self.batches += 1
            if not ok:
                # a failure's wall says nothing about the lane's true
                # batch cost — fast-failing dispatches would collapse
                # the EWMA and make the SICK lane look cheapest, so the
                # scheduler would chase it (its breaker only saves the
                # pool once failures are consecutive)
                return
            self.ewma_s = (
                wall_s
                if self.ewma_s == 0.0
                else (1 - _EWMA_ALPHA) * self.ewma_s + _EWMA_ALPHA * wall_s
            )

    def note_cancelled(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)


class LanePool:
    """The set of executor lanes one service schedules over, shared by
    all of its dispatchers.  Owns the least-loaded pick, the pool-level
    admission answer (fail fast only when EVERY lane is open and
    cooling), and the per-lane metrics: ``lane_inflight{lane=}`` /
    ``lane_breaker_state{lane=}`` gauges, ``lane_batches_total{lane=}``
    counters, and a ``lane_imbalance`` gauge (max/mean of per-lane
    executed batches — 1.0 is a perfectly balanced pool).

    A single-lane pool is the exact pre-lane serving path: one stream,
    one (optional) breaker, no placement decisions."""

    def __init__(
        self,
        n: int = 1,
        *,
        breaker_factory: Callable[[], CircuitBreaker | None] | None = None,
        breakers: list[CircuitBreaker | None] | None = None,
        metrics=None,
    ):
        if breakers is None:
            breakers = [
                breaker_factory() if breaker_factory is not None else None
                for _ in range(n)
            ]
        if len(breakers) != n:
            raise ValueError(f"{n} lanes need {n} breakers, got {len(breakers)}")
        self.lanes = [ExecutorLane(i, breakers[i]) for i in range(n)]
        self._metrics = metrics
        self._lock = threading.Lock()
        for lane in self.lanes:
            self._publish_lane(lane)
        self._publish_pool()

    @property
    def size(self) -> int:
        return len(self.lanes)

    def admit(self) -> tuple[bool, float]:
        """Pool-level fail-fast answer for submit(): admit while ANY lane
        would take the request (or run its recovery probe); when every
        lane is open and cooling, reject with the soonest lane's
        retry-after — the pool is only as dead as its healthiest lane."""
        retry = 0.0
        for lane in self.lanes:
            if lane.breaker is None:
                return True, 0.0
            ok, lane_retry = lane.breaker.admit_hint()
            if ok:
                return True, 0.0
            retry = lane_retry if retry == 0.0 else min(retry, lane_retry)
        return False, max(retry, 1.0)

    def pick(self) -> tuple[ExecutorLane | None, float]:
        """Least-loaded lane whose breaker admits the dispatch (claiming
        the half-open probe when that is what admission means).  Ties
        break on fewest picks — an idle pool round-robins, which warms
        every lane — then index.  (None, retry_after) when no lane
        admits: the group fails fast instead of burning its timeout."""
        order = sorted(
            self.lanes, key=lambda l: (l.load(), l.inflight, l.picks, l.index)
        )
        retry = 0.0
        for lane in order:
            if lane.breaker is None:
                return lane, 0.0
            ok, lane_retry = lane.breaker.allow()
            if ok:
                # allow() may have claimed the half-open probe
                # (OPEN -> HALF_OPEN); refresh the lane's state gauge
                self._publish_lane(lane)
                return lane, 0.0
            retry = lane_retry if retry == 0.0 else min(retry, lane_retry)
        return None, max(retry, 1.0)

    def record_dispatched(self, lane: ExecutorLane) -> None:
        lane.note_dispatched()
        self._publish_lane(lane)

    def record_done(
        self, lane: ExecutorLane, ok: bool, wall_s: float, n: int = 0
    ) -> None:
        """One executed group's outcome: lane load signal, lane breaker,
        and the per-lane metric series (``n`` = member requests, for the
        lane-occupancy ledger the loopback row reports)."""
        lane.note_done(wall_s, ok)
        if lane.breaker is not None:
            pre = lane.breaker.state
            if ok:
                lane.breaker.record_success()
            else:
                lane.breaker.record_failure()
            # count EVERY open transition — including a failed probe's
            # HALF_OPEN -> OPEN reopen, which a sampled edge detector
            # would miss because allow() went half-open in between
            if (
                self._metrics is not None
                and pre != CircuitBreaker.OPEN
                and lane.breaker.state == CircuitBreaker.OPEN
            ):
                self._metrics.inc_counter("breaker_open_total")
        if self._metrics is not None:
            self._metrics.inc_labeled(
                "lane_batches_total", "lane", str(lane.index)
            )
            if n:
                self._metrics.inc_labeled(
                    "lane_requests_total", "lane", str(lane.index), n
                )
        self._publish_lane(lane)
        self._publish_pool()

    def record_cancelled(self, lane: ExecutorLane) -> None:
        """A dispatched group whose outcome is unknowable (shutdown
        cancelled the await): release the lane's load signal without
        recording a breaker outcome — a drain is not a device failure."""
        lane.note_cancelled()
        self._publish_lane(lane)

    def accepting_count(self) -> int:
        return sum(
            1
            for lane in self.lanes
            if lane.breaker is None or lane.breaker.accepting()
        )

    def accepting(self) -> bool:
        """Would the pool admit a request arriving now? (the /readyz
        gate: degraded-but-serving is READY; only a pool with every
        lane open-and-cooling should be pulled from rotation)."""
        return self.accepting_count() > 0

    def state_name(self) -> str:
        """Aggregate breaker state for /v1/config: a single lane reports
        its breaker verbatim (the pre-lane contract); a pool reports
        closed / degraded (some lanes open) / open (none accepting)."""
        if not any(lane.breaker is not None for lane in self.lanes):
            return "closed"
        if self.size == 1:
            return self.lanes[0].breaker.state_name
        states = [
            lane.breaker.state for lane in self.lanes if lane.breaker is not None
        ]
        if all(s == CircuitBreaker.CLOSED for s in states):
            return "closed"
        return "degraded" if self.accepting() else "open"

    def snapshot(self) -> dict:
        """Per-lane occupancy for /v1/config and the loopback row."""
        return {
            "lanes": self.size,
            "accepting": self.accepting_count(),
            "per_lane": [
                {
                    "lane": lane.index,
                    "inflight": lane.inflight,
                    "batches": lane.batches,
                    "ewma_ms": round(lane.ewma_s * 1e3, 3),
                    "breaker": (
                        lane.breaker.state_name
                        if lane.breaker is not None
                        else "none"
                    ),
                }
                for lane in self.lanes
            ],
        }

    def _publish_lane(self, lane: ExecutorLane) -> None:
        if self._metrics is None:
            return
        self._metrics.set_labeled_gauge(
            "lane_inflight", "lane", str(lane.index), lane.inflight
        )
        if lane.breaker is not None:
            self._metrics.set_labeled_gauge(
                "lane_breaker_state", "lane", str(lane.index),
                lane.breaker.state,
            )

    def _publish_pool(self) -> None:
        if self._metrics is None:
            return
        with self._lock:
            counts = [lane.batches for lane in self.lanes]
            total = sum(counts)
            imbalance = (
                max(counts) * len(counts) / total if total > 0 else 1.0
            )
            self._metrics.set_gauge("lane_imbalance", round(imbalance, 4))
            self._metrics.set_gauge("lanes_accepting", self.accepting_count())
            # pool-aggregate breaker surface: the worst lane's state
            # (open transitions are counted in record_done, where they
            # happen — the pre-lane breaker_state/breaker_open_total
            # series live on)
            worst = 0
            for lane in self.lanes:
                if lane.breaker is not None:
                    worst = max(worst, lane.breaker.state)
            self._metrics.set_gauge("breaker_state", worst)


def _accepts_lane(fn) -> bool:
    """Does a runner take the scheduler's ``lane`` keyword?  Probed once
    at dispatcher construction so legacy 2-arg runners (tests, embedders)
    keep working unchanged on a single-lane pool."""
    if fn is None:
        return False
    try:
        return "lane" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # C callables etc.
        return False


def _to_daemon_thread(fn: Callable[[], Any]) -> asyncio.Future:
    """Run ``fn`` on a fresh DAEMON thread, resolving an asyncio future.

    asyncio.to_thread uses the default executor, whose threads are
    non-daemon and joined at interpreter exit — a device fetch wedged in one
    (the documented hang-not-raise backend failure mode) blocks process
    exit forever even after the awaiting task is cancelled.  A daemon
    thread lets the interpreter exit once the event loop is done with it.
    Thread-per-call is fine at batch granularity (~100ms+ each)."""
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()

    def _resolve(setter, value):
        if not fut.cancelled():
            setter(value)

    def post(setter, value):
        try:
            loop.call_soon_threadsafe(_resolve, setter, value)
        except RuntimeError:  # the loop closed while the work ran
            pass

    def work():
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the future
            post(fut.set_exception, e)
        else:
            post(fut.set_result, result)

    threading.Thread(target=work, daemon=True, name="batch-worker").start()
    return fut


@dataclass
class WorkItem:
    image: Any  # (H, W, C) np/jnp array, preprocessed
    key: Any  # groupable static config, e.g. (layer_name, mode)
    # the submitting request's trace, captured at submit time:
    # the dispatcher stamps queue-wait/dispatch/fetch spans and the
    # executed batch's id onto it from _resolve
    trace: Any = None
    # absolute perf_counter deadline: expired items are reaped
    # at the queue-pop and pre-dispatch boundaries — never dispatched
    deadline: float | None = None
    # tenancy (serving/qos.py): the DRR queue keys on
    # (tenant, tclass), the resolve path charges the tenant its measured
    # share of the batch wall.  Empty = the default tenant/class (every
    # pre-QoS caller, and the whole qos-off path).
    tenant: str = ""
    tclass: str = ""
    future: asyncio.Future = field(default_factory=asyncio.Future)
    enqueued_at: float = field(default_factory=time.perf_counter)


class BatchingDispatcher:
    """Owns the device; callers `await submit(...)`.

    `runner(key, images) -> list[result]` executes one compiled batch; it is
    called in a worker thread, never on the event loop.
    """

    def __init__(
        self,
        runner: Callable[[Any, list[Any]], list[Any]],
        *,
        max_batch: int = 8,
        window_ms: float = 3.0,
        request_timeout_s: float = 60.0,
        metrics=None,
        shed_factor: float = 1.0,
        dispatch_runner: Callable[[Any, list[Any]], Callable[[], list[Any]]]
        | None = None,
        pipeline_depth: int = 2,
        breaker: CircuitBreaker | None = None,
        lane_pool: LanePool | None = None,
        qos=None,
    ):
        self._runner = runner
        # Multi-tenant QoS (serving/qos.py): with a policy installed the
        # single FIFO becomes a deficit-round-robin multi-queue keyed by
        # (tenant, class), and the resolve path charges each tenant its
        # measured share of the batch wall (the device-time meter the
        # admission buckets debit).  qos=None keeps the plain FIFO path.
        self._qos = qos
        # Executor lanes: the service passes ONE pool shared by all its
        # dispatchers (their load and failures are correlated per chip); a
        # bare ``breaker=`` builds a single-stream pool around it.
        # Admission is gated pool-wide in submit() (fail fast only when
        # every lane is open and cooling); the per-lane breaker claim and
        # outcome recording happen at dispatch, on the lane picked.
        self._pool = (
            lane_pool
            if lane_pool is not None
            else LanePool(1, breakers=[breaker])
        )
        self._max_batch = max_batch
        self._window_s = window_ms / 1e3
        self._timeout_s = request_timeout_s
        # plain FIFO, or the QoS policy's DRR multi-queue: both expose the
        # same put/get/get_nowait/qsize/empty slice
        self._queue = qos.new_queue() if qos is not None else asyncio.Queue()
        # images per executed batch, the most recent ones
        self.batch_sizes: collections.deque[int] = collections.deque(maxlen=4096)
        self._task: asyncio.Task | None = None
        self._metrics = metrics
        self._shed_factor = shed_factor
        self._inflight = 0  # dispatched-or-pending groups not yet resolved
        # Pipelined mode: `dispatch_runner(key, images)` enqueues
        # the device program WITHOUT blocking and returns a thunk that
        # materialises results; the thunk runs in a separate fetch task so
        # the dispatcher can collect and dispatch the NEXT batch while this
        # one's results stream back to the host (the device executes
        # in-order regardless).  `pipeline_depth` bounds dispatched-but-
        # unfetched batches — the device-side working set — via a
        # semaphore; depth<=1 or dispatch_runner=None restores the fully
        # serial dispatch->fetch->resolve loop.
        self._dispatch_runner = dispatch_runner if pipeline_depth > 1 else None
        # pipeline_depth is PER LANE: each lane may hold that
        # many dispatched-but-unfetched batches, so a deep pipeline on
        # one chip never starves the others of dispatches.
        self._fetch_sems = [
            asyncio.Semaphore(max(1, pipeline_depth))
            for _ in range(self._pool.size)
        ]
        self._fetch_tasks: set[asyncio.Task] = set()
        self._last_done: float | None = None  # cadence observation anchor
        self._stopping = False
        # Three-stage handoff: collected batches queue here for
        # the dispatch-stage task.  The bound is the pipeline's
        # backpressure — when the device is behind, put() blocks the
        # collect loop, the submit queue grows, and the shed estimator
        # sees the depth.
        self._dispatch_q: asyncio.Queue[list[WorkItem]] = asyncio.Queue(
            maxsize=max(1, pipeline_depth) * self._pool.size
        )
        self._dispatch_task: asyncio.Task | None = None
        self._staged = 0  # items handed to the dispatch stage, not yet dispatched
        # One PERSISTENT dispatch worker thread PER LANE (vs a fresh
        # daemon thread per batch): device dispatch is a short async
        # enqueue, so thread spawn + first-schedule latency dominated it.
        # Per-dispatcher AND per-lane, so one stream's first-use compile
        # (an unwarmed sweep program, or a cold lane's first executable)
        # can never stall another lane's dispatches.  Fetches keep
        # thread-per-call — a wedged device fetch must only ever wedge its
        # own thread.
        self._dispatch_workers: list | None = None

    async def start(self) -> None:
        if self._task is None:
            self._stopping = False  # allow a stop() -> start() restart cycle
            self._task = asyncio.create_task(
                self._supervised("collect", self._run), name="batch-dispatcher"
            )
            if self._dispatch_runner is not None:
                if self._dispatch_workers is None:
                    from deconv_api_tpu_torch.serving.codec_pool import WorkerPool

                    # all lanes share the "dispatch" fault-site name, so
                    # dispatch.worker_raise/_hang drills hit whichever
                    # lane the scheduler picks
                    self._dispatch_workers = [
                        WorkerPool(1, name="dispatch")
                        for _ in range(self._pool.size)
                    ]
                self._dispatch_task = asyncio.create_task(
                    self._supervised("dispatch", self._dispatch_stage),
                    name="batch-dispatch-stage",
                )

    async def _supervised(self, name: str, body: Callable) -> None:
        """Self-healing supervision: a pipeline task that dies
        from an unexpected exception is logged, counted, and RESTARTED
        with exponential backoff — before this, a crashed collect or
        dispatch task silently wedged the pipeline until every queued
        request burned its full timeout.  The crashing iteration has
        already failed its in-flight futures (see the per-iteration
        guards in _run/_dispatch_stage), so the restart never strands a
        caller.  Cancellation (stop()) passes through untouched."""
        backoff = 0.05
        while True:
            try:
                await body()
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — supervised restart
                slog.event(
                    _log, "task_crash", level=logging.ERROR,
                    task=name, error=f"{type(e).__name__}: {e}",
                    backoff_s=backoff,
                )
                if self._metrics is not None:
                    self._metrics.inc_labeled(
                        "task_restarts_total", "task", name
                    )
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    def queued_by_class(self) -> dict[str, int]:
        """Queued items per priority class (empty on the FIFO path: there
        are no classes to split by)."""
        depths = getattr(self._queue, "depths", None)
        return depths() if depths is not None else {}

    def tasks_alive(self) -> bool:
        """Both pipeline tasks running (the /readyz batcher check).  The
        supervisor restarts crashed tasks, so False means either not
        started or cancelled — a server that should not receive traffic."""
        if self._task is None or self._task.done():
            return False
        if self._dispatch_runner is not None:
            return self._dispatch_task is not None and not self._dispatch_task.done()
        return True

    async def stop(self, grace_s: float = 10.0) -> None:
        # Reject new submits immediately: a request racing stop() could
        # otherwise enqueue after the drain loop below and sit in a
        # dispatcherless queue until its full request-timeout 504.
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._dispatch_task is not None:
            # Cancel the dispatch stage AFTER the collect loop so nothing
            # new enters the handoff queue; _execute_pipelined's own
            # cancellation handling fails the in-flight group's futures.
            self._dispatch_task.cancel()
            try:
                await self._dispatch_task
            except asyncio.CancelledError:
                pass
            self._dispatch_task = None
        if self._dispatch_workers is not None:
            for w in self._dispatch_workers:
                w.close()
            self._dispatch_workers = None  # start() builds fresh ones
        # Batches still staged in the handoff queue were never dispatched:
        # fail them now or they hang to a full request-timeout 504.
        while not self._dispatch_q.empty():
            for item in self._dispatch_q.get_nowait():
                self._staged -= 1
                if not item.future.done():
                    item.future.set_exception(
                        errors.Unavailable("server shutting down")
                    )
        if self._fetch_tasks:
            # Bounded drain: a wedged remote device fetch HANGS rather than
            # raises (documented backend failure mode), and an unbounded
            # gather here would stall graceful shutdown indefinitely —
            # leaving only the second-signal os._exit escape.  On timeout,
            # cancel the stragglers; _finish fails their futures.
            done, pending = await asyncio.wait(
                tuple(self._fetch_tasks), timeout=grace_s
            )
            if pending:
                _log.warning(
                    "%d in-flight fetch task(s) exceeded the %.0fs shutdown "
                    "grace; cancelling", len(pending), grace_s,
                )
                for t in pending:
                    t.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
        # Items still queued (never picked up by a drain window) fail fast
        # with the same shutdown signal as the interrupted window — without
        # this they would hang to a full request-timeout 504.
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if not item.future.done():
                item.future.set_exception(
                    errors.Unavailable("server shutting down")
                )

    def _estimated_drain_s(self) -> float:
        """Time for the work ahead of a new arrival to clear.  0.0 while
        unmeasured (cold start) AND whenever the queue is empty: an
        empty-queue arrival rides the very next batch, and always accepting
        it guarantees liveness — if everything shed, no batch would ever
        run and the p50 estimate could never correct itself.

        Rate source: the batch-completion CADENCE median when observed
        (interval between consecutive completions while more work was in
        flight — the true sustained rate, which under pipelining is
        shorter than any single batch's dispatch->fetch wall), falling
        back to compute_p50 before any sustained load has been seen."""
        if self._metrics is None:
            return 0.0
        # staged items (collected, waiting in the dispatch handoff queue)
        # are work ahead of a new arrival exactly like queued ones
        depth = self._queue.qsize() + self._staged
        if depth == 0:
            return 0.0
        p50 = self._metrics.cadence_p50()
        if p50 <= 0.0:
            p50 = self._metrics.compute_p50()
        if p50 <= 0.0:
            return 0.0
        # Divide by the OBSERVED executed-batch size, not max_batch: mixed
        # keys split a drain window into per-key executions, so the
        # effective batch size can be far below max_batch.  _inflight
        # counts dispatched-or-executing groups the queue no longer shows.
        eff_batch = min(
            float(self._max_batch), max(1.0, self._metrics.batch_size_p50())
        )
        return (depth / eff_batch + self._inflight) * p50

    async def submit(
        self,
        image: Any,
        key: Any,
        deadline: float | None = None,
        tenant: str = "",
        tclass: str = "",
    ) -> Any:
        if self._stopping:
            raise errors.Unavailable("server shutting down")
        tr = trace_mod.current_trace()
        allowed, retry_s = self._pool.admit()
        if not allowed:
            # fail fast: every lane's breaker is open and cooling, so
            # every dispatch is overwhelmingly likely to fail — queueing
            # this request would only burn its timeout against dead
            # devices.  One sick lane never trips this: admit() answers
            # yes while any lane would serve (degraded, not dead).
            if tr is not None:
                tr.annotate(breaker="open")
            raise errors.BreakerOpen(
                "device circuit breaker is open on every lane; failing fast",
                retry_after_s=retry_s,
            )
        now = time.perf_counter()
        if deadline is not None:
            # the caller's x-deadline-ms budget, capped by the server's
            # own request timeout (a deadline cannot EXTEND the wait)
            deadline = min(deadline, now + self._timeout_s)
            if now >= deadline:
                self._count_deadline(tr, now, 0.0)
                raise errors.DeadlineExpired(
                    "deadline expired before the request could be queued"
                )
        # Load shedding: when the queue already needs longer
        # than the request timeout to drain, every excess request is a
        # guaranteed 504 after a full timeout's wait — reject it NOW with a
        # 503 so callers can back off / retry elsewhere.  The drain
        # estimate rides on the error so the route's 503 carries a
        # Retry-After derived from the queue's actual state.
        if self._shed_factor > 0:
            drain_s = self._estimated_drain_s()
            if drain_s > self._timeout_s * self._shed_factor:
                # Class-ordered shed: a non-bulk arrival on a QoS queue
                # evicts the newest queued bulk item instead of being
                # rejected, and the eviction is charged to the evicted
                # item's tenant.
                evicted = None
                if self._qos is not None and tclass != "bulk":
                    evicted = self._queue.evict_bulk()
                if evicted is not None:
                    self._qos.record_shed(evicted.tenant)
                    if evicted.trace is not None:
                        evicted.trace.add_span(
                            "queue_wait", evicted.enqueued_at,
                            time.perf_counter() - evicted.enqueued_at,
                            shed=True, evicted_for_class=tclass,
                            drain_estimate_s=round(drain_s, 3),
                        )
                    if not evicted.future.done():
                        evicted.future.set_exception(
                            errors.Overloaded(
                                "bulk request evicted under overload for a "
                                "higher-class arrival",
                                retry_after_s=drain_s,
                            )
                        )
                    # the arrival takes the evicted slot: fall through
                else:
                    if self._qos is not None:
                        self._qos.record_shed(tenant)
                    if tr is not None:
                        # a shed request never enqueues: its queue-wait
                        # span is zero-length but carries the drain
                        # estimate that shed it, so the error trace
                        # explains the 503
                        tr.add_span(
                            "queue_wait", time.perf_counter(), 0.0,
                            shed=True, drain_estimate_s=round(drain_s, 3),
                        )
                    raise errors.Overloaded(
                        f"queue drain estimate {drain_s:.1f}s exceeds "
                        f"{self._timeout_s:.0f}s request timeout; shedding",
                        retry_after_s=drain_s,
                    )
        item = WorkItem(
            image=image, key=key, trace=tr, deadline=deadline,
            tenant=tenant, tclass=tclass,
        )
        await self._queue.put(item)
        wait_s = self._timeout_s
        if deadline is not None:
            wait_s = min(wait_s, max(deadline - time.perf_counter(), 0.001))
        try:
            return await asyncio.wait_for(item.future, wait_s)
        except asyncio.TimeoutError:
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                # the reap boundaries usually fail the future first; this
                # covers a deadline that lapses while work is IN FLIGHT
                self._count_deadline(tr, item.enqueued_at, now - item.enqueued_at)
                raise errors.DeadlineExpired(
                    "deadline expired while the request was in flight"
                ) from None
            if tr is not None:
                tr.add_span(
                    "queue_wait", item.enqueued_at,
                    now - item.enqueued_at, timeout=True,
                )
            raise errors.RequestTimeout(
                f"no result within {self._timeout_s:.0f}s (device saturated?)"
            ) from None

    def _count_deadline(self, tr, start_pc: float, waited_s: float) -> None:
        """Shared accounting for every deadline-expiry path: the counter
        the exposition lint pins plus the span attr the runbook names."""
        if self._metrics is not None:
            self._metrics.inc_counter("deadline_expired_total")
        if tr is not None:
            tr.add_span(
                "queue_wait", start_pc, waited_s, deadline_expired=True
            )

    def _reap_expired(self, batch: list[WorkItem]) -> list[WorkItem]:
        """Drop items nobody can receive results for: expired deadlines
        (immediate 504) and already-done futures — the submit side timed
        out, or the caller CANCELLED, e.g. a cancelled job's
        in-flight octave.  Either way the device NEVER sees dead work.
        Called at the queue-pop boundary (collect) and again
        pre-dispatch — a deadline can lapse (and a cancel can land)
        while a batch sits in the handoff queue."""
        now = time.perf_counter()
        live: list[WorkItem] = []
        for it in batch:
            if it.future.done():
                # a done future means the submit side already timed out
                # (wait_for cancels it) and COUNTED any expiry, or the
                # caller cancelled — drop the item without
                # double-counting or double-spanning; its result is
                # undeliverable, so dispatching it would only burn
                # device time
                continue
            if it.deadline is not None and now >= it.deadline:
                self._count_deadline(
                    it.trace, it.enqueued_at, now - it.enqueued_at
                )
                it.future.set_exception(
                    errors.DeadlineExpired(
                        "deadline expired while queued; request reaped "
                        "before dispatch"
                    )
                )
            else:
                live.append(it)
        return live

    def _drain_nowait(self, batch: list[WorkItem]) -> None:
        """Move everything already queued into ``batch`` (up to max_batch)
        without touching the event loop.  The old per-item
        ``wait_for(get, ...)`` drain paid one loop-scheduling latency PER
        ITEM — under load that collected ~3 items per window while ~50 sat
        in the queue, capping every batch far
        below max_batch."""
        while len(batch) < self._max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except asyncio.QueueEmpty:
                break

    async def _run(self) -> None:
        while True:
            first = await self._queue.get()
            batch = [first]
            try:
                self._drain_nowait(batch)
                if self._dispatch_runner is not None:
                    await self._collect_and_stage(batch)
                else:
                    # serial mode: the straggler window waits per item (the
                    # serial behaviour; depth<=1 is the compatibility
                    # fallback, not the hot path)
                    if len(batch) < self._max_batch and self._window_s > 0:
                        window_end = time.perf_counter() + self._window_s
                        while len(batch) < self._max_batch:
                            remaining = window_end - time.perf_counter()
                            if remaining <= 0:
                                break
                            try:
                                batch.append(
                                    await asyncio.wait_for(
                                        self._queue.get(), remaining
                                    )
                                )
                            except asyncio.TimeoutError:
                                break
                            self._drain_nowait(batch)
                    batch = self._reap_expired(batch)
                    if batch:
                        await self._execute(batch)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # collect-iteration crash: these items left the submit
                # queue, so nothing downstream can fail them — do it NOW
                # or they hang to a full request-timeout 504, then let
                # the supervisor restart the loop
                exc = (
                    e
                    if isinstance(e, errors.DeconvError)
                    else errors.Unavailable(
                        f"batcher collect task crashed: {type(e).__name__}: {e}"
                    )
                )
                for it in batch:
                    if not it.future.done():
                        it.future.set_exception(exc)
                raise

    async def _collect_and_stage(self, batch: list[WorkItem]) -> None:
        """Pipelined collect: adaptive straggler window + bounded handoff.

        The window is WORK-CONSERVING: when the pipeline is idle the batch
        dispatches immediately (waiting would leave the device idle for
        nothing); when batches are in flight, one sleep() lets stragglers
        accumulate — a single loop hop for the whole window, where the old
        per-item ``wait_for`` drain paid a scheduling latency per item.
        If the device falls further behind, the bounded put blocks the
        collect loop and the next greedy drain picks up everything that
        arrived meanwhile — batch size tracks load automatically."""
        busy = self._inflight > 0 or not self._dispatch_q.empty()
        if (
            busy
            and len(batch) < max(1, self._max_batch // 2)
            and self._window_s > 0
        ):
            # under-filled batch while the device works: one window's
            # sleep lets stragglers accumulate.  A batch already at half
            # of max_batch has amortised the fixed per-dispatch cost —
            # waiting longer would only add latency.
            await asyncio.sleep(self._window_s)
            self._drain_nowait(batch)
        # queue-pop reap boundary: items whose deadline lapsed
        # while queued 504 NOW instead of riding a doomed dispatch
        batch[:] = self._reap_expired(batch)
        if self._metrics is not None:
            self._metrics.set_gauge("collect_queue_depth", self._queue.qsize())
        if not batch:
            return
        self._staged += len(batch)
        try:
            await self._dispatch_q.put(batch)
        except asyncio.CancelledError:
            # stop() interrupts the handoff: these items left the submit
            # queue, so the stop() drain cannot fail them
            self._staged -= len(batch)
            for item in batch:
                if not item.future.done():
                    item.future.set_exception(
                        errors.Unavailable("server shutting down")
                    )
            raise
        if self._metrics is not None:
            self._metrics.set_gauge(
                "dispatch_queue_depth", self._dispatch_q.qsize()
            )

    async def _dispatch_stage(self) -> None:
        """Stage 2: pull collected batches off the handoff queue and
        dispatch them (in collection order — one stage task, so device
        dispatch order is preserved) while the collect loop keeps
        draining."""
        while True:
            batch = await self._dispatch_q.get()
            self._staged -= len(batch)
            # pre-dispatch reap boundary: a deadline can lapse while the
            # batch waits in the handoff queue behind a slow device
            batch = self._reap_expired(batch)
            if not batch:
                continue
            try:
                faults.raise_if_armed("batcher.dispatch_raise")
                groups: dict[Any, list[WorkItem]] = {}
                for item in batch:
                    groups.setdefault(item.key, []).append(item)
                await self._execute_pipelined(groups)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # dispatch-task crash: fail the in-flight group's futures
                # immediately (they are out of every queue — nobody else
                # can), then re-raise so the supervisor restarts the task
                exc = (
                    e
                    if isinstance(e, errors.DeconvError)
                    else errors.Unavailable(
                        f"batcher dispatch task crashed: {type(e).__name__}: {e}"
                    )
                )
                for item in batch:
                    if not item.future.done():
                        item.future.set_exception(exc)
                raise

    def _call_runner(self, key, images, lane: ExecutorLane):
        """Serial-mode runner invocation, lane keyword only for runners
        that take it (legacy 2-arg runners ride lane 0 unchanged).
        Lane-awareness is probed per call, not cached: tests and
        embedders swap the runner attributes at runtime, and the probe
        is microseconds against a batch's milliseconds."""
        fn = self._runner
        if _accepts_lane(fn):
            return fn(key, images, lane=lane.index)
        return fn(key, images)

    def _call_dispatch(self, key, images, lane: ExecutorLane):
        """Pipelined dispatch invocation; runs on the lane's dispatch
        worker thread.  Same per-call lane probe as _call_runner."""
        fn = self._dispatch_runner
        if _accepts_lane(fn):
            return fn(key, images, lane=lane.index)
        return fn(key, images)

    def _fail_group(self, items: list[WorkItem], exc: BaseException) -> None:
        for it in items:
            if not it.future.done():
                it.future.set_exception(exc)

    async def _execute(self, batch: list[WorkItem]) -> None:
        groups: dict[Any, list[WorkItem]] = {}
        for item in batch:
            groups.setdefault(item.key, []).append(item)
        if self._dispatch_runner is not None:
            await self._execute_pipelined(groups)
            return
        # Serial fallback: dispatch -> block for results -> resolve, one
        # group at a time.  Device execution is serial regardless; what the
        # pipelined mode adds is overlapping the HOST side (result
        # transfer + postprocess) of group A with the device side of
        # group B.  Mixed-key bursts complete without starvation
        # (tests/test_serving.py::test_mixed_layer_burst).
        self._inflight = len(groups)
        pending_groups = list(groups.values())
        try:
            for key, items in groups.items():
                images = [it.image for it in items]
                lane, retry_s = self._pool.pick()
                if lane is None:
                    # the pool's breakers all opened while this batch
                    # sat collected: fail the group fast, like submit()
                    # would have
                    self._inflight -= 1
                    pending_groups = pending_groups[1:]
                    self._fail_group(
                        items,
                        errors.BreakerOpen(
                            "device circuit breaker is open on every lane; "
                            "failing fast",
                            retry_after_s=retry_s,
                        ),
                    )
                    continue
                self._pool.record_dispatched(lane)
                t0 = time.perf_counter()
                try:
                    results = await _to_daemon_thread(
                        lambda key=key, images=images, lane=lane: (
                            self._call_runner(key, images, lane)
                        )
                    )
                except asyncio.CancelledError:
                    # stop() cancelled the dispatcher mid-batch: these items
                    # are already out of the queue, so the stop() drain loop
                    # cannot fail them — do it here or they 504
                    self._pool.record_cancelled(lane)
                    for grp in pending_groups:
                        for it in grp:
                            if not it.future.done():
                                it.future.set_exception(
                                    errors.Unavailable("server shutting down")
                                )
                    raise
                except Exception as e:  # noqa: BLE001 — propagate to callers
                    self._pool.record_done(
                        lane, False, time.perf_counter() - t0, len(items)
                    )
                    self._fail_group(items, e)
                    continue
                finally:
                    self._inflight -= 1
                    pending_groups = pending_groups[1:]
                self._pool.record_done(
                    lane, True, time.perf_counter() - t0, len(items)
                )
                self._resolve(items, results, t0, lane=lane)
        finally:
            self._inflight = 0  # cancellation mid-drain must not leak count

    async def _execute_pipelined(self, groups: dict[Any, list[WorkItem]]) -> None:
        """Dispatch every group, farming each group's result-fetch out to
        its own task; returns as soon as all groups are DISPATCHED so the
        _run loop can collect the next window while results stream back.
        The fetch semaphore bounds dispatched-but-unfetched groups.

        On cancellation (server shutdown) every group that has not handed
        its thunk to a fetch task FAILS its futures immediately — including
        the group whose dispatch the cancellation interrupted, whose device
        results are unreachable (the cancelled await discards the worker
        thread's eventual result).  Letting them hang to a full
        request-timeout 504 would stall graceful shutdown."""
        self._inflight += len(groups)
        handed_off = 0
        group_list = list(groups.items())
        try:
            for key, items in group_list:
                images = [it.image for it in items]
                # Least-loaded lane selection: each group goes
                # to the lane with the smallest pending-seconds estimate
                # whose breaker admits it.  With one lane this degenerates
                # to the pre-lane single stream.
                lane, retry_s = self._pool.pick()
                if lane is None:
                    self._inflight -= 1
                    handed_off += 1
                    self._fail_group(
                        items,
                        errors.BreakerOpen(
                            "device circuit breaker is open on every lane; "
                            "failing fast",
                            retry_after_s=retry_s,
                        ),
                    )
                    continue
                # the LANE's fetch permit: a deep pipeline on one chip
                # blocks only further dispatches to that chip
                sem = self._fetch_sems[lane.index]
                await sem.acquire()
                self._pool.record_dispatched(lane)
                t0 = time.perf_counter()
                try:
                    thunk = await self._dispatch_workers[lane.index].run(
                        self._call_dispatch, key, images, lane
                    )
                except asyncio.CancelledError:
                    sem.release()  # held permit must not leak
                    self._pool.record_cancelled(lane)
                    raise
                except Exception as e:  # noqa: BLE001 — propagate to callers
                    sem.release()
                    self._inflight -= 1
                    handed_off += 1
                    self._pool.record_done(
                        lane, False, time.perf_counter() - t0, len(items)
                    )
                    self._fail_group(items, e)
                    continue
                handed_off += 1
                task = asyncio.create_task(
                    self._finish(items, thunk, t0, time.perf_counter(), lane),
                    name="batch-fetch",
                )
                self._fetch_tasks.add(task)
                task.add_done_callback(self._fetch_tasks.discard)
        except asyncio.CancelledError:
            for _, items in group_list[handed_off:]:
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(
                            errors.Unavailable("server shutting down")
                        )
            raise
        finally:
            # groups never handed to a fetch task (failed, cancelled, or
            # unreached) must not leak the inflight count
            self._inflight -= len(group_list) - handed_off

    async def _finish(
        self,
        items: list[WorkItem],
        thunk,
        t0: float,
        dispatched_at: float | None = None,
        lane: ExecutorLane | None = None,
    ) -> None:
        try:
            results = await _to_daemon_thread(thunk)
        except asyncio.CancelledError:
            # stop()'s bounded grace cancels wedged fetches; their results
            # are unreachable (to_thread discards the worker's return on
            # cancel) so the futures must fail NOW, not 504 later
            if lane is not None:
                self._pool.record_cancelled(lane)
            for it in items:
                if not it.future.done():
                    it.future.set_exception(
                        errors.Unavailable("server shutting down")
                    )
            raise
        except Exception as e:  # noqa: BLE001 — propagate to callers
            if lane is not None:
                self._pool.record_done(
                    lane, False, time.perf_counter() - t0, len(items)
                )
            self._fail_group(items, e)
            return
        finally:
            self._inflight -= 1
            if lane is not None:
                self._fetch_sems[lane.index].release()
        if lane is not None:
            self._pool.record_done(
                lane, True, time.perf_counter() - t0, len(items)
            )
        self._resolve(
            items, results, t0, dispatched_at, lane,
            # weight page-in attribution: a cold-model
            # dispatch tags its materialise thunk with the transfer
            # wall so every member request's trace shows WHY this
            # batch's dispatch span is fat
            page_in_s=getattr(thunk, "page_in_s", None),
            page_model=getattr(thunk, "page_model", None),
        )

    def _resolve(
        self,
        items: list[WorkItem],
        results: list[Any],
        t0: float,
        dispatched_at: float | None = None,
        lane: ExecutorLane | None = None,
        page_in_s: float | None = None,
        page_model: str | None = None,
    ) -> None:
        """Shared epilogue for both execution modes: metrics + futures.
        Cadence (interval between completions while more work is in
        flight) feeds the load-shed estimator's sustained-rate input.
        Each member request's trace gets its queue-wait and
        dispatch/fetch spans here, stamped with the batch id that
        observe_batch just recorded — the join key between a single
        request's timeline and the batch-level metrics.  The
        spans and the batch_done line carry the executing LANE, so a
        slow trace says which chip ran it."""
        now = time.perf_counter()
        lane_ix = lane.index if lane is not None else 0
        self.batch_sizes.append(len(items))
        if self._qos is not None:
            # device-time accounting: each member request is charged its
            # share of the executed batch's wall, the measured cost the
            # admission buckets debit
            per_s = (now - t0) / max(1, len(items))
            for it in items:
                self._qos.charge(it.tenant, per_s)
        slog.event(
            _log, "batch_done", level=10,  # DEBUG: per-request http_request
            # lines already cover the serving story at INFO
            key=str(items[0].key), size=len(items), lane=lane_ix,
            ms=round((now - t0) * 1e3, 1), inflight=self._inflight,
        )
        bid = None
        if self._metrics is not None:
            bid = self._metrics.observe_batch(
                size=len(items),
                compute_s=now - t0,
                queue_s=t0 - min(it.enqueued_at for it in items),
            )
            self._metrics.set_gauge("inflight_batches", self._inflight)
            # Cadence is only meaningful between completions under
            # SUSTAINED load; going idle clears the anchor, else the next
            # burst's first completion would record the whole idle gap as
            # an interval and inflate the shed estimator into spurious
            # 503s.
            busy = self._inflight > 0 or self._queue.qsize() > 0
            if busy:
                if self._last_done is not None:
                    self._metrics.observe_cadence(now - self._last_done)
                self._last_done = now
            else:
                self._last_done = None
        for it in items:
            if it.trace is not None:
                it.trace.annotate(batch_id=bid, batch_size=len(items), lane=lane_ix)
                it.trace.add_span("queue_wait", it.enqueued_at, t0 - it.enqueued_at)
                if page_in_s:
                    # the cold-model transfer this batch waited on
                    #: starts at dispatch, rides inside the
                    # dispatch wall the QoS meter charges
                    it.trace.add_span(
                        "weight_page_in", t0, page_in_s,
                        model=page_model, lane=lane_ix,
                    )
                if dispatched_at is not None:
                    it.trace.add_span(
                        "dispatch", t0, dispatched_at - t0, batch_id=bid,
                        lane=lane_ix,
                    )
                    it.trace.add_span(
                        "fetch", dispatched_at, now - dispatched_at,
                        batch_id=bid, lane=lane_ix,
                    )
                else:
                    it.trace.add_span(
                        "device", t0, now - t0, batch_id=bid, lane=lane_ix
                    )
        for it, res in zip(items, results):
            if not it.future.done():
                it.future.set_result(res)
