"""Bounded codec worker pool + reusable host staging buffers (a copy of
``deconv_api_tpu/serving/codec_pool.py``, its ``HostBufferRing`` holding
torch tensors).

- ``WorkerPool``: a small pool of PERSISTENT daemon worker threads with a
  bounded pending-job count.  Routes hand JPEG decode and encode jobs to
  it instead of ``asyncio.to_thread`` — no per-call thread spawn, no
  unbounded default-executor queue, and the pending bound gives the
  three-stage pipeline its backpressure.  Dead workers are respawned
  within a sliding-window budget.  The batcher's dispatch worker of a
  lane is a one-thread pool of its own (``name="dispatch"``).

- ``HostBufferRing``: reusable host staging buffers for device batches.
  The dispatch step assembles every padded batch into a ring buffer and
  copies each batch's outputs into ring buffers; a buffer rejoins the
  ring only after the batch's device work is complete.  With
  ``pin_memory`` (the card) each buffer is page-locked, so the copies to
  and from the card run asynchronously on the replay's stream.  Pinned
  memory is allocated by ``cudaHostAlloc``, which a CUDA graph capture on
  another thread does not tolerate: acquire only while no capture can
  run (holding ``engine/capture.py:DEVICE_LOCK`` shared).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from deconv_api_tpu_torch.serving import faults
from deconv_api_tpu_torch.serving import trace as trace_mod
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.codec_pool")


class PoolClosed(RuntimeError):
    """Job submitted to a closed WorkerPool."""


def _default_workers() -> int:
    return max(2, min(8, (os.cpu_count() or 4) // 2))


class WorkerPool:
    """Persistent daemon-thread pool with bounded pending jobs.

    ``run(fn, *args)`` awaits the job's result; at most ``max_pending``
    jobs may be queued-or-running — excess ``run()`` callers wait on the
    bound (backpressure), which is exactly the signal the serving
    pipeline wants to propagate back to the HTTP layer.  Jobs are
    processed FIFO; ``map`` preserves input order in its results.
    """

    def __init__(
        self,
        workers: int = 0,
        *,
        max_pending: int = 0,
        name: str = "codec",
        metrics=None,
        respawn_budget: int = 0,
        respawn_window_s: float = 60.0,
    ):
        self.workers = workers if workers > 0 else _default_workers()
        self.max_pending = max_pending if max_pending > 0 else self.workers * 32
        self._name = name
        self._metrics = metrics
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._sem: asyncio.Semaphore | None = None
        self._depth = 0  # queued-or-running jobs (the queue-depth gauge)
        self._closed = False
        self._close_lock = threading.Lock()
        # Self-healing: a worker that dies from an unexpected
        # exception is logged, its in-flight task's future failed (never
        # a hung caller), and a replacement spawned — up to
        # respawn_budget respawns per sliding respawn_window_s, so a
        # DETERMINISTIC crash (every job kills its worker) degrades to
        # loud fail-fast instead of infinite respawn churn.  0 = auto;
        # generous, because a respawn is just a thread spawn: sustained
        # probabilistic chaos (the p=0.05 drill) must not exhaust it.
        self._respawn_budget = (
            respawn_budget if respawn_budget > 0 else max(64, self.workers * 32)
        )
        self._respawn_window_s = respawn_window_s
        self._respawns: collections.deque[float] = collections.deque()
        self._spawn_seq = 0
        self._threads: list[threading.Thread] = []
        for _ in range(self.workers):
            self._threads.append(self._make_thread())
        for t in self._threads:
            t.start()
        self._publish_live()

    # ------------------------------------------------------------ internals

    def _make_thread(self) -> threading.Thread:
        self._spawn_seq += 1
        return threading.Thread(
            target=self._work, daemon=True,
            name=f"{self._name}-worker-{self._spawn_seq}",
        )

    def _work(self) -> None:
        # the in-flight job's (loop, fut), visible to the death handler:
        # a worker that dies MID-TASK must fail that task's future, not
        # leave its caller hanging
        current: list = [None]
        try:
            while True:
                job = self._jobs.get()
                if job is None:
                    return
                fn, args, loop, fut = job
                current[0] = (loop, fut)
                act = faults.check(f"{self._name}.worker_hang")
                if act is not None:
                    time.sleep((act.param or 1000.0) / 1e3)
                act = faults.check(f"{self._name}.worker_raise")
                if act is not None:
                    from deconv_api_tpu_torch import errors

                    raise errors.FaultInjected(
                        f"injected fault at {self._name}.worker_raise"
                    )
                try:
                    result = fn(*args)
                except BaseException as e:  # noqa: BLE001 — relayed to the future
                    if loop is None:  # concurrent.futures (map_sync) job
                        fut.set_exception(e)
                    else:
                        self._post(loop, fut, fut.set_exception, e)
                else:
                    if loop is None:
                        fut.set_result(result)
                    else:
                        self._post(loop, fut, fut.set_result, result)
                current[0] = None
        except BaseException as e:  # noqa: BLE001 — unexpected worker death
            self._on_worker_death(e, current[0])

    def _on_worker_death(self, exc: BaseException, inflight) -> None:
        """A worker thread died outside the job-relay protocol: fail the
        in-flight task's future (only that one), account the death, and
        respawn within the rate-limited budget."""
        me = threading.current_thread()
        with self._close_lock:
            if me in self._threads:
                self._threads.remove(me)
            closed = self._closed
        if inflight is not None:
            loop, fut = inflight
            if loop is None:
                if not fut.done():
                    fut.set_exception(exc)
            else:
                self._post(loop, fut, fut.set_exception, exc)
        slog.event(
            _log, "worker_death", level=logging.WARNING,
            pool=self._name, error=f"{type(exc).__name__}: {exc}",
            live=self.live_workers,
        )
        if self._metrics is not None:
            self._metrics.inc_labeled("worker_deaths_total", "pool", self._name)
        self._publish_live()
        if not closed:
            self._maybe_respawn(from_death=True)
            self._fail_orphaned_jobs()

    def _fail_orphaned_jobs(self) -> None:
        """The last worker died and the respawn budget is spent: jobs
        already queued would wait forever on a queue nobody drains —
        fail them NOW (their callers see 503 unavailable, not a hang).
        A job enqueued concurrently is safe either way: it is failed
        here, or a still-live/respawned worker runs it."""
        from deconv_api_tpu_torch import errors

        with self._close_lock:
            if self._threads or self._closed:
                return
        exc = errors.Unavailable(
            f"worker pool {self._name!r} has no live workers "
            "(respawn budget exhausted); job abandoned"
        )
        sentinels = 0
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                break
            if job is None:  # close sentinel (close raced us): preserve
                sentinels += 1
                continue
            _fn, _args, loop, fut = job
            if loop is None:
                if not fut.done():
                    fut.set_exception(exc)
            else:
                self._post(loop, fut, fut.set_exception, exc)
        for _ in range(sentinels):
            self._jobs.put(None)

    def _maybe_respawn(self, from_death: bool = False) -> None:
        """Top the pool back up to ``workers`` live threads, spending the
        sliding-window respawn budget.  Called on worker death AND on job
        submission, so capacity lost while the budget was exhausted
        (e.g. during a chaos storm) self-restores once the window
        slides — the pool heals without an operator bounce."""
        now = time.monotonic()
        spawned: list[threading.Thread] = []
        with self._close_lock:
            if self._closed:
                return
            while (
                self._respawns
                and now - self._respawns[0] > self._respawn_window_s
            ):
                self._respawns.popleft()
            deficit = self.workers - len(self._threads)
            while deficit > 0 and len(self._respawns) < self._respawn_budget:
                t = self._make_thread()
                self._threads.append(t)
                self._respawns.append(now)
                spawned.append(t)
                deficit -= 1
        for t in spawned:
            t.start()
        if spawned:
            slog.event(
                _log, "worker_respawn", pool=self._name,
                n=len(spawned), live=self.live_workers,
            )
            self._publish_live()
        elif deficit > 0 and from_death:
            slog.event(
                _log, "worker_respawn_budget_exhausted", level=logging.ERROR,
                pool=self._name, live=self.live_workers,
                budget=self._respawn_budget, window_s=self._respawn_window_s,
            )

    @staticmethod
    def _post(loop, fut, setter, value) -> None:
        def resolve():
            if not fut.done():  # cancelled or already resolved
                setter(value)

        try:
            loop.call_soon_threadsafe(resolve)
        except RuntimeError:  # loop already closed (teardown races)
            pass

    def _publish_live(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge(
                f"{self._name}_workers_live", self.live_workers
            )

    def _gauge(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge(f"{self._name}_queue_depth", self._depth)

    # ------------------------------------------------------------- surface

    @property
    def live_workers(self) -> int:
        """Live worker threads — the `{name}_workers_live` gauge and the
        /readyz quorum input."""
        with self._close_lock:
            return len(self._threads)

    @property
    def at_quorum(self) -> bool:
        """More than half the configured workers are live: the pool still
        has real capacity.  /readyz flips unready below this."""
        return self.live_workers > self.workers // 2

    async def run(self, fn: Callable[..., Any], *args: Any) -> Any:
        """Run ``fn(*args)`` on a pool worker; awaits (and bounds) the job."""
        if self._closed:
            raise PoolClosed(f"worker pool {self._name!r} is closed")
        if len(self._threads) < self.workers:
            # lost capacity heals lazily on submission once the respawn
            # window slides (the len check is the cheap fast path)
            self._maybe_respawn()
            if not self._threads:
                # zero live workers and no budget to respawn: a queued
                # job would never run and this caller would hang forever
                from deconv_api_tpu_torch import errors

                raise errors.Unavailable(
                    f"worker pool {self._name!r} has no live workers "
                    "(respawn budget exhausted)"
                )
        if self._sem is None:
            # created lazily so the pool can be constructed off-loop
            self._sem = asyncio.Semaphore(self.max_pending)
        # Surface the pool HANDOFF latency
        # (semaphore wait + queue time + worker wakeup) as its own span,
        # so a fat decode span decomposes into "waiting for a codec
        # worker" vs actual codec work.  The wrapper runs ON the worker
        # and closes over the trace object (worker threads have no
        # request context); RequestTrace is lock-protected for exactly
        # this writer.
        tr = trace_mod.current_trace()
        if tr is not None:
            t_submit = time.perf_counter()
            inner = fn
            pool_name = self._name

            def fn(*a):  # noqa: F811 — deliberate timed wrapper
                tr.add_span(
                    f"{pool_name}_handoff", t_submit,
                    time.perf_counter() - t_submit,
                )
                return inner(*a)

        await self._sem.acquire()
        self._depth += 1
        self._gauge()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        with self._close_lock:
            if self._closed:  # close() raced the await above
                self._depth -= 1
                self._gauge()
                self._sem.release()
                raise PoolClosed(f"worker pool {self._name!r} is closed")
            if not self._threads:
                # the last worker died while we awaited the semaphore
                # and the orphan drain already ran: enqueueing now would
                # hang this caller forever.  In-lock, so it cannot race
                # _on_worker_death's thread removal + drain.
                self._depth -= 1
                self._gauge()
                self._sem.release()
                from deconv_api_tpu_torch import errors

                raise errors.Unavailable(
                    f"worker pool {self._name!r} has no live workers "
                    "(respawn budget exhausted)"
                )
            self._jobs.put((fn, args, loop, fut))
        try:
            return await fut
        finally:
            self._depth -= 1
            self._gauge()
            self._sem.release()

    async def map(self, fn: Callable[[Any], Any], items: Iterable[Any]) -> list:
        """Run ``fn`` over ``items`` concurrently; results in input order."""
        return await asyncio.gather(*(self.run(fn, item) for item in items))

    def map_sync(self, fn: Callable[[Any], Any], items: list) -> list:
        """Thread-caller form of ``map``: fan ``fn`` over ``items`` across
        the pool and BLOCK for the ordered results.  Used by the batch
        fetch thread to parallelise a batch's per-request JPEG encodes
        without an event-loop round trip.  Bypasses the async pending
        bound (the caller is itself a bounded pipeline stage); falls back
        to inline execution once the pool is closed."""
        import concurrent.futures

        if len(self._threads) < self.workers:
            self._maybe_respawn()
        futs = []
        # under the close lock: a close() racing this enqueue could
        # otherwise land jobs BEHIND the shutdown sentinels, where no
        # worker would ever run them and f.result() would block forever
        with self._close_lock:
            if self._closed or not items or not self._threads:
                # closed OR zero live workers (post-storm, budget spent):
                # inline execution beats enqueueing jobs nobody will run
                return [fn(item) for item in items]
            for item in items:
                f: concurrent.futures.Future = concurrent.futures.Future()
                self._jobs.put((fn, (item,), None, f))
                futs.append(f)
        return [f.result() for f in futs]

    def map_sync_settle(self, fn: Callable[[Any], Any], items: list) -> list:
        """``map_sync`` that SETTLES: per-item failures come back as the
        exception object in that item's slot instead of aborting the
        whole fan-out.  The batch fetch thread uses this for the fused
        grid encodes: one crashed/raising codec worker must
        cost ONE request a retry, not fail the entire batch it rode."""
        import concurrent.futures

        if len(self._threads) < self.workers:
            self._maybe_respawn()

        def inline(item):
            try:
                return fn(item)
            except Exception as e:  # noqa: BLE001 — settled per item
                return e

        futs: list[concurrent.futures.Future] = []
        with self._close_lock:
            if self._closed or not items or not self._threads:
                return [inline(item) for item in items]
            for item in items:
                f: concurrent.futures.Future = concurrent.futures.Future()
                self._jobs.put((fn, (item,), None, f))
                futs.append(f)
        out: list = []
        for f in futs:
            try:
                out.append(f.result())
            except Exception as e:  # noqa: BLE001 — settled per item
                out.append(e)
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop accepting jobs and let the workers drain out.  Idempotent;
        jobs already queued still complete (daemon threads never block
        interpreter exit regardless).  Serialised with map_sync's enqueue
        (the close lock) so no job can land behind a shutdown sentinel."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._threads:
                self._jobs.put(None)


class HostBufferRing:
    """Reusable host staging buffers (torch tensors).

    ``acquire(shape, dtype)`` hands out a free buffer (allocating when
    none is free — never blocks, so a leak on an error path costs one
    allocation, not a deadlock); ``release`` returns it, retaining at
    most ``depth`` buffers per (shape, dtype) so steady-state serving
    cycles through stable storage.  With depth >= 2 the dispatcher
    assembles batch N+1 into a different buffer than in-flight batch N.
    The dispatcher releases a buffer only after the batch's device work
    is complete, so a slot is never refilled while a copy may still read
    or write it."""

    def __init__(self, depth: int = 3, *, pin_memory: bool = False):
        self.depth = max(1, depth)
        self.pin_memory = pin_memory
        self._lock = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}
        self.allocations = 0  # buffers made, not handed back from the ring

    @staticmethod
    def _key(shape, dtype) -> tuple:
        return (tuple(int(s) for s in shape), dtype)

    def acquire(self, shape, dtype=torch.float32) -> torch.Tensor:
        key = self._key(shape, dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
            self.allocations += 1
        return torch.empty(key[0], dtype=dtype, pin_memory=self.pin_memory)

    def release(self, buf: torch.Tensor) -> None:
        """Hand ``buf`` back.  A pinned buffer is always kept: freeing one
        records CUDA events, which a capture on another thread does not
        tolerate, so the ring holds at most what was in flight at once
        until ``clear``."""
        key = self._key(buf.shape, buf.dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.depth or self.pin_memory:
                free.append(buf)

    def clear(self) -> None:
        """Drop every free buffer (on the card: while no capture can run)."""
        with self._lock:
            self._free.clear()

    def assemble(self, images: list, bucket: int) -> torch.Tensor:
        """Stack ``images`` into an acquired ``(bucket, *image.shape)``
        float32 buffer, padding the tail with the last image (the
        dispatcher's bucket-padding rule, ``batcher.pad_to_bucket``).
        Release it once the batch's device work has completed."""
        if not 1 <= len(images) <= bucket:
            raise ValueError(f"{len(images)} images do not fit a bucket of {bucket}")
        first = np.asarray(images[0])
        buf = self.acquire((bucket,) + first.shape, torch.float32)
        host = buf.numpy()
        for i, img in enumerate(images):
            host[i] = img
        if bucket > len(images):
            host[len(images):] = np.asarray(images[-1])
        return buf
