"""Content-addressed response cache + singleflight request coalescing (a
copy of ``deconv_api_tpu/serving/cache.py``: the same keys, counters and
L2 file format, so either package reads the other's L2 entries).

Every deconv/dream/sweep response is a PURE FUNCTION of (model, route,
canonical request params, raw image bytes) and of the server settings
that decide its bytes.  Skewed traffic (demo images, default layers,
dashboards re-polling one request) repeats work that this module makes
free.  Four pieces live here:

- ``canonical_digest``: the cache key.  Computed from the RAW body bytes
  before any image decode, prefixed with the response-determining server
  config (model, image size, dtypes, weights, device) so a config change
  can never serve a stale payload.  Parseable form bodies (urlencoded /
  multipart / JSON) are canonicalized to sorted (field, value) pairs
  first — field order, multipart boundaries, and urlencoded-vs-multipart
  encoding of the SAME logical request all hash identically, which is
  exactly what handlers see after ``req.form()``.  Unparseable bodies
  hash raw: identical bytes still coalesce, and the handler 400s them
  deterministically (→ negative cache).

- ``ResponseCache``: a SHARDED, byte-budgeted LRU over final encoded
  payloads.  A hit returns the stored (status, body, content-type)
  without touching codec pool, batcher, or device.  Sharding (per-shard
  ``OrderedDict`` + lock) keeps eviction-under-load from serializing
  concurrent hits; the byte budget is split evenly across shards, and an
  entry larger than one shard's budget is simply not stored (one giant
  sweep response must not evict the whole hot set).  Deterministic 4xxs
  (unknown layer, bad knobs, undecodable image) are NEGATIVE-cached
  under a short TTL so abusive retry loops stop costing form parses of
  the downstream machinery — 5xxs (shed, timeout, crash) are transient
  by definition and never cached.

- ``L2Store``: a DURABLE disk tier behind the in-memory LRU, on
  ``serving/durable.py``'s digest-verified tmp-then-rename storage.
  Positive entries are written through asynchronously under a byte
  budget with an LRU sweep and looked up on a memory miss BEFORE
  compute; a digest mismatch or a corrupt/truncated file reads as a
  miss, never an error — so a restarted server recovers its hitset from
  disk instead of recomputing it from zero.

- ``Singleflight``: a flight table coalescing concurrent identical
  misses onto ONE in-flight future.  N identical requests in flight →
  exactly one decode / device dispatch / encode; the leader publishes
  its finished Response to every waiter on completion (the
  "miss-completion publish").  Leaders that die exceptionally publish
  the exception instead, so waiters can map it through the normal error
  taxonomy rather than hanging.

Concurrency: route handlers (and therefore flight begin/finish) run on
the service's single event loop, but the cache itself is also read and
written from worker contexts in tests and tools, so every shard is
lock-protected and counters go through the (already lock-protected)
Metrics registry.  Time is injected (``clock``) so TTL tests never
sleep.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import queue
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import durable
from deconv_api_tpu_torch.serving import trace as trace_mod
from deconv_api_tpu_torch.serving.http import Request, Response
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.cache")

# Rough per-entry bookkeeping charged against the byte budget on top of
# the payload: key string, OrderedDict slot, dataclass fields.  Keeps a
# budget of N bytes meaning ~N resident bytes even for tiny negative
# entries.
ENTRY_OVERHEAD = 256


def canonical_digest(
    prefix: str,
    content_type: str,
    body: bytes,
    req: Request | None = None,
    exclude: tuple[str, ...] = (),
) -> str:
    """Digest of the canonicalized request — the cache/singleflight key.

    ``prefix`` carries everything response-determining that is NOT in the
    body (route + server config epoch, built once by the service);
    ``body`` is hashed in canonical form (see module docstring).  The
    decode-with-replacement in form parsing is key-safe: handlers consume
    the SAME decoded fields, so bodies that canonicalize identically
    produce identical responses by construction.

    Pass the live ``req`` when there is one: ``Request.form()`` memoizes,
    so the parse done here is the SAME parse the route handler consumes
    on a miss — one form parse per request, not two.

    ``exclude`` drops named fields from the canonical form (the
    ``model`` field — its RESOLVED value already rides the prefix, so
    ``model=vgg16`` explicit, ``x-model: vgg16``, and a bare default
    request all hash to ONE key instead of fragmenting the hot set
    three ways; ``quality`` gets the same treatment, as in the JAX
    package, whose resolved tier rides its prefix).  Only applies
    to parseable bodies; raw-bytes fallbacks hash everything (they 400
    deterministically anyway).
    """
    h = hashlib.blake2b(digest_size=20)
    h.update(prefix.encode())
    h.update(b"\x00")
    try:
        fields = (
            req
            if req is not None
            else Request("POST", "/", {}, {"content-type": content_type}, body)
        ).form()
    except Exception:  # noqa: BLE001 — unparseable: raw-bytes fallback
        h.update(content_type.encode("utf-8", "replace"))
        h.update(b"\x00")
        h.update(body)
    else:
        # Length-prefixed chunks, not separators: a separator byte INSIDE
        # a field name/value would let a crafted single-field body hash
        # identically to a different multi-field one — a cache-poisoning
        # primitive.  len:bytes framing is injective.
        for k in sorted(fields):
            if k in exclude:
                continue
            for chunk in (k.encode("utf-8", "replace"),
                          fields[k].encode("utf-8", "replace")):
                h.update(str(len(chunk)).encode())
                h.update(b":")
                h.update(chunk)
    return h.hexdigest()


@dataclass
class CacheEntry:
    status: int
    body: bytes
    content_type: str
    expires_at: float | None  # None = until evicted
    negative: bool
    error_code: str | None  # machine code of a negative entry's payload
    size: int  # charged bytes (body + overhead)

    def to_response(self) -> Response:
        """A FRESH Response per hit (headers dicts are per-connection
        mutable); body bytes are shared — they are immutable."""
        return Response(
            status=self.status,
            body=self.body,
            headers={
                "content-type": self.content_type,
                "x-cache": "hit-negative" if self.negative else "hit",
            },
        )


class _Shard:
    """One LRU shard: OrderedDict (insertion→recency order) + lock +
    byte accounting.  Eviction happens inside the insert's critical
    section, so a concurrent-insert storm can never overshoot the budget
    between check and evict."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.lock = threading.Lock()
        self.entries: OrderedDict[str, CacheEntry] = OrderedDict()
        self.bytes = 0

    def get(self, key: str, now: float) -> CacheEntry | str | None:
        """Entry on hit, the string "expired" on TTL lapse, None on miss."""
        with self.lock:
            entry = self.entries.get(key)
            if entry is None:
                return None
            if entry.expires_at is not None and now >= entry.expires_at:
                del self.entries[key]
                self.bytes -= entry.size
                return "expired"
            self.entries.move_to_end(key)
            return entry

    def put(self, key: str, entry: CacheEntry) -> int:
        """Insert/replace; returns how many entries were evicted.
        Precondition (enforced by ResponseCache.store, put's only
        caller): entry.size <= max_bytes — so evicting down to the new
        entry alone always lands within budget."""
        evicted = 0
        with self.lock:
            old = self.entries.pop(key, None)
            if old is not None:
                self.bytes -= old.size
            self.entries[key] = entry
            self.bytes += entry.size
            while self.bytes > self.max_bytes and len(self.entries) > 1:
                _, victim = self.entries.popitem(last=False)
                self.bytes -= victim.size
                evicted += 1
        return evicted


class ResponseCache:
    """Sharded, byte-budgeted LRU over final encoded response payloads.

    ``lookup``/``store`` keep their own hit/miss/eviction counters and
    publish them (plus resident-bytes / entry-count / hit-ratio gauges)
    through the injected Metrics registry, so `/metrics` tells the whole
    story without the caller doing any bookkeeping.
    """

    def __init__(
        self,
        max_bytes: int,
        *,
        ttl_s: float = 0.0,
        negative_ttl_s: float = 2.0,
        shards: int = 8,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.negative_ttl_s = float(negative_ttl_s)
        self._clock = clock
        self._metrics = metrics
        n = max(1, int(shards))
        per_shard = max(1, self.max_bytes // n)
        self._shards = [_Shard(per_shard) for _ in range(n)]
        self._stat_lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------ internals

    def _shard_for(self, key: str) -> _Shard:
        return self._shards[int(key[:8], 16) % len(self._shards)]

    def _count(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc_counter(name, n)

    def _publish_gauges(self) -> None:
        if self._metrics is None:
            return
        self._metrics.set_gauge("cache_resident_bytes", self.resident_bytes)
        self._metrics.set_gauge("cache_entries", self.entry_count)
        with self._stat_lock:
            total = self.hits + self.misses
            ratio = self.hits / total if total else 0.0
        self._metrics.set_gauge("cache_hit_ratio", ratio)

    # ------------------------------------------------------------- surface

    @property
    def resident_bytes(self) -> int:
        return sum(s.bytes for s in self._shards)

    @property
    def entry_count(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    def lookup(self, key: str, charge=None) -> CacheEntry | None:
        """``charge`` (multi-tenant QoS) is invoked on a HIT —
        positive or negative — with no arguments: the admission layer
        refunds the tenant's provisional device debit down to the fixed
        hit cost.  Charging lives at the cache boundary so a hot-key
        tenant cannot launder unlimited traffic through the hit path,
        while tools and tests that read the cache directly stay
        unmetered."""
        got = self._shard_for(key).get(key, self._clock())
        if isinstance(got, CacheEntry):
            with self._stat_lock:
                self.hits += 1
            self._count(
                "cache_negative_hits_total"
                if got.negative
                else "cache_hits_total"
            )
            if charge is not None:
                charge()
            self._publish_gauges()
            return got
        with self._stat_lock:
            self.misses += 1
        if got == "expired":
            self._count("cache_expired_total")
        self._count("cache_misses_total")
        self._publish_gauges()
        return None

    def peek(self, key: str) -> CacheEntry | None:
        """Read an entry WITHOUT counters, LRU promotion, or QoS charge —
        the peer cache-fill surface (``GET
        /v1/internal/cache/{digest}``).  A peer's internal read must not
        inflate this backend's hit ratio or keep an entry hot that its
        OWN traffic no longer touches; expired entries read as absent
        (reaped lazily by the next metered lookup)."""
        shard = self._shard_for(key)
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is None:
                return None
            if (
                entry.expires_at is not None
                and self._clock() >= entry.expires_at
            ):
                return None
            return entry

    def store(self, key: str, status: int, body: bytes, content_type: str) -> bool:
        """Cache a finished response if its status is cacheable: 200 →
        positive (cache_ttl_s; 0 = until evicted), deterministic 4xx →
        negative under the short negative TTL.  5xxs (shed/timeout/crash/
        not-ready) are transient and never stored.  Returns whether the
        entry was stored."""
        if status == 200:
            negative = False
            expires = (
                self._clock() + self.ttl_s if self.ttl_s > 0 else None
            )
            code = None
        elif 400 <= status < 500 and self.negative_ttl_s > 0:
            negative = True
            expires = self._clock() + self.negative_ttl_s
            code = errors.code_from_body(body)
        else:
            return False
        entry = CacheEntry(
            status=status,
            body=body,
            content_type=content_type,
            expires_at=expires,
            negative=negative,
            error_code=code,
            size=len(body) + ENTRY_OVERHEAD,
        )
        shard = self._shard_for(key)
        if entry.size > shard.max_bytes:
            # one oversized payload must not evict the whole hot set
            return False
        evicted = shard.put(key, entry)
        if evicted:
            self._count("cache_evictions_total", evicted)
        self._count("cache_stores_total")
        self._publish_gauges()
        return True


class Singleflight:
    """Coalesce concurrent identical misses onto one in-flight future.

    ``begin(key)`` returns ``(True, future)`` for the flight LEADER (who
    must call ``finish``) and ``(False, future)`` for waiters, who await
    the leader's published Response.  The table is keyed by the same
    canonical digest as the cache, so "identical" means identical down to
    form canonicalization.  Futures belong to the running event loop;
    the lock makes begin/finish safe against tests poking from
    other threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict[str, asyncio.Future] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._flights)

    def begin(self, key: str) -> tuple[bool, asyncio.Future]:
        loop = asyncio.get_running_loop()
        with self._lock:
            fut = self._flights.get(key)
            if fut is not None:
                return False, fut
            fut = loop.create_future()
            # Waiter→leader-flight linkage (tracing spine): the
            # flight carries its own id and the LEADER's request/trace
            # id, so a coalesced waiter's trace can point at the flight
            # that actually computed its bytes — `/v1/debug/requests?id=
            # <leader>` then shows the compute spans the waiter rode.
            tr = trace_mod.current_trace()
            fut.flight_id = f"sf-{key[:12]}"
            fut.leader_trace_id = tr.id if tr is not None else None
            self._flights[key] = fut
            return True, fut

    @staticmethod
    async def wait(fut: asyncio.Future, deadline: float | None = None):
        """Await a flight as a WAITER, honoring the waiter's OWN deadline:
        a coalesced request's caller may give up before the
        flight leader finishes, and its ``x-deadline-ms`` budget must 504
        it independently — the shared flight (and the other waiters)
        live on.  The shield keeps a timed-out or cancelled waiter from
        cancelling the future out from under everyone else."""
        if deadline is None:
            return await asyncio.shield(fut)
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            raise errors.DeadlineExpired(
                "deadline expired before the coalesced flight completed"
            )
        try:
            return await asyncio.wait_for(asyncio.shield(fut), remaining)
        except asyncio.TimeoutError:
            raise errors.DeadlineExpired(
                "deadline expired while waiting on the coalesced flight"
            ) from None

    def finish(self, key: str, result=None, exc: BaseException | None = None) -> None:
        """Miss-completion publish: resolve the flight's future for every
        coalesced waiter (or fail them with the leader's exception) and
        retire the flight.  Idempotent — a double finish is a no-op."""
        with self._lock:
            fut = self._flights.pop(key, None)
        if fut is None or fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
            # mark retrieved: with zero waiters an untouched exception
            # would log "exception was never retrieved" at GC
            fut.exception()
        else:
            fut.set_result(result)


# cache keys are canonical_digest hexdigests — anything else must never
# reach the filesystem layer as a file name
_L2_KEY_RE = re.compile(r"^[0-9a-f]{16,128}$")

class L2Store:
    """Durable disk tier behind the in-memory ``ResponseCache`` (storage
    through ``serving/durable.py``).

    One file per key under ``root``: a ``durable.frame`` artifact — the
    versioned ``{"format": "cache.l2", "version", "len", "digest"}``
    header line carrying status + content type as extras, followed by
    the raw payload bytes.  Every write goes through
    ``durable.atomic_write`` (tmp + fsync + rename + dir fsync — a crash
    leaves either a complete entry or a stale ``.tmp`` the next boot
    sweeps); every read verifies the recorded blake2b digest and length,
    and ANY defect — torn header, short body, digest mismatch — deletes
    the file and reads as a miss, never an error.  A FUTURE-version
    header reads as a miss without deletion (fail-static, best-effort
    side of the durable split); a failed write degrades to a counted
    no-op — ``durable_write_errors_total{surface="cache.l2"}`` counts it
    and ``durable_degraded{surface="cache.l2"}`` flips once per episode.

    Budgeting: ``max_bytes`` bounds resident bytes (0 = unbounded); the
    in-memory index (rebuilt from the directory at boot, ordered by
    mtime) is the LRU — a read touches the file's mtime so recency
    SURVIVES a restart, and an insert sweeps oldest-first until the
    budget holds.  An entry larger than the whole budget is not stored.

    Writes are asynchronous by contract: ``put_async`` hands the entry
    to a single daemon writer thread (bounded queue; a full queue drops
    the write with a counter — the disk tier is an optimization, it must
    never backpressure the serving path).  ``get`` is synchronous
    (callers run it via ``asyncio.to_thread``).

    Counters/gauges (through the injected Metrics registry):
    ``cache_l2_{hits,misses,stores,sweeps,corrupt}_total`` and
    ``cache_l2_resident_bytes``."""

    _FORMAT = "cache.l2"
    _VERSION = 1

    def __init__(
        self,
        root: str,
        max_bytes: int = 0,
        *,
        metrics=None,
        queue_depth: int = 256,
    ):
        self.root = root
        self.max_bytes = int(max_bytes)
        self._metrics = metrics
        # BEST-EFFORT surface: a failing disk degrades the
        # tier to counted no-op writes — durable_degraded{surface=
        # "cache.l2"} flips once per episode instead of one log line
        # per swallowed writer-thread error
        self.surface = durable.Surface("cache.l2", metrics=metrics)
        self._lock = threading.Lock()
        # key -> charged bytes, oldest-mtime first (the LRU order)
        self._index: OrderedDict[str, int] = OrderedDict()
        self._resident = 0
        self.closed = False
        os.makedirs(root, exist_ok=True)
        self._rescan()
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        self._worker = threading.Thread(
            target=self._drain, name="l2-writer", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------ internals

    def _count(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc_counter(name, n)

    def _publish(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("cache_l2_resident_bytes", self._resident)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".l2")

    def _rescan(self) -> None:
        """Rebuild the index from the directory (boot / restart): stale
        ``.tmp`` files from a crashed writer are swept, complete entries
        come back oldest-mtime-first so LRU order survives the restart."""
        entries: list[tuple[float, str, int]] = []
        # stale .tmp debris from a crashed writer: the uniform boot sweep
        durable.sweep_tmp(self.root)
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for fn in names:
            path = os.path.join(self.root, fn)
            if not fn.endswith(".l2"):
                continue
            key = fn[: -len(".l2")]
            if not _L2_KEY_RE.match(key):
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, key, st.st_size))
        entries.sort()
        with self._lock:
            self._index = OrderedDict(
                (key, size) for _mt, key, size in entries
            )
            self._resident = sum(size for _mt, _k, size in entries)
        self._publish()

    def _evict_locked(self, key: str) -> None:
        size = self._index.pop(key, None)
        if size is not None:
            self._resident -= size
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    # ------------------------------------------------------------- surface

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    @property
    def entry_count(self) -> int:
        with self._lock:
            return len(self._index)

    def get(self, key: str) -> tuple[int, bytes, str] | None:
        """``(status, body, content_type)`` for a verified entry, None on
        miss.  Corruption in any form deletes the file and counts
        ``cache_l2_corrupt_total`` on top of the miss — the disk tier can
        degrade, it can never serve wrong bytes or raise."""
        if not _L2_KEY_RE.match(key):
            return None
        with self._lock:
            known = key in self._index
        if not known:
            self._count("cache_l2_misses_total")
            return None
        raw = durable.read_bytes(self._path(key), "cache.l2")
        if raw is None:
            # raced a sweep, the file vanished, or an injected EIO: a miss
            with self._lock:
                self._index.pop(key, None)
            self._count("cache_l2_misses_total")
            return None
        try:
            framed = durable.unframe(raw, self._FORMAT, self._VERSION)
        except durable.FutureVersionError:
            # fail-static (best-effort contract): an entry written by a
            # NEWER binary reads as a miss WITHOUT deletion — the newer
            # binary sharing the directory can still serve it
            self._count("cache_l2_misses_total")
            return None
        ok = framed is not None and isinstance(framed[0].get("status"), int)
        if not ok:
            slog.event(
                _log, "l2_corrupt_entry", level=logging.WARNING, key=key
            )
            with self._lock:
                self._evict_locked(key)
            self._count("cache_l2_corrupt_total")
            self._count("cache_l2_misses_total")
            self._publish()
            return None
        meta, body = framed
        with self._lock:
            if key in self._index:
                self._index.move_to_end(key)
        try:
            # recency must survive a restart: _rescan orders by mtime
            os.utime(self._path(key))
        except OSError:
            pass
        self._count("cache_l2_hits_total")
        return meta["status"], body, str(meta.get("ct", "application/json"))

    def put(self, key: str, status: int, body: bytes, content_type: str) -> bool:
        """Synchronous write-through of one POSITIVE entry (the writer
        thread's body; tests call it directly).  Returns whether stored."""
        if status != 200 or not _L2_KEY_RE.match(key):
            return False
        data = durable.frame(
            self._FORMAT, self._VERSION, body,
            extra={"status": status, "ct": content_type},
        )
        if self.max_bytes and len(data) > self.max_bytes:
            # one oversized payload must not evict the whole durable set
            return False
        # best-effort contract: a failed write counts into the durable
        # families and flips durable_degraded{surface="cache.l2"} once
        # per episode — no per-write log line, no exception, no store
        if not durable.atomic_write(self._path(key), data, surface=self.surface):
            return False
        swept = 0
        with self._lock:
            old = self._index.pop(key, None)
            if old is not None:
                self._resident -= old
            self._index[key] = len(data)
            self._resident += len(data)
            while (
                self.max_bytes
                and self._resident > self.max_bytes
                and len(self._index) > 1
            ):
                victim = next(iter(self._index))
                self._evict_locked(victim)
                swept += 1
        if swept:
            self._count("cache_l2_sweeps_total", swept)
        self._count("cache_l2_stores_total")
        self._publish()
        return True

    def put_async(self, key: str, status: int, body: bytes, content_type: str) -> None:
        """Enqueue a write for the background writer; a full queue drops
        the entry (counted) rather than stalling the caller."""
        try:
            self._queue.put_nowait((key, status, body, content_type))
        except queue.Full:
            self._count("cache_l2_store_drops_total")

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self.put(*item)
            except Exception as e:  # noqa: BLE001 — writer must survive
                # disk errors never reach here (durable.atomic_write
                # absorbs them into the cache.l2 degraded machinery);
                # this is the last-resort net for programming errors
                slog.event(
                    _log, "l2_writer_error", level=logging.ERROR,
                    error=f"{type(e).__name__}: {e}",
                )

    def close(self, timeout_s: float = 10.0) -> None:
        """Flush queued writes and stop the writer thread (idempotent)."""
        if self.closed:
            return
        self.closed = True
        self._queue.put(None)
        self._worker.join(timeout_s)
