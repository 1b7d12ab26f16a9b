"""Device weight manager: several models served from one card (the
counterpart of ``deconv_api_tpu/serving/weight_manager.py``).

- **Paged residency.**  Model params live as host archives in pinned
  memory; an LRU pages them onto the card on demand under
  ``hbm_budget_bytes``, counted in the stored tree's bytes, as the JAX
  package counts them.  Cold-model requests wait behind a singleflight
  page-in (one transfer per model; concurrent checkouts of the same cold
  model coalesce), and eviction never unloads a model with in-flight
  batches (a pin count guards every dispatched batch).  Pinned models (the
  boot-warmed set) are never evicted.

- **A quantized weight tier.**  ``weight_dtype`` selects what the device
  copy stores: ``f32`` (exact, the default), ``bf16`` (stored bf16, cast to
  f32 on use: half the bytes) or ``int8`` (per-tensor symmetric int8 for
  the conv and dense kernels, f32 dequant-on-use: about a quarter of the
  kernel bytes).  The programs read the stored tree and dequantize inside
  their captured graph (``serving/models.py``), so the card holds the
  quantized form and the f32 view exists only as graph temporaries.

A captured CUDA graph replays against the addresses it read at capture
(``engine/capture.py``), and a page-in puts the weights at new ones.  So a
page-out drops the model's stored tree, its captured deconv and dream
programs and their memory pools (``ModelBundle.page_out``), and the first
batch after the next page-in captures its programs again, as the JAX
package compiles a model's programs at its first use.  Page-ins, page-outs
and builds allocate or free on the card, so each holds ``DEVICE_LOCK``
exclusively: a capture on the other dispatcher's thread runs in CUDA's
global mode, which another thread's allocation would break.

Two modes keep the single-model path untouched:

- **Inert** (one served model, f32, no budget: the default config): the
  bundle keeps its params on the card, its programs read them, and
  ``checkout`` is a lookup.
- **Managed** (several served models, a quantized tier, or a byte budget):
  bundle params are archived on the host at build time, the stored form
  is computed once, and device residency is explicit: ``checkout`` pages
  in (or waits on the page-in in flight), pins, and returns the device
  tree; ``release`` unpins after the batch's results are on the host.

``checkout`` and ``release`` run on the dispatcher threads; the one lane is
the card.  Bundle builds are serialized by a build lock; the bookkeeping
sits under one mutex.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

import torch

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.engine.capture import DEVICE_LOCK
from deconv_api_tpu_torch.models.weights import tree_map
from deconv_api_tpu_torch.utils.quantize import Q8_LEVELS, int8_scale

log = logging.getLogger(__name__)

WEIGHT_DTYPES = ("f32", "bf16", "int8")

# Reserved leaf keys of a per-tensor symmetric int8 kernel inside a params
# tree: the dict is the leaf, so these names never collide with real
# parameter names ("w", "b", "gamma", ...).
_Q8_KEY = "__q8__"
_Q8_SCALE = "__q8_scale__"


def _is_q8_leaf(node: Any) -> bool:
    return isinstance(node, dict) and _Q8_KEY in node


def quantize_params(tree: Any, weight_dtype: str) -> Any:
    """Host-side quantisation of a params tree into its stored form.

    ``f32`` passes the tree through.  ``bf16`` stores every float leaf as
    bfloat16 (round to nearest even).  ``int8`` stores kernels (float
    leaves of ndim >= 2: conv HWIO kernels and dense matrices, where the
    bytes are) as per-tensor symmetric int8 with an f32 scale; biases and
    BN vectors stay f32.
    """
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, got {weight_dtype!r}")
    if weight_dtype == "f32":
        return tree

    def q(node):
        if isinstance(node, dict):
            return {k: q(v) for k, v in node.items()}
        t = torch.as_tensor(node)
        if not t.is_floating_point():
            return t
        if weight_dtype == "bf16":
            return t.to(torch.bfloat16)
        if t.ndim >= 2:
            amax = float(t.abs().max()) if t.numel() else 0.0
            scale = torch.tensor(int8_scale(amax), dtype=torch.float32)
            qt = torch.clamp(torch.round(t.to(torch.float32) / scale), -Q8_LEVELS, Q8_LEVELS)
            return {_Q8_KEY: qt.to(torch.int8), _Q8_SCALE: scale}
        return t.to(torch.float32)

    return q(tree)


def dequantize_params(tree: Any) -> Any:
    """The in-program inverse of ``quantize_params``: torch ops that a
    captured graph records, so programs read the stored tree and the f32
    view exists only as graph temporaries.  f32 trees come back equal."""

    def dq(node):
        if _is_q8_leaf(node):
            return node[_Q8_KEY].to(torch.float32) * node[_Q8_SCALE]
        if isinstance(node, dict):
            return {k: dq(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16:
            return node.to(torch.float32)
        return node

    return dq(tree)


def tree_nbytes(tree: Any) -> int:
    """Total bytes of every array leaf of a nested dict: for a device tree,
    its charge against the budget."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0))


def _exclusive():
    """``DEVICE_LOCK`` held exclusively where there is a card: a build, a
    page-in or a page-out may allocate or free on it."""
    return DEVICE_LOCK.exclusive() if torch.cuda.is_available() else contextlib.nullcontext()


@dataclasses.dataclass
class _Resident:
    tree: Any
    nbytes: int


class WeightManager:
    """Own every served model's host archive and device residency.

    ``builders`` maps model name -> zero-arg ``ModelBundle`` factory (the
    registry's entries, or injected ones in tests); ``default`` is the
    boot model, always served and always pinned.  A managed bundle carries
    ``managed``, ``weight_dtype`` and ``stored`` (its resident device
    tree, None while paged out) and ``page_out()``; its ``device`` is
    where it pages in.  ``weights_loader(name, bundle)`` is the service's
    checkpoint hook: it runs once at each bundle's build, before the host
    archive and the stored tiers are made from its params.  The default
    bundle comes in built and already loaded."""

    def __init__(
        self,
        builders: dict[str, Callable[[], Any]],
        default: str,
        *,
        default_bundle: Any = None,
        pinned: tuple[str, ...] = (),
        budget_bytes: int = 0,
        weight_dtype: str = "f32",
        metrics=None,
        weights_loader: Callable[[str, Any], None] | None = None,
    ):
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, got {weight_dtype!r}")
        if default not in builders:
            raise ValueError(f"default model {default!r} missing from the served set {sorted(builders)}")
        self.builders = dict(builders)
        self.default = default
        self.served = frozenset(self.builders)
        # the default is always pinned: the boot-warmed model never pays a
        # page-in mid-traffic because colder models pushed it out
        self.pinned = tuple(dict.fromkeys((default, *pinned)))
        unknown = [p for p in self.pinned if p not in self.served]
        if unknown:
            raise ValueError(f"pinned model(s) {unknown} are not in the served set {sorted(self.served)}")
        self.budget_bytes = int(budget_bytes)
        self.weight_dtype = weight_dtype
        self.managed = len(self.served) > 1 or weight_dtype != "f32" or self.budget_bytes > 0
        self._metrics = metrics
        self._weights_loader = weights_loader
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._bundles: dict[str, Any] = {}
        self._archives: dict[str, Any] = {}  # stored host trees (managed)
        self._resident: OrderedDict[str, _Resident] = OrderedDict()
        self._pins: dict[str, int] = {}
        self._paging: dict[str, threading.Event] = {}
        self.page_ins = 0
        self.page_outs = 0
        self.page_in_bytes = 0
        self.overcommits = 0
        self.page_in_s: dict[str, float] = {}  # each model's last page-in (copy) seconds
        if self.managed and metrics is not None:
            # the weight families read 0 from boot rather than appearing
            # at their first event
            for name in ("weight_page_ins_total", "weight_page_outs_total", "weight_page_bytes_total",
                         "weight_budget_overcommit_total", "weight_evict_inflight_total"):
                metrics.inc_counter(name, 0)
        if default_bundle is not None:
            with _exclusive():
                self._prepare(default, default_bundle)
            self._bundles[default] = default_bundle

    # ------------------------------------------------------------- bundles

    def _prepare(self, name: str, bundle) -> None:
        """In managed mode: the params become a host archive (in pinned
        memory for a card), the stored form is computed once, and the
        bundle's programs read its resident tree from then on.  The card
        keeps nothing of the build: a page-out frees the model whole."""
        if not self.managed:
            return
        device = getattr(bundle, "device", torch.device("cpu"))
        host = tree_map(lambda t: t.detach().to("cpu"), bundle.params)
        archive = quantize_params(host, self.weight_dtype)
        if device.type == "cuda":
            archive = tree_map(lambda t: t.pin_memory(), archive)
        # the f32 host tree (shapes, the CPU's runs) is the archive itself
        # in the f32 tier
        bundle.params = archive if self.weight_dtype == "f32" else host
        bundle.weight_dtype = self.weight_dtype
        bundle.managed = True
        bundle.stored = None
        self._archives[name] = archive
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def peek_bundle(self, name: str):
        """The bundle when already built, else None."""
        with self._lock:
            return self._bundles.get(name)

    def bundle(self, name: str):
        """The model's bundle, built on first use (one build at a time;
        callers for an already-built model never wait).  A build may
        allocate on the card, so it holds ``DEVICE_LOCK`` exclusively."""
        with self._lock:
            b = self._bundles.get(name)
        if b is not None:
            return b
        if name not in self.builders:
            raise errors.UnknownModel(f"unknown or unserved model {name!r}; serving: {sorted(self.served)}")
        with self._build_lock:
            with self._lock:
                b = self._bundles.get(name)
            if b is not None:
                return b
            t0 = time.perf_counter()
            with _exclusive():
                b = self.builders[name]()
                if self._weights_loader is not None:
                    # before _prepare: the archive, the stored tiers and
                    # every later page-in hold the loaded weights
                    self._weights_loader(name, b)
                self._prepare(name, b)
            with self._lock:
                self._bundles[name] = b
            log.info("model_built model=%s ms=%.1f managed=%s", name, (time.perf_counter() - t0) * 1e3,
                     self.managed)
            return b

    # ----------------------------------------------------------- residency

    def checkout(self, name: str):
        """The device params tree one dispatch reads, paged in if cold and
        pinned against eviction until ``release``.  Returns ``(tree,
        page_in_seconds)``, 0.0 on the warm path.  Concurrent checkouts of
        one cold model coalesce onto one transfer."""
        bundle = self.bundle(name)
        if not self.managed:
            return bundle.params, 0.0
        while True:
            with self._lock:
                res = self._resident.get(name)
                if res is not None:
                    self._resident.move_to_end(name)
                    self._pins[name] = self._pins.get(name, 0) + 1
                    return res.tree, 0.0
                ev = self._paging.get(name)
                if ev is None:
                    ev = self._paging[name] = threading.Event()
                    break  # this thread leads the page-in
            # a transfer of this model is in flight: wait for it, then look
            # again (a failed leader leaves the slot empty for a waiter)
            if not ev.wait(timeout=600.0):
                raise errors.Unavailable(f"weight page-in for model {name!r} did not complete")
        device = getattr(bundle, "device", torch.device("cpu"))
        t0 = time.perf_counter()
        try:
            with _exclusive():
                tree = self._place(self._archives[name], device)
                nbytes = tree_nbytes(tree)
                dt = time.perf_counter() - t0
                bundle.stored = tree  # before a waiter can see it resident
                with self._lock:
                    self._resident[name] = _Resident(tree, nbytes)
                    self._pins[name] = self._pins.get(name, 0) + 1
                    self.page_ins += 1
                    self.page_in_bytes += nbytes
                    self.page_in_s[name] = dt
                    evicted = self._evict_locked(exclude=name)
                    self._paging.pop(name, None)
                self._unload(evicted)
        except BaseException:
            with self._lock:
                self._paging.pop(name, None)
            ev.set()
            raise
        ev.set()
        if self._metrics is not None:
            self._metrics.inc_counter("weight_page_ins_total")
            self._metrics.inc_counter("weight_page_bytes_total", nbytes)
            self._metrics.observe_stage("weight_page_in", dt)
        self._publish_gauges()
        log.info("weight_page_in model=%s mb=%.2f ms=%.1f evicted=%s", name, nbytes / 1e6, dt * 1e3,
                 evicted or None)
        return tree, dt

    def release(self, name: str) -> None:
        """Drop one dispatch's eviction pin (its results are on the host)."""
        if not self.managed:
            return
        with self._lock:
            n = self._pins.get(name, 0)
            if n <= 1:
                self._pins.pop(name, None)
            else:
                self._pins[name] = n - 1
            if n > 0 and name not in self._resident:
                # a pinned model must never leave residency while its
                # dispatch runs: this firing is a bug in the eviction guard
                if self._metrics is not None:
                    self._metrics.inc_counter("weight_evict_inflight_total")
                log.error("weight_evict_inflight model=%s", name)

    def _place(self, tree: Any, device: torch.device) -> Any:
        """One device transfer of the stored tree: an asynchronous copy per
        leaf from pinned memory, then a wait for the copies."""
        out = tree_map(lambda t: t.to(device, non_blocking=True, copy=True), tree)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return out

    def _evict_locked(self, exclude: str) -> list[str]:
        """LRU page-out down to the byte budget, under the lock right after
        an insert.  Skips pinned models, models with in-flight batches, and
        the entry that triggered the eviction.  When nothing is evictable
        the budget overshoots loudly rather than failing requests."""
        if self.budget_bytes <= 0:
            return []
        od = self._resident
        total = sum(r.nbytes for r in od.values())
        evicted: list[str] = []
        for victim in list(od):
            if total <= self.budget_bytes:
                break
            if victim == exclude or victim in self.pinned or self._pins.get(victim, 0) > 0:
                continue
            total -= od.pop(victim).nbytes
            self.page_outs += 1
            evicted.append(victim)
            if self._metrics is not None:
                self._metrics.inc_counter("weight_page_outs_total")
        if total > self.budget_bytes:
            self.overcommits += 1
            if self._metrics is not None:
                self._metrics.inc_counter("weight_budget_overcommit_total")
            log.warning("weight_budget_overcommit resident_bytes=%d budget_bytes=%d: every resident model "
                        "is pinned or in flight", total, self.budget_bytes)
        return evicted

    def _unload(self, names: list[str]) -> None:
        """Free what evicted models hold on the card: their stored trees,
        captured programs and graph pools.  The caller holds
        ``DEVICE_LOCK`` exclusively when the card is involved."""
        if not names:
            return
        for name in names:
            self._bundles[name].page_out()
        if any(getattr(self._bundles[n], "device", torch.device("cpu")).type == "cuda" for n in names):
            torch.cuda.empty_cache()

    def enforce_budget(self) -> list[str]:
        """Apply the byte budget now: page out LRU victims until within it
        (pinned and in-flight models still never move).  Eviction normally
        runs at page-in time; this is the hook for a budget lowered at
        runtime."""
        with _exclusive():
            with self._lock:
                out = self._evict_locked(exclude="")
            self._unload(out)
        self._publish_gauges()
        return out

    def _publish_gauges(self) -> None:
        if self._metrics is None:
            return
        with self._lock:
            count, nbytes = len(self._resident), sum(r.nbytes for r in self._resident.values())
        self._metrics.set_labeled_gauge("resident_models", "lane", "0", count)
        self._metrics.set_labeled_gauge("weight_resident_bytes", "lane", "0", nbytes)

    # ------------------------------------------------------------ surfaces

    def resident_models(self) -> list[str]:
        """Resident models, LRU order (oldest first).  In inert mode the
        default model is the whole answer."""
        if not self.managed:
            return [self.default]
        with self._lock:
            return list(self._resident)

    def inflight_pins(self, name: str) -> int:
        with self._lock:
            return self._pins.get(name, 0)

    def snapshot(self) -> dict:
        """Live residency for /v1/config."""
        with self._lock:
            lanes = {"0": {"resident": list(self._resident),
                           "bytes": sum(r.nbytes for r in self._resident.values())}}
            built = sorted(self._bundles)
        return {
            "managed": self.managed,
            "weight_dtype": self.weight_dtype,
            "hbm_budget_bytes": self.budget_bytes,
            "served": sorted(self.served),
            "pinned": list(self.pinned),
            "built": built,
            "lanes": lanes if self.managed else {"0": {"resident": [self.default], "bytes": 0}},
            "page_ins": self.page_ins,
            "page_outs": self.page_outs,
            "page_in_bytes": self.page_in_bytes,
            "overcommits": self.overcommits,
        }

    def ready_block(self) -> dict:
        """The compact residency block /readyz carries when more than one
        model is served."""
        with self._lock:
            resident = {"0": list(self._resident)}
        if not self.managed:
            resident = {"0": [self.default]}
        return {"served": len(self.served), "pinned": len(self.pinned), "resident": resident}
