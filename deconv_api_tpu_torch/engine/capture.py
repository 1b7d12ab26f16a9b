"""One captured CUDA graph per program shape: the port's counterpart of
``jax.jit`` with its per-shape executables (``deconv_api_tpu/serving/
models.py`` ``_vis_cache``, ``engine/deconv.py`` ``get_visualizer``,
``engine/deepdream.py`` ``_octave_jit`` and ``_dream_jit``).

A ``CapturedProgram`` records ``body(*static)`` once into a CUDA graph and
replays it: new inputs are copied into the static tensors, the graph
replays, and the static outputs hold the result.  Before the capture the
body runs ``WARMUP_RUNS`` times eagerly on the capture's side stream, as
``torch.cuda.graph`` requires.  That is where every first use happens:
the kernels build and load, K3 sets its dynamic shared memory, cuDNN picks
its algorithms, cuBLAS makes its workspace, and lazy caches such as
``ops/activations.py:_const`` fill, all outside the capture, so a graph's
pool holds its own allocations only and is freed whole with the graph.

On the CPU the same object runs its body on every replay, through the same
static inputs, and copies the result into the outputs of its first run, so
the CPU tests exercise the buffer discipline of the card.  It is not a
fallback: on ``cuda`` a capture or a replay that fails raises, and nothing
runs eagerly in its place.

Outputs alias memory the program owns: its next replay overwrites them, and
so may the replay of any other program of its ``ProgramCache``, whose
programs share one memory pool.  Read them inside ``ProgramCache.
replaying()``, before the next replay.

Every capture holds ``DEVICE_LOCK`` exclusively (a ``ProgramCache`` miss
from the allocation of the static tensors on), and all device work of the
serving dispatchers holds it shared.  A capture runs in CUDA's global mode
(torch's default), where a ``cudaMalloc``, a synchronising copy or a launch
on the legacy stream from another thread invalidates it, and the deconv and
dream dispatchers run on two threads.  (The relaxed ``thread_local`` mode
was not taken: the autograd engine runs a captured backward on its own
device thread, and global mode is the one its capture is known to work in.)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Hashable, Sequence

import torch

from deconv_api_tpu_torch import ops

WARMUP_RUNS = 2  # eager runs of the body on a side stream before a capture
MAX_PROGRAMS = 128  # the JAX package's _dream_jit and get_visualizer cache size


class SharedLock:
    """Many holders under ``shared()`` or one under ``exclusive()``.  A
    waiting exclusive holder keeps new shared holders out, so a stream of
    requests cannot starve a capture.  The exclusive holder may enter
    ``exclusive()`` again; nothing else is re-entrant."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0
        self._owner = None  # the exclusive holder's thread

    @contextlib.contextmanager
    def shared(self):
        with self._cv:
            while self._exclusive or self._waiting:
                self._cv.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cv:
                self._shared -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        if self._owner == threading.get_ident():  # only its holder sees itself here
            yield
            return
        with self._cv:
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cv.wait()
            self._waiting -= 1
            self._exclusive = True
            self._owner = threading.get_ident()
        try:
            yield
        finally:
            with self._cv:
                self._exclusive = False
                self._owner = None
                self._cv.notify_all()


DEVICE_LOCK = SharedLock()


@dataclasses.dataclass(frozen=True)
class BatchProgram:
    """A batched device program of the engines.  ``body(params, x)`` runs
    on a (B, H, W, C) batch ``x`` already on ``device``: it is what a
    capture records.  Calling it, ``program(params, images)``, first moves
    a host batch (array or tensor) there.  With ``grad_input`` the body
    differentiates with respect to ``x``, which must then be a leaf that
    requires grad (the DAG engine)."""

    body: Callable
    device: torch.device
    grad_input: bool = False

    def stage(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device)
        return x.detach().requires_grad_(True) if self.grad_input else x

    def __call__(self, params, images):
        return self.body(params, self.stage(images))

    def static_input(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """A static input of ``shape`` and ``dtype`` for a capture of this
        program."""
        return torch.zeros(shape, dtype=dtype, device=self.device, requires_grad=self.grad_input)


def _copy_into(dst, src) -> None:
    """Copy a tree (dict, list, tuple) of tensors into one of the same
    structure."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif dst is not None:
        raise TypeError(f"program output of type {type(dst).__name__} is not a tensor tree")


class CapturedProgram:
    """``body(*static)`` captured once on the static tensors ``static``
    (all on one device, allocated by the caller) and replayed; on the CPU,
    run on each replay.  ``kernels`` counts the hand-written kernels the
    graph holds (``ops.launch_counts()`` names), ``capture_s`` the seconds
    of the warm-up runs and the capture."""

    def __init__(self, body: Callable, static: Sequence[torch.Tensor], *, pool=None):
        self.body = body
        self.static = tuple(static)
        self.device = self.static[0].device
        self.graph = None
        self.outputs = None
        self.kernels: dict[str, int] = {}
        self.capture_s = 0.0
        if self.device.type == "cuda":
            self._capture(pool)

    def _capture(self, pool) -> None:
        with DEVICE_LOCK.exclusive():
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(graph, pool=pool)
            # the warm-up runs on the stream every capture runs on (torch's
            # default capture stream): cuBLAS keeps a workspace per (thread's
            # handle, stream), made at its first use, so the warm-up makes it
            # outside the pool.  Made inside a capture it would sit in that
            # graph's pool for good, and the pool could never be freed.  One
            # stream for every capture also lets a shared pool reuse blocks.
            current = torch.cuda.current_stream(self.device)
            side = capture.capture_stream
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self.body(*self.static)
            current.wait_stream(side)
            before = ops.launch_counts()
            with capture:
                self.outputs = self.body(*self.static)
            after = ops.launch_counts()
            # a wrapper called during the capture recorded its kernel into
            # the graph: it launches on each replay, not now
            self.kernels = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            ops.add_launch_counts({k: -n for k, n in self.kernels.items()})
            self.graph = graph
            self.capture_s = time.perf_counter() - t0
            ops.graph_counts["captures"] += 1

    def load(self, *inputs, non_blocking: bool = False) -> None:
        """Copy ``inputs`` into the static tensors (a host tensor is copied
        to the device here, outside any capture).  With ``non_blocking`` a
        pinned host tensor is copied asynchronously on the current stream:
        keep it unchanged until that stream has passed the copy."""
        with torch.no_grad():
            for s, x in zip(self.static, inputs):
                s.copy_(x, non_blocking=non_blocking)

    def replay(self):
        """Run the program on the static tensors' contents; returns the
        outputs (see the module docstring for how long they hold)."""
        if self.graph is not None:
            self.graph.replay()
            ops.add_launch_counts(self.kernels)
            ops.graph_counts["replays"] += 1
            return self.outputs
        out = self.body(*self.static)
        if self.outputs is None:
            self.outputs = out
        else:
            with torch.no_grad():
                _copy_into(self.outputs, out)
        return self.outputs

    def __call__(self, *inputs):
        self.load(*inputs)
        return self.replay()


class ProgramCache:
    """An LRU of captured programs bounded at ``maxsize``, keyed by
    everything that changes the program (the caller's key: model, program
    settings, bucket, input shape).  Its programs share one memory pool and
    never run at once: a caller replays and reads the outputs inside
    ``replaying()``.  Programs that capture a params tree serve that tree
    only: a cache belongs to one model's params."""

    def __init__(self, device: torch.device, maxsize: int = MAX_PROGRAMS):
        self.device = torch.device(device)
        self.maxsize = maxsize
        self.pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._programs: collections.OrderedDict[Hashable, CapturedProgram] = collections.OrderedDict()
        self._lock = threading.Lock()  # the dict, and one capture at a time
        self._replay = threading.Lock()

    def get(self, key: Hashable, make: Callable[[], tuple[Callable, Sequence[torch.Tensor]]]) -> CapturedProgram:
        """The program of ``key``, captured at its first use from ``make()
        -> (body, static tensors)``; the least recently used beyond
        ``maxsize`` is dropped.  On the card a miss holds ``DEVICE_LOCK``
        exclusively from ``make()``, which allocates the static tensors, to
        the eviction, which frees a graph: a capture of another cache may
        run on another thread.  Never call it inside ``replaying()``: a
        capture waits for every replay to end."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                return prog
            on_card = self.device.type == "cuda"
            with DEVICE_LOCK.exclusive() if on_card else contextlib.nullcontext():
                body, static = make()
                prog = self._programs[key] = CapturedProgram(body, static, pool=self.pool)
                while len(self._programs) > self.maxsize:
                    self._programs.popitem(last=False)
            return prog

    @contextlib.contextmanager
    def replaying(self):
        """Hold while loading, replaying and reading this cache's programs."""
        with DEVICE_LOCK.shared(), self._replay:
            yield

    def clear(self) -> None:
        """Drop every program and take a new memory pool: the graphs, their
        outputs and static tensors are freed, and the next
        ``torch.cuda.empty_cache`` releases the old pool's memory.
        Never call it inside ``replaying()``; on the card hold
        ``DEVICE_LOCK`` exclusively."""
        with self._lock:
            self._programs.clear()
            if self.device.type == "cuda":
                self.pool = torch.cuda.graph_pool_handle()

    def keys(self) -> list:
        with self._lock:
            return list(self._programs)

    def programs(self) -> dict:
        with self._lock:
            return dict(self._programs)

    def __len__(self) -> int:
        return len(self._programs)
