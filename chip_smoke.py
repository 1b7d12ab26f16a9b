#!/usr/bin/env python3
"""Smoke test of deconv_api_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
card, ``nvcc`` and the repository's sources; without them it exits non-zero
and prints no result.  It imports nothing of JAX or of the JAX package.

Phases, each printing JSON lines:
1. environment: torch, CUDA, nvcc, triton, the TF32 flags, the codec
   backend, and the card's name and power limit;
2. build: the four kernels from ``deconv_api_tpu_torch/csrc``, one nvcc each,
   all started together, with each instantiation's registers and spills;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' VGG16 shapes (``POST /``: batch 8, top-4; the grouped
   forms at the packed sites of ``/v1/deconv``: batch 8, top-8, 8 groups),
   with single-call times by CUDA events (as the earlier slices took them)
   beside the plain version's, a library call's and the bound; for K1 and
   K2 also the time of one call with the L2 evicted before it, and each
   site's time, launch plan and share of its bound (for K3 its rate, the
   port's unfused pair's time and the fp32 kernel's time, bound, and its
   library: K2 and ``F.conv2d`` in fp32 with TF32 off); K5, the int8
   layer step, bit for bit at every conv of the int8 forward and at fc1:
   its input quantizer, its K-major weight quantizer, its contraction as
   the raw int32 accumulator and as the fused step (bias fold, relu,
   dequantize), each beside its plain version and its bound, the raw
   contraction beside ``torch._int_mm`` on the im2col'd operands where its
   rules allow;
4. main path ``POST /``: ``serve`` with VGG16 at full width on a free port,
   8 concurrent ``POST /`` at block5_conv1 plus one at block3_conv3 and one
   at fc1, then one batch repeated at the other ``fused_unpool`` setting
   than the default (so K2 and K3 both run);
5. main path ``POST /v1/deconv``: ``serve --lowc-kpack auto`` likewise, 8
   concurrent tile requests at block5_conv1 plus one ``mode=max``, one
   ``top_k=1`` and one ``sweep`` from block3_conv1, then one batch repeated
   with ``lowc_kpack=off`` and at the other ``fused_unpool`` setting;
6. throughput of the batch-8 block5_conv1 programs (grid at
   ``fused_unpool`` auto and off in turns; tiles at each ``lowc_kpack``
   policy at the default ``fused_unpool``, and at ``lowc_kpack=off`` with
   ``fused_unpool`` auto and off in turns) and of one batch-8 sweep from
   block5_conv1 at each setting;
7. dag: ``serve --model resnet50`` at 224x224, 8 concurrent ``POST /`` at
   conv5_block3_out, one ``/v1/deconv`` with top-8 tiles and one sweep from
   conv5_block3_out; one batch-8 ``POST /`` program each of inception_v3
   (299, mixed10), mobilenet_v1 (conv_pw_13_relu), mobilenet_v2 (out_relu)
   and vgg19 (block5_conv1, at the default ``fused_unpool`` and at
   ``auto``); each DAG family's projection of one full-width image on the
   card against the same program on the CPU (``engine/crosscheck.py``:
   the CPU's channels projected on the card, and the card's own
   selection where the CPU's ranking is separated); then the p50 of ResNet50's
   grid, tiles and sweep programs and of the other models' grid programs,
   with one profiled call each, and ResNet50's batched backward against K
   retained backward passes, in turns;
8. dream: ``serve --model inception_v3`` at 299x299, 4 concurrent default
   ``POST /v1/dream`` (mixed3-mixed5, 10 steps on the 5 rungs of 10
   octaves that fit over 75 px) and one naming another model (422
   ``unknown_model``); one default dream each of vgg16 (224, 8 rungs, the
   truncated spec) and mobilenet_v2 (ReLU6 true gradients) through the
   engine; one InceptionV3 dream on the card against the same dream on the
   CPU (``engine/crosscheck.py:dream_card_vs_cpu``: every float32 step
   from the card's input, and the whole dream in float64); the p50 of the
   batch-4 and batch-1 InceptionV3 dreams, with one profiled call.  No
   hand-written kernel lies on the dream path: its counts must stay 0.
9. capture: every captured program against its eager run and each padded
   row against its solo run (``phase_capture``), and what the graphs hold;
10. multi_model: one server of vgg16 (default), resnet50 (pinned),
   inception_v3 and mobilenet_v2 under a weight budget that holds three,
   whose requests page models out and in, each step's residency held
   against a CPU replay through the port's manager, then VGG16 paged out
   and served from graphs captured anew (``phase_multi_model``);
11. load (BASELINE.json config 5): 256 concurrent keep-alive clients in 4
   spawned processes post ``POST /`` (16 distinct 256x240 PNGs) to a VGG16
   server at every default, block5_conv1, 1024 requests a run at
   ``pipeline_depth`` 1 and 2; each run prints images/s, latency
   quantiles, the 503/504 counts, the batch-size histogram, the device's
   busy share (a profiled slice) and the host's CPU count, and every 200
   answer is held against its own image's grid served alone at every
   bucket; then one dispatch step each of the grid, tiles and dream
   programs under ``torch.cuda.set_sync_debug_mode("error")``, and the
   deadline, shed and breaker drills (``phase_load``); then one more turn
   of 1024 on a server at every default (the response cache and
   singleflight on) with ``--slo api=3000:99 --tsdb on``: its cache
   counts, the ``request_duration_seconds`` history and the SLO's burn
   rate read back (``load_at_defaults``);
12. cache: a VGG16 server at every default, the response cache in front
   of ``POST /``: 16 misses then 16 hits (each byte-equal, no replay and
   no K1/K2 launch during the hits), 64 concurrent identical posts on one
   dispatched row, a ``no-cache`` recompute and a ``no-store`` one, a
   negative-cached 422 and an unknown model's 422 before any flight, and
   the L2 tier across a restart (``phase_cache``);
13. quality: a VGG16 server with ``--tenants`` (two tenants, so QoS on):
   ``quality=bogus`` a 422, the three tiers and a calibrated int8 server
   on ``POST /`` (K5's contraction, input quantizer and weight quantizer
   11 times each per int8 replay), the tiers' captured
   programs timed, and a QoS turn of an interactive and a bulk tenant
   (``phase_quality``);
14. jobs: a VGG16 server with ``--jobs-dir``: deconv (full and int8) and
   sweep jobs from block3_conv1 byte-equal to the synchronous
   ``/v1/deconv`` answers, a default dream job byte-equal to ``/v1/dream``
   and to the same dream crash-resumed after its first octave, a cancel
   mid-dream with no replay after it, and a dream parked by the drain and
   finished by a second server on the directory with the same bytes, each
   job's wall time beside its synchronous route's (``phase_jobs``);
15. settings: ``warmup_wall_s`` with and without the default dream's
   warmup and the first dream without it; a ``fused_unpool=auto`` server
   (K3 4 times a grid replay), the same with ``backward_dtype=float32``
   timed, and a ``dtype=bfloat16`` server's full grids equal to the
   default server's bf16 tier (``phase_settings``);
16. fleet: three VGG16 ``serve`` processes (every default, the cache on,
   ``--peer-fill``) registered with one ``fleet-router`` process: 16
   misses then 16 hits through the router, each hit from its miss's
   backend; 64 hits through the router against the same straight to
   their owners, in turns; hedges around one backend slowed by the
   router's ``fleet.head_delay_ms``, within their budget; the federated
   metrics and one joined trace; a SIGTERM drain under traffic (every
   answer 200, the drained keys filled from the draining backend's cache
   with no device batch, exit 0); a SIGKILL failover (every answer 200,
   the backend ejected). The backends' launches are read back from each
   process (``phase_fleet``);
17. weights: (a) the Keras-written golden fixture as the port's npz
   (``tests/fixtures/torch/vgg16_block1.npz``): VGG16 truncated at
   block1_pool at 64x64 within 1e-4 of Keras's activations, the init not,
   K1's switches at block1_pool bit-exact against its plain version; (b)
   ``serve --serve-models vgg16,resnet50 --weights DIR`` on npz files of
   seed-1 weights beside the same server without them: each model's
   ``POST /`` byte-equal to the server's in-process captured grid and
   unlike the init's, the host archives equal to the files, both models
   paged out and in with the same bytes, the int8 grid unlike the init's
   int8 grid, the cache-key prefixes apart in ``weights_path`` alone; (c)
   the CLI's ``visualize``, ``visualize --sweep`` and ``dream`` as
   subprocesses equal to the same commands in this process, and
   ``doctor`` all ok with K1 and K2 launched by its selftest; (d) a
   ``--profile-dir`` server armed by ``POST /v1/profile batches=2``
   writes two ``torch.profiler`` traces naming K1's and K2's kernels in
   the graph replays (``phase_weights``);
18. warm_boot: three VGG16 ``serve`` processes, each from a fresh copy of
   the package (no ``build/``), on one ``--aot-dir`` store: cold (4
   misses, the four nvcc builds stored), warm (4 hits, no nvcc process),
   and with one entry damaged (1 corrupt, 1 miss, 1 rebuild); their boot
   splits and one ``POST /`` each, byte-equal (``phase_warm_boot``);
19. autoscale: ``fleet-router --autoscale enforce`` (min 1, max 2) before
   one such backend on that store: a slowed job queue launches a second,
   which boots warm (``autoscaler_boot_to_warm_seconds``); a running job
   on it holds its reap after the drain announcement until the job is
   done; every answer through the router 200, the fleet back to 1
   (``phase_autoscale``);
20. train: ``python -m deconv_api_tpu_torch train --model vgg16 --steps 10
   --batch 8 --save-every 5`` and its ``--steps 12 --resume`` as
   processes, the resumed checkpoint bit-equal to an uninterrupted 12-step
   run in this process (cuDNN deterministic; if not, the phase fails
   naming the ops that ``torch.use_deterministic_algorithms`` names in a
   step); one VGG16 step at batch 2 in float32 on the card against the
   CPU's (the loss and every gradient leaf, the card replaying the CPU's
   ReLU gates and pool argmaxes; ``step_fn`` with remat with and without
   that replay);
   three ResNet50 steps with BatchNorm trained; ``serve --weights <ckpt>``
   byte-equal to its in-process grid and unlike the init server's; VGG16's
   step times and peak memory with remat and deterministic cuDNN on and
   off, the held-out evaluation, a TrainState's checkpoint written and
   restored.  Every training window's hand-written kernel launches must
   be 0 (``phase_train``).
Phases 4-11 and 13-15 measure device work: their servers run with
``cache_bytes=0`` and no singleflight (``CACHE_OFF``), and each prints
``server_cache``.
Every route serves through captured CUDA graphs, one per
program and bucket (``engine/capture.py``): each server's warmup captures
every bucket of both route defaults and of the default dream before
``/ready`` (``warmup_report``), and the throughput phases time each
program captured, with its eager run beside it in turns.  A graph's
kernels count as launches on each replay.  Each main path zeroes the
launch counters just before it and reads them just after.  The line
before the last is the kernels line, the last the result line.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import gc
import json
import logging
import math
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
B, K = 8, 4  # batch and top-k of the main path (POST / serves the top 4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores
# (H, W, Cin, Cout) of each 3x3 SAME conv of the VGG16 forward up to
# block5_conv1, the int8 tier's path; and fc1's (in, out)
Q8_CONV_SITES = ((224, 224, 3, 64), (224, 224, 64, 64), (112, 112, 64, 128), (112, 112, 128, 128),
                 (56, 56, 128, 256), (56, 56, 256, 256), (56, 56, 256, 256), (28, 28, 256, 512),
                 (28, 28, 512, 512), (28, 28, 512, 512), (14, 14, 512, 512))
Q8_DENSE_SITE = (25088, 4096)
# (H, W, C) entering each forward pool of a block5_conv1 request
POOL_SITES = ((224, 224, 64), (112, 112, 128), (56, 56, 256), (28, 28, 512))
# (pooled ho, wo, Cout) -> Cin of the conv the fused kernel projects through
FUSED_SITES = ((14, 14, 512, 512), (28, 28, 256, 256), (56, 56, 128, 128), (112, 112, 64, 64))
# the packed sites of /v1/deconv at its defaults (top_k 8, so 8 groups):
# block1 (packed under lowc_kpack=auto, the main path) and block2 (forced)
KG = 8
V1_LAYER, V1_SWEEP_FROM = "block5_conv1", "block3_conv1"  # the /v1/deconv requests
PACKED_SITES = {"pool1_auto": (112, 112, 64, 64), "pool2_forced": (56, 56, 128, 128)}


def emit(obj) -> None:
    # numpy scalars (np.bool_ is no bool) as their Python values
    print(json.dumps(obj, default=lambda v: v.item()), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` after
    ``warmup`` calls: the device's time from the call's start to its last
    kernel's end, so the host's work before each launch counts too."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in a CUDA
    graph, the median of ``reps`` replays by CUDA events over ``n``.  No
    host work between the launches, so a kernel shorter than its wrapper's
    host time is timed by itself (``time_ms`` counts that host time)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def cold_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``, each
    queued behind a write of L2_FLUSH_BYTES.  The write evicts the L2, so
    the call reads its inputs from device memory as the byte bound counts
    them, and it runs while the host queues the call, so the host's work
    counts only where it outlasts the write (some 0.1 ms).  Outputs may
    still sit in the L2 when the call ends."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, reps: int = 50) -> float:
    """Host time per call of ``fn`` while its launches queue: what the
    wrapper costs the CPU, beside what its kernel costs the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def kernel_times(kernel, plain, library) -> dict:
    """A byte-bound kernel's single-call time beside its plain version's
    and its library call's (``time_ms``, the method of the earlier slices'
    tables), the kernel's and the library call's time with the L2 evicted
    (``cold_ms``), and their host time per call."""
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library),
            "cold_ms": cold_ms(kernel), "library_cold_ms": cold_ms(library),
            "host_us": host_us(kernel), "library_host_us": host_us(library)}


def png_bytes(img) -> bytes:
    """uint8 (H, W, 3) RGB -> PNG, filter 0, no ancillary chunks."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# --- phase 1 -------------------------------------------------------------------


def phase_environment(torch) -> dict:
    from deconv_api_tpu_torch._device import resolve_device, tf32_flags
    from deconv_api_tpu_torch.ops import _build
    from deconv_api_tpu_torch.serving import codec

    resolve_device("cuda")
    nvcc_out = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True, check=True).stdout
    release = next((l.strip() for l in nvcc_out.splitlines() if "release" in l), nvcc_out.strip())
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    env = {
        "phase": "environment",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": release,
        "triton": triton_version,
        "tf32": tf32_flags(),
        "codec_backend": codec.backend(),
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    }
    emit(env)
    return env


# --- phase 2 -------------------------------------------------------------------


def phase_build() -> None:
    from deconv_api_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    wall = time.perf_counter() - t0
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    ptxas = {name: ptxas_usage(log, filt) for name, log in _build.build_logs.items()}
    emit({"phase": "build", "wall_s": wall, "per_kernel_s": seconds, "ptxas": ptxas})


def ptxas_usage(log: str, filt: str) -> dict:
    """Registers and spill bytes of each kernel instantiation in an
    ``nvcc -Xptxas=-v`` log, by name as the demangler ``filt`` gives it
    where it exists."""
    import re

    usage, fn = {}, None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage.setdefault(fn, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            usage.setdefault(fn, {})["registers"] = int(m.group(1))
    if usage and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(usage), capture_output=True, text=True).stdout.split("\n")
        if len(names) >= len(usage):
            usage = {name: v for name, v in zip(names, usage.values())}
    return usage


# --- phase 3 -------------------------------------------------------------------


def phase_kernels(torch) -> dict:
    """Each kernel vs its plain version; returns the kernels-line fields."""
    import torch.nn.functional as F

    from deconv_api_tpu_torch.ops import conv, cuda_deconv, cuda_pool, pool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # K1: every forward pool, fp32 on the main path; bf16 checked too
    ties_values = torch.tensor([-0.0, 0.0, 1.0], device=dev)
    pool_sites = []
    for h, w, c in POOL_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for ties in (False, True):
                if ties:  # all-equal windows, +0 against -0
                    x = ties_values[torch.randint(0, 3, (B, h, w, c), generator=gen, device=dev)]
                else:
                    x = torch.randn((B, h, w, c), generator=gen, device=dev)
                x = x.to(dtype)
                got, want = cuda_pool.pool_argmax(x), pool.maxpool_argmax_plain(x)
                # bit for bit: both keep the first maximum's own bits
                if not (torch.equal(bits(torch, got[0]), bits(torch, want[0])) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"pool_argmax differs from plain at {(B, h, w, c)} {dtype} ties={ties}")
        x = torch.randn((B, h, w, c), generator=gen, device=dev)
        xn = x.permute(0, 3, 1, 2)
        pool_sites.append(byte_bound({
            "site": [B, h, w, c], "plan": cuda_pool.pool_plan(x.shape, 4, (2, 2), x.data_ptr()).__dict__,
            **kernel_times(lambda: cuda_pool.pool_argmax(x), lambda: pool.maxpool_argmax_plain(x),
                           lambda: F.max_pool2d(xn, 2, return_indices=True)),
            "bytes": x.numel() * 4 + x.numel() // 4 * (4 + 1),
        }))
    rows["pool_argmax"] = summed_row(pool_sites, "deconv_api_tpu_torch/csrc/pool_argmax.cu",
                                     "deconv_api_tpu/ops/pallas_pool.py:74")

    # K2: every unpool+ReLU of the backward when fusion is off, bf16; fp32,
    # the ReLU off and an odd extent checked too, bit for bit (-0.0 included)
    unpool_sites = []
    for ho, wo, c, _ in FUSED_SITES:
        idx = torch.randint(0, 4, (B, ho, wo, c), generator=gen, device=dev, dtype=torch.int8)
        for dtype in (torch.float32, torch.bfloat16):
            y = torch.randn((B * K, ho, wo, c), generator=gen, device=dev).to(dtype)
            for relu in (False, True):
                for out_hw in (None, (2 * ho + 1, 2 * wo + 1)):
                    got = cuda_pool.unpool_argmax(y, idx, (2, 2), out_hw, relu)
                    want = pool.unpool_argmax_plain(y, idx, (2, 2), out_hw, relu)
                    if not torch.equal(bits(torch, got), bits(torch, want)):
                        raise AssertionError(f"unpool_argmax differs from plain at {tuple(y.shape)} {dtype} "
                                             f"relu={relu} out_hw={out_hw}")
        # the library's unpool on the same switches gives the same values
        ind = nchw_switch_indices(torch, idx, K, 1)
        yn = y.permute(0, 3, 1, 2)
        if not torch.equal(F.max_unpool2d(yn, ind, 2).permute(0, 2, 3, 1), cuda_pool.unpool_argmax(y, idx)):
            raise AssertionError(f"F.max_unpool2d's indices do not match the switches at {tuple(y.shape)}")
        unpool_sites.append(byte_bound({
            "site": [B * K, ho, wo, c],
            "plan": cuda_pool.unpool_plan(y.shape, c, 2, (2, 2), (2 * ho, 2 * wo), y.data_ptr(), idx.data_ptr()).__dict__,
            **kernel_times(lambda: cuda_pool.unpool_argmax(y, idx, (2, 2), None, True),
                           lambda: pool.unpool_argmax_plain(y, idx, (2, 2), None, True),
                           lambda: F.max_unpool2d(yn, ind, 2)),
            "bytes": y.numel() * 2 + idx.numel() + y.numel() * 4 * 2,
        }))
        del ind, yn
    rows["unpool_argmax"] = summed_row(unpool_sites, "deconv_api_tpu_torch/csrc/unpool_argmax.cu",
                                       "deconv_api_tpu/ops/pallas_pool.py:105")
    emit({"phase": "kernels", "pool_argmax_sites": pool_sites, "unpool_argmax_sites": unpool_sites})

    # K3: every pool -> ReLU -> conv step of the backward, bf16; fp32 checked
    # and timed too (fp32 runs the CUDA-core kernel, bf16 the tensor cores)
    err, ms, plain, lib, unfused, flops, nbytes, fp32_ms = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0.0
    fp32_lib, fp32_bytes, dense = 0.0, 0, 0
    checks, per_site = [], []
    for ho, wo, cout, cin in FUSED_SITES:
        idx = torch.randint(0, 4, (B, ho, wo, cout), generator=gen, device=dev, dtype=torch.int8)
        y32 = torch.randn((B * K, ho, wo, cout), generator=gen, device=dev)
        w32 = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (2.0 / (9 * cout)) ** 0.5
        # the work these inputs need (bf16 rounding keeps every sign)
        site_flops = k3_flops(torch, y32, idx, cin)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)):
            y, w = y32.to(dtype), w32.to(dtype)
            got = cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), True).float()
            want = cuda_deconv.fused_plain(y, idx, w, (2, 2), True).float()
            e = float((got - want).abs().max())
            rel = e / float(want.abs().max())
            checks.append({"site": [B * K, ho, wo, cout, cin], "dtype": str(dtype), "max_abs_err": e, "rel_err": rel, "tol": tol})
            if not rel <= tol:
                raise AssertionError(f"fused_unpool_conv off by {rel:.3g} (tol {tol}) at {checks[-1]}")
            if dtype == torch.bfloat16:
                err = max(err, e)
        site_fp32_ms = time_ms(lambda: cuda_deconv.fused_unpool_conv(y32, idx, w32, (2, 2), True), reps=5)
        # fp32's library: K2 and F.conv2d in fp32, TF32 off (the fp32 path's
        # numbers, not the tensor cores' at a lower precision)
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            fp32_lib += time_ms(lambda: conv.conv2d_input_backward(
                cuda_pool.unpool_argmax(y32, idx, (2, 2), None, True), w32), reps=5)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        y, w = y32.to(torch.bfloat16), w32.to(torch.bfloat16)
        site_ms = time_ms(lambda: cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), True))
        # the library: ReLU, F.max_unpool2d and F.conv2d in NCHW; the port's
        # unfused pair: K2 and F.conv2d (what fused_unpool=off runs)
        ind, yn = nchw_switch_indices(torch, idx, K, 1), y.permute(0, 3, 1, 2)
        wt = conv.flip_kernel(w).permute(3, 2, 0, 1).contiguous()
        site_lib = time_ms(lambda: F.conv2d(F.max_unpool2d(F.relu(yn), ind, 2), wt, padding=1))
        site_unfused = time_ms(lambda: conv.conv2d_input_backward(cuda_pool.unpool_argmax(y, idx, (2, 2), None, True), w))
        plain += time_ms(lambda: cuda_deconv.fused_plain(y, idx, w, (2, 2), True))
        del ind, yn
        m = B * K * ho * 2 * wo * 2
        plan = cuda_deconv.tile_plan(B * K, 2 * ho, 2 * wo, 1, cin, cout, 3, 3)
        per_site.append(k3_site([B * K, ho, wo, cout, cin], plan, site_ms, site_lib, site_unfused,
                                site_flops, y.numel() * 2 + idx.numel() + w.numel() * 2 + m * cin * 2,
                                site_fp32_ms, dense_flops=2 * m * cin * 9 * cout))
        ms, lib, unfused, fp32_ms = ms + site_ms, lib + site_lib, unfused + site_unfused, fp32_ms + site_fp32_ms
        flops += per_site[-1]["flops"]
        dense += per_site[-1]["dense_flops"]
        nbytes += per_site[-1]["bytes"]
        fp32_bytes += y32.numel() * 4 + idx.numel() + w32.numel() * 4 + m * cin * 4
    emit({"phase": "kernels", "fused_unpool_conv_checks": checks, "fused_unpool_conv_sites": per_site})
    bound_s = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    rows["fused_unpool_conv"] = {
        "source": "deconv_api_tpu_torch/csrc/fused_unpool_conv.cu",
        "replaces": "deconv_api_tpu/ops/pallas_deconv.py:270",
        "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound_s * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": lib, "library": "F.relu + F.max_unpool2d + F.conv2d (NCHW)",
        "unfused_ms": unfused,
        "flops": flops, "dense_flops": dense, "tflops": flops / ms / 1e9, "dense_tflops": dense / ms / 1e9,
        "bound_share": bound_s * 1e3 / ms, "fp32_ms": fp32_ms,
        "fp32_bound_ms": max(flops / FP32_FLOPS, fp32_bytes / HBM_BYTES_PER_S) * 1e3,
        "fp32_bound_by": "operations" if flops / FP32_FLOPS >= fp32_bytes / HBM_BYTES_PER_S else "bytes",
        "fp32_bound_share": max(flops / FP32_FLOPS, fp32_bytes / HBM_BYTES_PER_S) * 1e3 / fp32_ms,
        "fp32_library_ms": fp32_lib, "fp32_library": "K2 + F.conv2d fp32 (TF32 off)",
    }
    rows.update(grouped_kernels(torch, gen))
    rows.update(q8_kernels(torch, gen))
    emit({"phase": "kernels", "checked": sorted(rows),
          "exact": ["pool_argmax", "unpool_argmax", "unpool_argmax_grouped", "conv_q8", "quantize_q8",
                    "quantize_w_q8"], "per_kernel": rows})
    return rows


def grouped_kernels(torch, gen) -> dict:
    """K2 and K3 in their grouped (channel-packed) form at the packed sites
    of ``/v1/deconv``: B rows of KG groups, switch rep 1.  Each row's
    numbers are those of the block1 site, which ``lowc_kpack=auto`` packs;
    the block2 site (``forced``) is checked and timed beside it."""
    import torch.nn.functional as F

    from deconv_api_tpu_torch.ops import conv, cuda_deconv, cuda_pool, pool

    dev = torch.device("cuda")
    rows, sites, checks = {}, {}, []
    for site, (ho, wo, cout, cin) in PACKED_SITES.items():
        idx = torch.randint(0, 4, (B, ho, wo, cout), generator=gen, device=dev, dtype=torch.int8)
        y32 = torch.randn((B, ho, wo, KG * cout), generator=gen, device=dev)
        w32 = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (2.0 / (9 * cout)) ** 0.5
        # K2 grouped: bit for bit (-0.0 included), both dtypes, ReLU on and off, odd extent
        for dtype in (torch.float32, torch.bfloat16):
            y = y32.to(dtype)
            for relu in (False, True):
                for out_hw in (None, (2 * ho + 1, 2 * wo + 1)):
                    got = cuda_pool.unpool_argmax(y, idx, (2, 2), out_hw, relu, KG)
                    want = pool.unpool_argmax_plain(y, idx, (2, 2), out_hw, relu, KG)
                    if not torch.equal(bits(torch, got), bits(torch, want)):
                        raise AssertionError(f"unpool_argmax grouped differs from plain at {site} {dtype} "
                                             f"relu={relu} out_hw={out_hw}")
                    del got, want
        # K3 grouped against the grouped pair
        err = 0.0
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)):
            y, w = y32.to(dtype), w32.to(dtype)
            got = cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), True, KG).float()
            want = cuda_deconv.fused_plain(y, idx, w, (2, 2), True, KG).float()
            e = float((got - want).abs().max())
            rel = e / float(want.abs().max())
            checks.append({"site": site, "y": list(y.shape), "dtype": str(dtype), "max_abs_err": e,
                           "rel_err": rel, "tol": tol})
            if not rel <= tol:
                raise AssertionError(f"fused_unpool_conv grouped off by {rel:.3g} (tol {tol}) at {checks[-1]}")
            if dtype == torch.bfloat16:
                err = e
            del got, want
        y, w = y32.to(torch.bfloat16), w32.to(torch.bfloat16)
        del y32
        # the library's unpool: F.max_unpool2d with the switches repeated to
        # KG blocks as int64 flat indices of each output plane
        ind = nchw_switch_indices(torch, idx, 1, KG)
        yn = y.permute(0, 3, 1, 2).contiguous()
        if not torch.equal(F.max_unpool2d(yn, ind, 2).permute(0, 2, 3, 1), cuda_pool.unpool_argmax(y, idx, groups=KG)):
            raise AssertionError(f"F.max_unpool2d's indices do not match the switches at {site}")
        wt = conv.tile_kernel_groups(conv.flip_kernel(w), KG).permute(3, 2, 0, 1).contiguous()
        m = B * 2 * ho * 2 * wo * KG
        sites[site] = {
            "unpool_argmax_grouped": byte_bound({
                "plan": cuda_pool.unpool_plan(y.shape, cout, 2, (2, 2), (2 * ho, 2 * wo), y.data_ptr(), idx.data_ptr()).__dict__,
                **kernel_times(lambda: cuda_pool.unpool_argmax(y, idx, (2, 2), None, True, KG),
                               lambda: pool.unpool_argmax_plain(y, idx, (2, 2), None, True, KG),
                               lambda: F.max_unpool2d(yn, ind, 2)),
                "bytes": y.numel() * 2 + idx.numel() + y.numel() * 4 * 2,
            }),
            "fused_unpool_conv_grouped": {
                "ms": time_ms(lambda: cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), True, KG), reps=10),
                "plain_ms": time_ms(lambda: cuda_deconv.fused_plain(y, idx, w, (2, 2), True, KG), reps=10),
                "library_ms": time_ms(lambda: F.conv2d(F.max_unpool2d(F.relu(yn), ind, 2), wt, padding=1,
                                                       groups=KG), reps=10),
                "unfused_ms": time_ms(lambda: conv.conv2d_input_backward_grouped(
                    cuda_pool.unpool_argmax(y, idx, (2, 2), None, True, KG), w, KG), reps=10),
                "flops": k3_flops(torch, y, idx, cin, KG),
                "dense_flops": 2 * m * cin * 9 * cout,
                "bytes": y.numel() * 2 + idx.numel() + w.numel() * 2 + m * cin * 2,
                "max_abs_err": err,
            },
        }
        k3 = sites[site]["fused_unpool_conv_grouped"]
        k3.update(k3_site(site, cuda_deconv.tile_plan(B, 2 * ho, 2 * wo, KG, cin, cout, 3, 3),
                          k3["ms"], k3["library_ms"], k3["unfused_ms"], k3["flops"], k3["bytes"],
                          dense_flops=k3["dense_flops"]))
        del ind, yn
    emit({"phase": "kernels", "grouped_sites": sites, "fused_unpool_conv_grouped_checks": checks})
    main = sites["pool1_auto"]
    k2, k3 = main["unpool_argmax_grouped"], main["fused_unpool_conv_grouped"]
    rows["unpool_argmax_grouped"] = {
        **summed_row([k2], "deconv_api_tpu_torch/csrc/unpool_argmax.cu", "deconv_api_tpu/ops/pallas_pool.py:105"),
        "library": "F.max_unpool2d on the switches repeated to 8 groups (int64 indices)",
    }
    t_ops, t_bytes = k3["flops"] / BF16_FLOPS, k3["bytes"] / HBM_BYTES_PER_S
    rows["fused_unpool_conv_grouped"] = {
        "source": "deconv_api_tpu_torch/csrc/fused_unpool_conv.cu",
        "replaces": "deconv_api_tpu/ops/pallas_deconv.py:270",
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": k3["library_ms"],
        "library": "F.relu + F.max_unpool2d + F.conv2d(groups=8) (NCHW)",
        "unfused_ms": k3["unfused_ms"],
        "flops": k3["flops"], "dense_flops": k3["dense_flops"], "tflops": k3["tflops"],
        "dense_tflops": k3["dense_tflops"], "bound_share": k3["bound_share"],
    }
    return rows


def im2col_q8(torch, x, kh: int, kw: int):
    """int8 NHWC ``x`` -> its (N*H*W, kh*kw*C) im2col rows for a stride-1
    SAME conv, in the HWIO reduction order: what ``torch._int_mm`` takes."""
    import torch.nn.functional as F

    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    return torch.cat([xp[:, i:i + h, j:j + w, :] for i in range(kh) for j in range(kw)], dim=-1).reshape(
        n * h * w, kh * kw * c)


def q8_kernels(torch, gen) -> dict:
    """K5, the int8 layer step, at every conv of the int8 forward up to
    block5_conv1 and at fc1, bit for bit against its plain versions on the
    same card tensors: the input quantizer (``quantize_q8``), the weight
    quantizer (``quantize_w_q8``, K-major), the contraction as the raw int32
    accumulator (``plain``: the float64 contraction) and as the fused step
    (bias fold, relu, dequantize; ``plain``: the op-by-op finish on the
    float64 contraction), plus two strided geometries and a ragged width.
    Per site: single-call times by CUDA events of each entry and of the
    whole step (``ms``, the method of the earlier slices, host time of the
    wrapper included), their device times by CUDA-graph replay
    (``device_ms``, ``graph_ms``), the plain versions', ``torch._int_mm``
    on the im2col'd operands (the GEMM alone, where its shape rules allow:
    more than 16 rows, a reduction and width in multiples of 8), and each
    entry's bound: bytes (each input read once, each output written once)
    or operations at the int8 tensor-core rate, whichever takes longer.
    Returns the kernels-line rows of the three entries."""
    from deconv_api_tpu_torch.ops import conv, cuda_q8, linear, q8

    dev = torch.device("cuda")

    def step_inputs(shape, kernel):
        """Float input (row 1 zero: amax 0, scale 1.0) and its scales, a
        He-normal float kernel (HWIO or (in, out)) and its scale, a float
        bias."""
        x = torch.randn(shape, generator=gen, device=dev) * 3
        x[1] = 0
        fan_in = kernel[0] * kernel[1] * kernel[2] if len(kernel) == 4 else kernel[0]
        wf = torch.randn(kernel, generator=gen, device=dev) * (2.0 / fan_in) ** 0.5
        sw = q8.q8_scale(q8.row_amax(wf.reshape(1, -1))[0])
        b = torch.randn((kernel[-1],), generator=gen, device=dev) * 0.1
        return x, q8.q8_scale(q8.row_amax(x)), wf, sw, b

    def check(what, got, want):
        if got.dtype == torch.float32:
            got, want = bits(torch, got), bits(torch, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs from its plain version")

    def site_row(name, x, sx, wf, sw, b, contract, contract_plain, fused, lib=None):
        """One site: every entry checked, then timed."""
        xq, wq = cuda_q8.quantize_rows(x, sx), cuda_q8.quantize_weight(wf, sw)
        scale = sx * sw
        check(f"quantize_q8 at {name}", xq, q8.quantize_rows_plain(x, sx))
        check(f"quantize_w_q8 at {name}", wq, q8.quantize_weight_plain(wf, sw))
        raw = contract(xq, wq)
        check(f"conv_q8 (raw) at {name}", raw, contract_plain(xq, wq))
        y = fused(xq, wq, b, scale)
        plain_fused = lambda: q8.finish_plain(contract_plain(xq, wq), scale, b, "relu")
        check(f"conv_q8 (fused) at {name}", y, plain_fused())
        step = (q8.dense_q8_step if x.dim() == 2 else q8.conv2d_q8_step)
        step_plain = (q8.dense_q8_step_plain if x.dim() == 2 else q8.conv2d_q8_step_plain)
        check(f"the int8 step at {name}", step(x, sx, wq, sw, b, "relu"), step_plain(x, sx, wq, sw, b, "relu"))
        ops_ = 2 * raw.numel() * wq[0].numel()
        site = {
            "site": name, "ms": time_ms(lambda: fused(xq, wq, b, scale)), "raw_ms": time_ms(lambda: contract(xq, wq)),
            "device_ms": graph_ms(lambda: fused(xq, wq, b, scale)),
            "raw_device_ms": graph_ms(lambda: contract(xq, wq)),
            "quantize_device_ms": graph_ms(lambda: cuda_q8.quantize_rows(x, sx)),
            "quantize_w_device_ms": graph_ms(lambda: cuda_q8.quantize_weight(wf, sw)),
            "step_device_ms": graph_ms(lambda: step(x, sx, wq, sw, b, "relu")),
            "plain_ms": time_ms(plain_fused, reps=3, warmup=1),
            "raw_plain_ms": time_ms(lambda: contract_plain(xq, wq), reps=3, warmup=1),
            "quantize_ms": time_ms(lambda: cuda_q8.quantize_rows(x, sx)),
            "quantize_plain_ms": time_ms(lambda: q8.quantize_rows_plain(x, sx)),
            "quantize_w_ms": time_ms(lambda: cuda_q8.quantize_weight(wf, sw)),
            "quantize_w_plain_ms": time_ms(lambda: q8.quantize_weight_plain(wf, sw)),
            "step_ms": time_ms(lambda: step(x, sx, wq, sw, b, "relu")),
            "step_plain_ms": time_ms(lambda: step_plain(x, sx, wq, sw, b, "relu"), reps=3, warmup=1),
            "ops": ops_,
            "bytes": xq.numel() + wq.numel() + (b.numel() + scale.numel()) * 4 + y.numel() * 4,
            "raw_bytes": xq.numel() + wq.numel() + raw.numel() * 4,
            "quantize_bytes": x.numel() * 5 + sx.numel() * 4,
            "quantize_w_bytes": wf.numel() * 5 + 4,
            "library_ms": None,
        }
        if lib is not None:
            a, bm = lib(xq, wq)
            if not torch.equal(torch._int_mm(a, bm).reshape(raw.shape), raw):
                raise AssertionError(f"torch._int_mm differs from conv_q8 at {name}")
            site["library_ms"] = time_ms(lambda: torch._int_mm(a, bm))
            del a, bm
        for key, nbytes, nops in (("bound_ms", site["bytes"], ops_), ("raw_bound_ms", site["raw_bytes"], ops_),
                                  ("quantize_bound_ms", site["quantize_bytes"], 0),
                                  ("quantize_w_bound_ms", site["quantize_w_bytes"], 0)):
            site[key] = max(nops / INT8_OPS, nbytes / HBM_BYTES_PER_S) * 1e3
        site["bound_share"] = site["bound_ms"] / site["ms"]
        site["device_bound_share"] = site["bound_ms"] / site["device_ms"]
        site["raw_bound_share"] = site["raw_bound_ms"] / site["raw_device_ms"]
        site["quantize_bound_share"] = site["quantize_bound_ms"] / site["quantize_device_ms"]
        site["tops"] = ops_ / site["device_ms"] / 1e9
        return site

    def conv_plain(xq, wq, **geo):
        return conv.conv2d_q8_plain(xq, wq.permute(1, 2, 3, 0), **geo)

    def im2col_lib(xq, wq):
        return im2col_q8(torch, xq, 3, 3), wq.permute(1, 2, 3, 0).reshape(-1, wq.shape[0])

    def relu_fused(xq, wq, b, scale):
        return cuda_q8.conv2d_q8_fused(xq, wq, b, scale, relu=True)

    sites = []
    for h, w, cin, cout in Q8_CONV_SITES:
        x, sx, wf, sw, b = step_inputs((B, h, w, cin), (3, 3, cin, cout))
        lib = im2col_lib if 9 * cin % 8 == 0 and cout % 8 == 0 else None  # not a reduction of 27
        sites.append(site_row([B, h, w, cin, cout], x, sx, wf, sw, b, cuda_q8.conv2d_q8_kmajor, conv_plain,
                              relu_fused, lib))
        del x, wf
    din, dout = Q8_DENSE_SITE
    x, sx, wf, sw, b = step_inputs((B, din), (din, dout))
    dense = site_row([B, din, dout], x, sx, wf, sw, b, cuda_q8.dense_q8_kmajor,
                     lambda xq, wq: linear.dense_q8_plain(xq, wq.T),
                     lambda xq, wq, b, scale: cuda_q8.dense_q8_fused(xq, wq, b, scale, relu=True))
    del x, wf
    # strided and VALID geometries and ragged widths (not on the path)
    for (n, h, w, cin, cout), strides, padding in (((2, 15, 17, 16, 40), (2, 2), "SAME"),
                                                   ((3, 9, 8, 5, 24), (1, 2), "VALID"),
                                                   ((3, 9, 11, 32, 70), (1, 1), "SAME")):
        x, sx, wf, sw, b = step_inputs((n, h, w, cin), (3, 3, cin, cout))
        wq = cuda_q8.quantize_weight(wf, sw)
        xq = cuda_q8.quantize_rows(x, sx)
        check(f"conv_q8 (raw) at {(n, h, w, cin, cout)} {strides} {padding}",
              cuda_q8.conv2d_q8_kmajor(xq, wq, strides=strides, padding=padding),
              conv_plain(xq, wq, strides=strides, padding=padding))
        for act in ("relu", "linear", "relu6"):
            check(f"the int8 step at {(n, h, w, cin, cout)} {strides} {padding} {act}",
                  q8.conv2d_q8_step(x, sx, wq, sw, b, act, strides, padding),
                  q8.conv2d_q8_step_plain(x, sx, wq, sw, b, act, strides, padding))
    emit({"phase": "kernels", "conv_q8_sites": sites, "dense_q8_site": dense})

    def total(key):
        return sum(s[key] for s in sites)

    ops_, nbytes = total("ops"), total("bytes")
    lib = [s for s in sites if s["library_ms"] is not None]
    replaces = "none (XLA's conv2d_q8, deconv_api_tpu/ops/conv.py:55, dense_q8, ops/linear.py:27, and " \
               "the int8 step around them, deconv_api_tpu/engine/deconv.py:69)"
    return {
        "conv_q8": {
            "source": "deconv_api_tpu_torch/csrc/conv_q8.cu", "replaces": replaces,
            "max_abs_err": 0.0, "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_ / INT8_OPS >= nbytes / HBM_BYTES_PER_S else "bytes",
            # summed over the sites _int_mm takes; the raw contraction's time on the same sites beside it
            "library_ms": sum(s["library_ms"] for s in lib),
            "library": f"torch._int_mm on the im2col'd operands, the GEMM alone, {len(lib)} of {len(sites)} convs",
            "raw_ms_on_library_sites": sum(s["raw_ms"] for s in lib),
            "device_ms": total("device_ms"), "device_bound_share": total("bound_ms") / total("device_ms"),
            "raw_ms": total("raw_ms"), "raw_device_ms": total("raw_device_ms"), "raw_plain_ms": total("raw_plain_ms"),
            "raw_bound_ms": total("raw_bound_ms"), "raw_bound_share": total("raw_bound_ms") / total("raw_device_ms"),
            "step_ms": total("step_ms"), "step_device_ms": total("step_device_ms"),
            "step_plain_ms": total("step_plain_ms"),
            "tops": ops_ / total("device_ms") / 1e9, "bound_share": total("bound_ms") / total("ms"),
            "gmac_per_image": ops_ / 2 / B / 1e9,
            "fc1_ms": dense["ms"], "fc1_device_ms": dense["device_ms"], "fc1_raw_ms": dense["raw_ms"],
            "fc1_plain_ms": dense["plain_ms"], "fc1_bound_ms": dense["bound_ms"],
        },
        "quantize_q8": {
            "source": "deconv_api_tpu_torch/csrc/conv_q8.cu (quantize_rows_q8)", "replaces": replaces,
            "max_abs_err": 0.0, "ms": total("quantize_ms"), "plain_ms": total("quantize_plain_ms"),
            "bound_ms": total("quantize_bound_ms"), "bound_by": "bytes", "library_ms": None,
            "device_ms": total("quantize_device_ms"),
            "device_bound_share": total("quantize_bound_ms") / total("quantize_device_ms"),
            "fc1_ms": dense["quantize_ms"],
        },
        "quantize_w_q8": {
            "source": "deconv_api_tpu_torch/csrc/conv_q8.cu (quantize_t_q8)", "replaces": replaces,
            "max_abs_err": 0.0, "ms": total("quantize_w_ms"), "plain_ms": total("quantize_w_plain_ms"),
            "bound_ms": total("quantize_w_bound_ms"), "bound_by": "bytes", "library_ms": None,
            "device_ms": total("quantize_w_device_ms"),
            "device_bound_share": total("quantize_w_bound_ms") / total("quantize_w_device_ms"),
            "fc1_ms": dense["quantize_w_ms"], "fc1_device_ms": dense["quantize_w_device_ms"],
            "fc1_bound_ms": dense["quantize_w_bound_ms"],
        },
    }


def k3_flops(torch, y, idx, cin: int, groups: int = 1) -> int:
    """Twice the multiply-adds that K3's function needs on these inputs,
    the count its bound takes: each positive value of ``y`` (the ReLU
    zeroes the rest), unpooled to its switch's slot (one slot of each 2x2
    window), reaches the outputs of the 3x3 around that slot that lie
    inside the map, each for ``cin`` channels.  The dense count over the
    unpooled map, ``2 * rows * 4 * ho * wo * cout * 9 * cin``, is about 8x
    this on random inputs."""
    n, ho, wo, _ = y.shape
    s = idx.repeat_interleave(n // idx.shape[0], dim=0).repeat(1, 1, 1, groups).long()
    r = 2 * torch.arange(ho, device=y.device)[None, :, None, None] + s // 2
    c = 2 * torch.arange(wo, device=y.device)[None, None, :, None] + s % 2
    taps = (3 - (r == 0).long() - (r == 2 * ho - 1).long()) * (3 - (c == 0).long() - (c == 2 * wo - 1).long())
    return 2 * cin * int((taps * (y > 0)).sum())


def k3_site(site, plan, ms, lib_ms, unfused_ms, flops, nbytes, fp32_ms=None, dense_flops=None) -> dict:
    """One K3 site's bf16 time beside its achieved rate on the work it
    needs (``flops``, from ``k3_flops``) and on the dense tiles it runs
    (``dense_flops``), its share of the bound, the tensor-core kernel's
    launch plan, the library's time and the port's unfused pair's."""
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    out = {"site": site, "plan": plan.__dict__, "ms": ms, "library_ms": lib_ms, "unfused_ms": unfused_ms,
           "flops": flops, "dense_flops": dense_flops, "bytes": nbytes, "tflops": flops / ms / 1e9,
           "dense_tflops": dense_flops / ms / 1e9, "bound_ms": bound_ms, "bound_share": bound_ms / ms}
    if fp32_ms is not None:
        out["fp32_ms"] = fp32_ms
    return out


def bits(torch, t):
    """A float tensor's bits as integers: torch.equal on them compares
    bits, so -0.0 and +0.0 differ."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def nchw_switch_indices(torch, idx, rep: int, groups: int):
    """The int64 flat index into each (2ho, 2wo) output plane that
    F.max_unpool2d takes, from int8 NHWC 2x2 switches: slot s of pooled
    pixel (i, j) is output pixel (2i + s // 2, 2j + s % 2).  Switch rows
    repeat ``rep`` times and channels ``groups`` times, as the kernels read
    them."""
    _, ho, wo, _ = idx.shape
    sw = idx.repeat_interleave(rep, 0).repeat(1, 1, 1, groups).permute(0, 3, 1, 2).long()
    rows_i = torch.arange(ho, device=idx.device)[:, None] * 2 + sw // 2
    return rows_i * (2 * wo) + torch.arange(wo, device=idx.device)[None, :] * 2 + sw % 2


def byte_bound(site: dict) -> dict:
    """A byte-bound kernel's site with its bound (each byte read or written
    once at the card's memory rate) and its share of it, by the single-call
    time and by the time with the L2 evicted."""
    site["bound_ms"] = site["bytes"] / HBM_BYTES_PER_S * 1e3
    site["bound_share"] = site["bound_ms"] / site["ms"]
    site["cold_bound_share"] = site["bound_ms"] / site["cold_ms"]
    return site


def summed_row(sites: list, source: str, replaces: str) -> dict:
    """The kernels-line row of a bit-exact, byte-bound kernel: its sites' times summed."""
    total = {k: sum(s[k] for s in sites) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "cold_ms",
                                                     "library_cold_ms", "host_us")}
    return {
        "source": source, "replaces": replaces, "max_abs_err": 0.0, **total, "bound_by": "bytes",
        "bound_share": total["bound_ms"] / total["ms"], "cold_bound_share": total["bound_ms"] / total["cold_ms"],
    }


def warmup_report(torch, service, reserved_before: int, bundle=None) -> dict:
    """What a server's warmup captured before ``/ready`` for ``bundle``
    (default: the default model's): its wall time, the programs of both
    caches, and the device memory reserved after it (in all, and more than
    ``reserved_before``, before the boot).
    Fails unless what the server's settings ask for was captured, as this
    smoke reads them (not from the service's own list): at the deepest
    layer in ``visualize_mode``, ``POST /``'s grid at ``stitch_k`` and
    ``/v1/deconv``'s tiles at ``top_k`` at every deconv bucket (only the
    first without ``warmup_all_buckets``); for the default model, with
    ``warmup_sweep`` the sweep at the first bucket, and with
    ``warmup_dream``, where it has dream layers, each rung of the default
    dream at every dream bucket (or the first)."""
    from deconv_api_tpu_torch.engine.deepdream import octave_shapes
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS, pool_bytes
    from deconv_api_tpu_torch.serving.batcher import buckets

    cfg = service.cfg
    bundle = bundle or service.bundle
    layer, size, mode = bundle.deepest_layer(), max(0, cfg.image_size) or bundle.image_size, cfg.visualize_mode
    is_default = bundle.name == service.weights.default
    sizes = buckets(service.max_batch)
    sizes = sizes if cfg.warmup_all_buckets else sizes[:1]
    # a deconv key: ("deconv", model, layer, mode, top_k, post, sweep, ..., bucket, shape[, dtype])
    deconv = {(*k[2:7], next(x for x in reversed(k) if isinstance(x, tuple))[0]) for k in bundle.programs.keys()}
    want = {(layer, mode, top_k, post, False, b) for b in sizes
            for top_k, post in ((cfg.stitch_k, "grid"), (cfg.top_k, "tiles"))}
    if cfg.warmup_sweep and is_default:
        want.add((layer, mode, cfg.top_k, "tiles", True, sizes[0]))
    dreams = {(k[1], k[2]) for k in bundle.dream_programs.keys() if k[0] == "step"}
    want_dreams = set()
    if cfg.warmup_dream and is_default and bundle.dream_layers:
        dream_sizes = buckets(cfg.dream_max_batch)
        want_dreams = {(hw, b) for hw in octave_shapes(size, size, DREAM_DEFAULTS["octaves"], 1.4,
                                                       bundle.min_dream_size)
                       for b in (dream_sizes if cfg.warmup_all_buckets else dream_sizes[:1])}
    graphs = [p for c in (bundle.programs, bundle.dream_programs) for p in c.programs().values()]
    out = {"model": bundle.name, "ready": service.ready, "warmup_wall_s": service.warmup_wall_s,
           "deconv_programs": len(bundle.programs), "dream_programs": len(bundle.dream_programs),
           "deconv_pool_bytes": pool_bytes(bundle.programs.pool),
           "dream_pool_bytes": pool_bytes(bundle.dream_programs.pool),
           "graphs": sum(p.graph is not None for p in graphs),
           "capture_s": sum(p.capture_s for p in graphs),
           "reserved_bytes": torch.cuda.memory_reserved(),
           "boot_reserved_bytes": torch.cuda.memory_reserved() - reserved_before,
           "allocated_bytes": torch.cuda.memory_allocated()}
    if not service.ready or not want <= deconv or not want_dreams <= dreams or out["graphs"] != len(graphs):
        raise AssertionError(f"warmup of {bundle.name}: missing {sorted(want - deconv)} "
                             f"{sorted(want_dreams - dreams)}; {out}")
    return out


# --- phase 4 -------------------------------------------------------------------


# The phases before ``cache`` measure device work: their servers (and the
# engine-level services) run without the response cache and singleflight,
# so that a repeated body is computed again and concurrent identical ones
# each take a row.  Each phase prints ``server_cache``.
CACHE_OFF_FLAGS = ["--cache-bytes", "0", "--no-singleflight"]
CACHE_OFF = {"cache_bytes": 0, "singleflight": False}


def cache_state(service) -> str:
    """``server_cache`` of a phase's output: off, or the cache's budget."""
    if service.cache is None and service.flights is None:
        return "off (cache_bytes=0, singleflight=False)"
    return f"on (cache_bytes={service.cfg.cache_bytes}, singleflight={service.cfg.singleflight})"


def _post(port: int, path: str, form: dict):
    data = urllib.parse.urlencode(form).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace"), time.perf_counter() - t0


def image_uris(n: int) -> list:
    """``n`` PNG data URLs of smooth random images at a size no model takes
    (256x240), so every request resizes."""
    import numpy as np

    rng = np.random.default_rng(1)
    imgs = []
    for _ in range(n):
        base = rng.integers(0, 256, (16, 15, 3)).astype(np.float64)
        img = np.kron(base, np.ones((16, 16, 1)))[:256, :240] + rng.normal(0, 12, (256, 240, 3))
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return ["data:image/png;base64," + base64.b64encode(png_bytes(i)).decode() for i in imgs]


def phase_main_path(torch) -> dict:
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.crosscheck import psnr_db
    from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT
    from deconv_api_tpu_torch.serving import codec

    # what `python -m deconv_api_tpu_torch serve ...` runs, on a free port
    torch.cuda.empty_cache()  # the boot's reserved bytes, not an earlier phase's cached ones
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda",
                           "--max-batch", str(B), *CACHE_OFF_FLAGS])
    warm_s = time.perf_counter() - t0
    service, bundle, port = server.service, server.service.bundle, server.server_address[1]
    warm = warmup_report(torch, service, reserved0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=10) as r:
            assert json.loads(r.read()) == {"ready": True}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health-check", timeout=10) as r:
            assert json.loads(r.read()) == {"healthy": "true"}

        uris = image_uris(B + 2)
        layers = ["block5_conv1"] * B + ["block3_conv3", "fc1"]

        ops.reset_launch_counts()
        service.batch_sizes.clear()
        results = [None] * len(uris)

        def run(i):
            results[i] = _post(port, "/", {"file": uris[i], "layer": layers[i]})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(uris))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        responses = []
        for (status, body, secs), layer in zip(results, layers):
            ok = status == 200 and isinstance(body, str) and body.startswith("data:image/webp;base64,")
            if not ok:
                raise AssertionError(f"POST / {layer}: {status} {str(body)[:300]}")
            raw = base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1]))
            size = codec.jpeg_size(raw)
            if size != (448, 448):
                raise AssertionError(f"POST / {layer}: grid {size}, expected 448x448")
            if codec.backend() == "cv2":
                import cv2

                dec = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
                assert dec is not None and dec.shape == (448, 448, 3), "grid does not decode"
            responses.append({"layer": layer, "status": status, "seconds": secs, "jpeg_hw": list(size)})
        batch_sizes = list(service.batch_sizes)

        # the same block5_conv1 batch at the other fused_unpool setting, so
        # that both K3 (auto) and K2 + F.conv2d (off) run; the grids must agree
        xs = np.stack([service.decode_preprocess(u) for u in uris[:B]])
        other = "off" if FUSED_DEFAULT == "auto" else "auto"
        grids = {FUSED_DEFAULT: service.visualize_batch("block5_conv1", xs),
                 other: service.visualize_batch("block5_conv1", xs, fused_unpool=other)}
        fused, unfused = grids["auto"], grids["off"]
        torch.cuda.synchronize()
        counts, graph_counts = ops.launch_counts(), dict(ops.graph_counts)

        psnr = min(psnr_db(a, b) for a, b in zip(fused["grid"], unfused["grid"]))
        same_idx = bool((fused["indices"] == unfused["indices"]).all())
        out = {
            "phase": "main_path", "model": "vgg16", "server_cache": cache_state(service), "boot_s": warm_s,
            "warmup": warm,
            "fused_unpool": FUSED_DEFAULT, "responses": responses, "batch_sizes": batch_sizes,
            "launches": counts, "graph_counts": graph_counts,
            "fused_vs_off_min_psnr_db": psnr if np.isfinite(psnr) else "identical",
            "fused_vs_off_indices_equal": same_idx,
            "grid_finite_uint8": fused["grid"].dtype == np.uint8 and fused["grid"].shape == (B, 448, 448, 3),
        }
        emit(out)
        if not all(counts[k] > 0 for k in ("pool_argmax", "unpool_argmax", "fused_unpool_conv")):
            raise AssertionError(f"a kernel of the path never launched: {counts}")
        if max(batch_sizes) <= 1:
            raise AssertionError(f"no batch held more than one image: {batch_sizes}")
        if graph_counts["replays"] < len(batch_sizes) + 2:
            raise AssertionError(f"the requests did not replay captured programs: {graph_counts}")
        if psnr < 52.0 or not same_idx:
            raise AssertionError(f"fused vs off: {psnr:.1f} dB, indices equal {same_idx}")
        return {"bundle": bundle, "xs": xs, "uris": uris, "counts": counts}
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)


# --- phase 5 -------------------------------------------------------------------


def _check_tiles(entry: dict, what: str, top_k: int, size: int) -> int:
    """A fired-prefix ``{"filters", "images"}`` payload: as many images as
    filters, at most ``top_k``, each a size x size JPEG data URL."""
    from deconv_api_tpu_torch.serving import codec

    filters, images = entry["filters"], entry["images"]
    if len(filters) != len(images) or len(filters) > top_k:
        raise AssertionError(f"{what}: {len(filters)} filters, {len(images)} images, top_k {top_k}")
    for url in images:
        if not url.startswith("data:image/webp;base64,"):
            raise AssertionError(f"{what}: not a data URL: {url[:40]}")
        hw = codec.jpeg_size(base64.b64decode(urllib.parse.unquote(url.split(",", 1)[1])))
        if hw != (size, size):
            raise AssertionError(f"{what}: tile {hw}, expected {size}x{size}")
    return len(filters)


def phase_v1_deconv(torch, uris: list) -> dict:
    """``serve --lowc-kpack auto`` answers /v1/deconv tiles and a sweep,
    through the grouped kernels at the packed block1 site."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.crosscheck import psnr_db
    from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT
    from deconv_api_tpu_torch.serving.app import Program

    torch.cuda.empty_cache()  # the boot's reserved bytes, not an earlier phase's cached ones
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda",
                           "--max-batch", str(B), "--lowc-kpack", "auto", *CACHE_OFF_FLAGS])
    boot_s = time.perf_counter() - t0
    service, port = server.service, server.server_address[1]
    size = service.bundle.image_size
    warm = warmup_report(torch, service, reserved0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        forms = [{"file": u, "layer": V1_LAYER} for u in uris[:B]] + [
            {"file": uris[B], "layer": V1_LAYER, "mode": "max"},
            {"file": uris[B + 1], "layer": V1_LAYER, "top_k": "1"},
            {"file": uris[0], "layer": V1_SWEEP_FROM, "sweep": "true"},
        ]
        ops.reset_launch_counts()
        service.batch_sizes.clear()
        results = [None] * len(forms)

        def run(i):
            results[i] = _post(port, "/v1/deconv", forms[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(forms))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        responses = []
        for form, (status, body, secs) in zip(forms, results):
            what = f"POST /v1/deconv {form['layer']} {({k: v for k, v in form.items() if k not in ('file', 'layer')})}"
            if status != 200 or not isinstance(body, dict):
                raise AssertionError(f"{what}: {status} {str(body)[:300]}")
            top_k = int(form.get("top_k", 8))
            if form.get("sweep"):
                want = list(service.bundle.sweep_layers(form["layer"]))
                if not body.get("sweep") or list(body["layers"]) != want:
                    raise AssertionError(f"{what}: layers {list(body.get('layers', {}))}, expected {want}")
                n = {name: _check_tiles(e, f"{what} {name}", top_k, size) for name, e in body["layers"].items()}
            else:
                n = _check_tiles(body, what, top_k, size)
            responses.append({"form": {k: v for k, v in form.items() if k != "file"}, "status": status,
                              "seconds": secs, "filters": n})
        batch_sizes = list(service.batch_sizes)

        # the same block5_conv1 batch through the engine: packed (the
        # service's policy), unpacked, and packed at the other fused_unpool
        # setting, so that both K3g (auto) and K2g (off) carry the packed unpools
        xs = np.stack([service.decode_preprocess(u) for u in uris[:B]])
        prog = Program(V1_LAYER, "all", 8, "tiles")
        other = "off" if FUSED_DEFAULT == "auto" else "auto"
        packed = service.run_program(prog, xs)[V1_LAYER]
        unpacked = service.run_program(prog, xs, lowc_kpack="off")[V1_LAYER]
        packed_other = service.run_program(prog, xs, fused_unpool=other)[V1_LAYER]
        torch.cuda.synchronize()
        counts, graph_counts = ops.launch_counts(), dict(ops.graph_counts)

        served_ok = all(
            r[1]["filters"] == [int(i) for i in packed["indices"][b][: int(packed["valid"][b].sum())]]
            for b, r in enumerate(results[:B])
        )
        compare = {}
        for name, run in (("unpacked", unpacked), (f"packed_fused_unpool_{other}", packed_other)):
            psnr = min(psnr_db(a, o) for a, o in zip(packed["tiles"].reshape(-1, size, size, 3),
                                                     run["tiles"].reshape(-1, size, size, 3)))
            compare[name] = {
                "min_tile_psnr_db": psnr if np.isfinite(psnr) else "identical",
                "indices_equal": bool((packed["indices"] == run["indices"]).all()
                                      and (packed["valid"] == run["valid"]).all()),
            }
        out = {"phase": "v1_deconv", "model": service.bundle.name, "server_cache": cache_state(service),
               "lowc_kpack": "auto",
               "fused_unpool": FUSED_DEFAULT, "boot_s": boot_s, "warmup": warm,
               "responses": responses, "batch_sizes": batch_sizes, "launches": counts,
               "graph_counts": graph_counts,
               "served_filters_match_engine": served_ok, "packed_vs": compare,
               "tiles_uint8": packed["tiles"].dtype == np.uint8 and packed["tiles"].shape == (B, 8, size, size, 3)}
        emit(out)
        needed = ("pool_argmax", "fused_unpool_conv", "fused_unpool_conv_grouped", "unpool_argmax_grouped")
        if not all(counts[k] > 0 for k in needed):
            raise AssertionError(f"a kernel of the path never launched: {counts}")
        if graph_counts["replays"] < len(batch_sizes) + 3:
            raise AssertionError(f"the requests did not replay captured programs: {graph_counts}")
        if not served_ok:
            raise AssertionError("served filters differ from the engine's valid prefix")
        for name, c in compare.items():
            if not c["indices_equal"] or (c["min_tile_psnr_db"] != "identical" and c["min_tile_psnr_db"] < 52.0):
                raise AssertionError(f"packed vs {name}: {c}")
        if not out["tiles_uint8"]:
            raise AssertionError(f"tiles are not uint8 (B, 8, {size}, {size}, 3)")
        return {"bundle": service.bundle, "counts": counts}
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)


# --- phase 6 -------------------------------------------------------------------


def device_breakdown(torch, run, top: int | None = 10) -> dict:
    """One call of ``run`` under torch.profiler: device time by kernel (the
    ``top`` longest, or all), and the device's idle share of the
    host-clock window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except Exception as e:  # the trace is a reading, not a check of the port
        return {"device_busy_ms": "not measured", "profiler_error": repr(e)}
    events = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not busy_ms:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    top = sorted(events, key=_device_us, reverse=True)[:top]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "top": [{"kernel": e.key[:90], "ms": _device_us(e) / 1e3, "calls": e.count} for e in top],
    }


def _timed(torch, run, reps: int = 10, items: int = B, warmup: int = 2, profiled: bool = True) -> dict:
    """Host-clock p50 of ``run`` (which ends in a device-to-host copy)
    after ``warmup`` calls, ``items`` images a call, and one profiled
    call unless not ``profiled``."""
    for _ in range(warmup):
        run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    out = {"p50_ms": p50 * 1e3, "images_per_s": items / p50, "min_ms": min(times) * 1e3, "max_ms": max(times) * 1e3}
    if profiled:
        out["profile"] = device_breakdown(torch, run)
    return out


def in_turns(torch, out: dict, runs: dict, key: str, reps: int = 20, profile_repeats: bool = True, **timed) -> None:
    """Time each of the two ``runs`` (setting -> callable) twice, in turns
    (a, b, b, a), ``reps`` calls each, into ``out[f"{key}_{setting}"]`` and
    its ``_repeat`` (profiled too unless not ``profile_repeats``), and add
    by how much the second setting's slower p50 beats the first's faster
    one beside the spread between the repeats of either."""
    (a, run_a), (b, run_b) = runs.items()
    for name, run in ((a, run_a), (b, run_b), (f"{b}_repeat", run_b), (f"{a}_repeat", run_a)):
        out[f"{key}_{name}"] = _timed(torch, run, reps, profiled=profile_repeats or not name.endswith("_repeat"),
                                      **timed)
    p50 = {s: [out[f"{key}_{s}"]["p50_ms"], out[f"{key}_{s}_repeat"]["p50_ms"]] for s in (a, b)}
    out[f"{key}_{b}_faster_by_ms"] = min(p50[a]) - max(p50[b])
    out[f"{key}_spread_ms"] = max(abs(p[0] - p[1]) for p in p50.values())


def captured_run(bundle, batch, layer: str, top_k: int, post: str, **settings):
    """The captured batch program at the service's settings (bf16 backward,
    bug_compat) as a callable that replays it on ``batch`` (on the card)
    and copies every projected layer's ``post`` to the host; and the
    program."""
    prog = bundle.program(layer, "all", top_k, len(batch), post=post,
                          **{"bug_compat": True, "backward_dtype": "bfloat16", **settings})

    def run():
        with bundle.programs.replaying():
            return [e[post].cpu() for e in prog(batch).values()]

    return run, prog


def eager_run(bundle, batch, layer: str, top_k: int, post: str, **settings):
    """The same program run eagerly, one aten call at a time."""
    fn = bundle.batched_visualizer(layer, "all", top_k, True, "bfloat16", post=post, **settings)
    return lambda: [e[post].cpu() for e in fn(bundle.params, batch).values()]


def phase_throughput(torch, ctx: dict, label: str) -> dict:
    """POST /: the batch-8 grid program at the default fused_unpool,
    captured against eager in turns; captured and eager (fewer calls) at
    the other setting."""
    from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT

    bundle, xs = ctx["bundle"], ctx["xs"]
    batch = torch.from_numpy(xs).cuda()
    out = {"phase": "throughput", "card": label, "batch": B, "layer": "block5_conv1", "top_k": K,
           "forward": "float32", "backward": "bfloat16"}
    other = "off" if FUSED_DEFAULT == "auto" else "auto"
    cap, prog = captured_run(bundle, batch, "block5_conv1", K, "grid", fused_unpool=FUSED_DEFAULT)
    out[f"fused_{FUSED_DEFAULT}_capture_s"] = prog.capture_s
    in_turns(torch, out, {"eager": eager_run(bundle, batch, "block5_conv1", K, "grid", fused_unpool=FUSED_DEFAULT),
                          "captured": cap}, f"fused_{FUSED_DEFAULT}")
    cap, prog = captured_run(bundle, batch, "block5_conv1", K, "grid", fused_unpool=other)
    out[f"fused_{other}_captured"] = {"capture_s": prog.capture_s, **_timed(torch, cap, reps=20)}
    out[f"fused_{other}_eager"] = _timed(torch, eager_run(bundle, batch, "block5_conv1", K, "grid",
                                                          fused_unpool=other), reps=5)
    emit(out)
    return out


def phase_throughput_v1(torch, bundle, batch, label: str) -> dict:
    """/v1/deconv: the captured tiles program at top_k 8 under each
    lowc_kpack policy at the default fused_unpool; at lowc_kpack=off,
    captured against eager in turns, and captured at the other
    fused_unpool; then one sweep from the same layer at each setting;
    each program not timed in turns also eager, in fewer calls."""
    from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT

    out = {"phase": "throughput", "card": label, "batch": B, "layer": V1_LAYER, "top_k": 8,
           "post": "tiles", "forward": "float32", "backward": "bfloat16"}
    other = "off" if FUSED_DEFAULT == "auto" else "auto"
    for policy in ("auto", "forced"):
        cap, prog = captured_run(bundle, batch, V1_LAYER, 8, "tiles", lowc_kpack=policy, fused_unpool=FUSED_DEFAULT)
        out[f"lowc_kpack_{policy}_fused_{FUSED_DEFAULT}_captured"] = {"capture_s": prog.capture_s, **_timed(torch, cap)}
        out[f"lowc_kpack_{policy}_fused_{FUSED_DEFAULT}_eager"] = _timed(
            torch, eager_run(bundle, batch, V1_LAYER, 8, "tiles", lowc_kpack=policy, fused_unpool=FUSED_DEFAULT),
            reps=5)
    cap, _ = captured_run(bundle, batch, V1_LAYER, 8, "tiles", lowc_kpack="off", fused_unpool=FUSED_DEFAULT)
    in_turns(torch, out, {"eager": eager_run(bundle, batch, V1_LAYER, 8, "tiles", lowc_kpack="off",
                                             fused_unpool=FUSED_DEFAULT), "captured": cap},
             f"lowc_kpack_off_fused_{FUSED_DEFAULT}", reps=10)
    cap, prog = captured_run(bundle, batch, V1_LAYER, 8, "tiles", lowc_kpack="off", fused_unpool=other)
    out[f"lowc_kpack_off_fused_{other}_captured"] = {"capture_s": prog.capture_s, **_timed(torch, cap)}
    out[f"lowc_kpack_off_fused_{other}_eager"] = _timed(
        torch, eager_run(bundle, batch, V1_LAYER, 8, "tiles", lowc_kpack="off", fused_unpool=other), reps=5)
    for fused_unpool in ("auto", "off"):
        cap, prog = captured_run(bundle, batch, V1_LAYER, 8, "tiles", sweep=True, lowc_kpack="auto",
                                 fused_unpool=fused_unpool)
        out[f"sweep_lowc_kpack_auto_fused_{fused_unpool}_captured"] = {
            "layers": len(cap()), "capture_s": prog.capture_s, **_timed(torch, cap, reps=3)}
        out[f"sweep_lowc_kpack_auto_fused_{fused_unpool}_eager"] = _timed(
            torch, eager_run(bundle, batch, V1_LAYER, 8, "tiles", sweep=True, lowc_kpack="auto",
                             fused_unpool=fused_unpool), reps=2, warmup=1)
    emit(out)
    return out


# --- phase 7 -------------------------------------------------------------------

# the DAG slice: each family at its deepest projectable layer, and VGG19
# through the sequential engine at its block5_conv1 (as VGG16's main path)
DAG_LAYERS = {"resnet50": "conv5_block3_out", "inception_v3": "mixed10",
              "mobilenet_v1": "conv_pw_13_relu", "mobilenet_v2": "out_relu"}
VGG19_LAYER = "block5_conv1"
# a batched backward against K retained ones on the card (the CPU test's rtol)
BATCHED_MAX_REL_ERR = 1e-5
# the NCHW avg_pool2d gradient blocks.avgpool relies on (the GPU test's tolerance)
AVGPOOL_MAX_REL_ERR = 1e-6


def avg_pool2d_grad_errors(torch) -> dict:
    """The gradient of ``F.avg_pool2d`` (3x3/1, padding 1, the valid-cell
    count) on the card against the CPU, relative to its largest magnitude,
    over a ``channels_last`` input (the library fault) and over a
    contiguous NCHW one (what ``blocks.avgpool`` passes, which must stay
    within AVGPOOL_MAX_REL_ERR)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x, gy = torch.randn((2, 8, 35, 35), generator=g), torch.randn((2, 8, 35, 35), generator=g)
    out = {}
    for name, fmt in (("channels_last", torch.channels_last), ("nchw", torch.contiguous_format)):
        grads = []
        for dev in ("cpu", "cuda"):
            xi = x.to(dev).contiguous(memory_format=fmt).requires_grad_(True)
            y = F.avg_pool2d(xi, 3, 1, padding=1, count_include_pad=False)
            grads.append(torch.autograd.grad(y, xi, gy.to(dev))[0].cpu())
        out[name] = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    if not out["nchw"] <= AVGPOOL_MAX_REL_ERR:
        raise AssertionError(f"avg_pool2d gradient over NCHW on the card vs the CPU: {out}")
    return out


def phase_dag(torch, uris: list, label: str) -> dict:
    """The DAG slice: ResNet50 served over HTTP (``POST /`` and
    ``/v1/deconv`` tiles and a sweep), one batch-8 ``POST /`` program of
    each other new model, each DAG family held against its CPU run, and the
    times of the programs."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.crosscheck import card_vs_cpu
    from deconv_api_tpu_torch.serving import codec
    from deconv_api_tpu_torch.serving.app import DeconvService, Program
    from deconv_api_tpu_torch.serving.models import build_bundle

    layer = DAG_LAYERS["resnet50"]
    torch.cuda.empty_cache()  # the boot's reserved bytes, not an earlier phase's cached ones
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "resnet50", "--device", "cuda",
                           "--max-batch", str(B), *CACHE_OFF_FLAGS])
    boot_s = time.perf_counter() - t0
    service, port = server.service, server.server_address[1]
    bundle, size = service.bundle, service.bundle.image_size
    warm = warmup_report(torch, service, reserved0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        forms = [("/", {"file": u, "layer": layer}) for u in uris[:B]] + [
            ("/v1/deconv", {"file": uris[B], "layer": layer}),
            ("/v1/deconv", {"file": uris[B + 1], "layer": layer, "sweep": "true"}),
        ]
        ops.reset_launch_counts()
        service.batch_sizes.clear()
        results = [None] * len(forms)

        def run(i):
            results[i] = _post(port, *forms[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(forms))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        counts, graph_counts = ops.launch_counts(), dict(ops.graph_counts)
        responses = []
        for (path, form), (status, body, secs) in zip(forms, results):
            what = f"resnet50 POST {path} {({k: v for k, v in form.items() if k != 'file'})}"
            if status != 200:
                raise AssertionError(f"{what}: {status} {str(body)[:300]}")
            if path == "/":
                hw = codec.jpeg_size(base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1])))
                if hw != (2 * size, 2 * size):
                    raise AssertionError(f"{what}: grid {hw}, expected {2 * size}x{2 * size}")
                n = None
            elif form.get("sweep"):
                want = list(bundle.sweep_layers(layer))
                if list(body["layers"]) != want:
                    raise AssertionError(f"{what}: layers {list(body['layers'])}, expected {want}")
                n = {name: _check_tiles(e, f"{what} {name}", 8, size) for name, e in body["layers"].items()}
            else:
                n = _check_tiles(body, what, 8, size)
            if n is not None and not (all(n.values()) if isinstance(n, dict) else n):
                raise AssertionError(f"{what}: no filter fired: {n}")
            responses.append({"path": path, "sweep": bool(form.get("sweep")), "status": status,
                              "seconds": secs, "filters": n})
        batch_sizes = list(service.batch_sizes)
        # the served tiles are the engine's fired prefix for that image
        engine = service.run_program(Program(layer, "all", 8, "tiles"),
                                     service.decode_preprocess(uris[B])[None])[layer]
        served_ok = results[B][1]["filters"] == [int(i) for i in engine["indices"][0][: int(engine["valid"][0].sum())]]
        xs = np.stack([service.decode_preprocess(u) for u in uris[:B]])
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)
    out = {"phase": "dag", "card": label, "model": "resnet50", "layer": layer,
           "server_cache": cache_state(service), "boot_s": boot_s,
           "warmup": warm, "responses": responses, "batch_sizes": batch_sizes, "launches": counts,
           "graph_counts": graph_counts, "served_filters_match_engine": served_ok}
    if max(batch_sizes) <= 1 or not served_ok or graph_counts["replays"] < len(batch_sizes):
        raise AssertionError(f"resnet50 serving: batch sizes {batch_sizes}, served filters match {served_ok}, "
                             f"graphs {graph_counts}")

    # one batch-8 POST / program of each other new model; VGG19's kernel
    # launches read around its own runs (fused_unpool at the default, then auto)
    bundles, batches, programs = {"resnet50": bundle}, {"resnet50": xs}, {}
    for model in ("inception_v3", "mobilenet_v1", "mobilenet_v2", "vgg19"):
        b = bundles[model] = build_bundle(model, "cuda")
        svc = DeconvService(b, max_batch=B, **CACHE_OFF)
        lyr = DAG_LAYERS.get(model, VGG19_LAYER)
        xm = batches[model] = np.stack([svc.decode_preprocess(u) for u in uris[:B]])
        ops.reset_launch_counts()
        grid = svc.run_program(Program(lyr), xm)[lyr]
        torch.cuda.synchronize()
        side = 2 * b.image_size
        entry = {"layer": lyr, "launches": ops.launch_counts(), "fired": int(grid["valid"].sum()),
                 "grid_ok": grid["grid"].dtype == np.uint8 and grid["grid"].shape == (B, side, side, 3)}
        if model == "vgg19":
            ops.reset_launch_counts()
            svc.run_program(Program(lyr), xm, fused_unpool="auto")
            torch.cuda.synchronize()
            entry["launches_fused_auto"] = ops.launch_counts()
        programs[model] = entry
        if not entry["grid_ok"] or not entry["fired"]:
            raise AssertionError(f"{model} POST / program: {entry}")
    out["programs"] = programs
    vgg19 = programs["vgg19"]
    if not (vgg19["launches"]["pool_argmax"] and vgg19["launches"]["unpool_argmax"]
            and vgg19["launches_fused_auto"]["fused_unpool_conv"]):
        raise AssertionError(f"a kernel of VGG19's path never launched: {vgg19}")

    # card against CPU, one image at full width per DAG family, and the
    # library fault blocks.avgpool works around, measured again
    out["avg_pool2d_grad_rel_err"] = avg_pool2d_grad_errors(torch)
    out["card_vs_cpu"] = {model: card_vs_cpu(bundles[model], lyr, torch.from_numpy(batches[model][:1]), K)
                          for model, lyr in DAG_LAYERS.items()}
    emit(out)
    dag_times(torch, bundles, batches, label)
    return {"counts": counts, "vgg19_counts": vgg19["launches"], "vgg19_auto_counts": vgg19["launches_fused_auto"],
            "bundles": bundles, "batches": batches}


def dag_times(torch, bundles: dict, batches: dict, label: str) -> None:
    """Host-clock p50 of the batch-8 programs, captured against eager in
    turns: ResNet50's grid and the other models' grids; ResNet50's tiles
    and sweep captured, with one eager time each; each with one profiled
    call.  Then ResNet50's batched backward against K retained backward
    passes over one forward, in turns."""
    from deconv_api_tpu_torch.engine.autodeconv import project
    from deconv_api_tpu_torch.engine.deconv import _seed_fmaps, _select_top
    from deconv_api_tpu_torch.models.blocks import DECONV_RULES

    times = {"phase": "dag_throughput", "card": label, "batch": B, "forward": "float32",
             "backward": "float32 (vgg19: bfloat16)"}

    def runs(model, k, post, sweep=False):
        # the service's settings (run_program); a DAG model ignores the
        # backward dtype and bug_compat and projects in fp32
        b, xb = bundles[model], torch.from_numpy(batches[model]).cuda()
        layer = DAG_LAYERS.get(model, VGG19_LAYER)
        cap, prog = captured_run(b, xb, layer, k, post, sweep=sweep)
        return cap, eager_run(b, xb, layer, k, post, sweep=sweep), prog

    for model in ("resnet50", "inception_v3", "mobilenet_v1", "mobilenet_v2", "vgg19"):
        cap, eager, prog = runs(model, K, "grid")
        times[f"{model}_grid_capture_s"] = prog.capture_s
        in_turns(torch, times, {"eager": eager, "captured": cap}, f"{model}_grid",
                 reps=10 if model == "resnet50" else 5)
    cap, eager, prog = runs("resnet50", 8, "tiles")
    times["resnet50_tiles_top8_captured"] = {"capture_s": prog.capture_s, **_timed(torch, cap, reps=10)}
    times["resnet50_tiles_top8_eager"] = _timed(torch, eager, reps=5)
    cap, eager, prog = runs("resnet50", 8, "tiles", sweep=True)
    times["resnet50_sweep_top8_captured"] = {"layers": len(cap()), "capture_s": prog.capture_s,
                                             **_timed(torch, cap, reps=3)}
    times["resnet50_sweep_top8_eager"] = _timed(torch, eager, reps=2, warmup=1)

    bundle = bundles["resnet50"]
    x = torch.from_numpy(batches["resnet50"]).cuda().requires_grad_(True)
    act = bundle.forward_fn(bundle.params, x, rules=DECONV_RULES)[1][DAG_LAYERS["resnet50"]]

    def k_passes():
        top_idx = _select_top(act.detach(), K)[0]
        seeds = _seed_fmaps(act.detach(), top_idx, "all").reshape(B, K, *act.shape[1:])
        return torch.stack([torch.autograd.grad(act, x, seeds[:, k], retain_graph=True)[0] for k in range(K)], 1)

    want = k_passes()
    got = project(act, x, K, "all", retain_graph=True)["images"]
    times["batched_vs_k_passes_rel_err"] = float((got - want).abs().max() / want.abs().max())
    del got, want
    if not times["batched_vs_k_passes_rel_err"] <= BATCHED_MAX_REL_ERR:
        raise AssertionError(f"batched backward vs K passes: {times['batched_vs_k_passes_rel_err']}")
    in_turns(torch, times, {"batched": lambda: project(act, x, K, "all", retain_graph=True)["images"].sum().item(),
                            "k_passes": lambda: k_passes().sum().item()}, "resnet50_backward", reps=5)
    emit(times)


# --- phase 8 -------------------------------------------------------------------

DREAM_BATCH = 4  # the dream dispatcher's max_batch


def _check_dream(status, body, what: str, size: int, layers) -> dict:
    """A 200 ``{"layers", "loss", "image"}`` answer with the model's dream
    layers, a finite loss above 0 and a size x size JPEG."""
    from deconv_api_tpu_torch.serving import codec

    if status != 200:
        raise AssertionError(f"{what}: {status} {str(body)[:300]}")
    hw = codec.jpeg_size(base64.b64decode(urllib.parse.unquote(body["image"].split(",", 1)[1])))
    loss = body["loss"]
    if body["layers"] != list(layers) or hw != (size, size) or loss is None or not loss > 0:
        raise AssertionError(f"{what}: layers {body['layers']}, image {hw}, loss {loss}")
    return {"jpeg_hw": list(hw), "loss": loss}


def dream_work(torch, bundle, shapes) -> dict:
    """What one default dream of one image asks of the device, counted on
    ``meta`` tensors (no data, no device): the conv and matmul FLOPs of the
    forward and of the input gradient at each rung
    (``torch.utils.flop_counter``), and the aten calls of one step at the
    top rung, views included."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    from deconv_api_tpu_torch.engine.deepdream import activation_loss
    from deconv_api_tpu_torch.models.weights import tree_map
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS

    class Calls(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    params = tree_map(lambda t: torch.empty_like(t, device="meta"), bundle.params)
    layers = bundle.dream_layers
    fwd = bundle.dream_forward(layers)
    rungs, calls = [], {}
    for hw in shapes:
        x = torch.empty((1, *hw, 3), device="meta", requires_grad=True)
        with FlopCounterMode(display=False) as f, Calls() as cf:
            loss = activation_loss(fwd, params, x, layers).sum()
        with FlopCounterMode(display=False) as g, Calls() as cg:
            torch.autograd.grad(loss, x)
        rungs.append({"hw": list(hw), "forward_gflop": f.get_total_flops() / 1e9,
                      "input_grad_gflop": g.get_total_flops() / 1e9})
        calls = {"forward": cf.n, "input_grad": cg.n}
    steps = DREAM_DEFAULTS["steps"]
    return {"rungs": rungs, "aten_calls_per_step_top_rung": calls,
            "tflop_per_image": steps * sum(r["forward_gflop"] + r["input_grad_gflop"] for r in rungs) / 1e3}


def phase_dream(torch, uris: list, label: str) -> dict:
    """DeepDream: InceptionV3 served over HTTP (4 concurrent default
    dreams, one request for another model), one default dream each of
    vgg16 and mobilenet_v2 through the engine, the InceptionV3 dream on the
    card against the CPU, and the times of the batch-4 and batch-1
    InceptionV3 dreams."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.crosscheck import dream_card_vs_cpu
    from deconv_api_tpu_torch.engine.deepdream import octave_shapes
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS, DeconvService, Dream
    from deconv_api_tpu_torch.serving.models import build_bundle

    torch.cuda.empty_cache()  # the boot's reserved bytes, not an earlier phase's cached ones
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "inception_v3", "--device", "cuda", *CACHE_OFF_FLAGS])
    boot_s = time.perf_counter() - t0
    service, port = server.service, server.server_address[1]
    bundle, size = service.bundle, service.bundle.image_size
    warm = warmup_report(torch, service, reserved0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    counts_by_path = {}
    try:
        ops.reset_launch_counts()
        service.dream_batch_sizes.clear()
        results = [None] * DREAM_BATCH

        def run(i):
            results[i] = _post(port, "/v1/dream", {"file": uris[i]})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(DREAM_BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        counts_by_path["inception_v3 POST /v1/dream"] = ops.launch_counts()
        graph_counts = dict(ops.graph_counts)
        responses = [{**_check_dream(status, body, f"inception_v3 POST /v1/dream {i}", size, bundle.dream_layers),
                      "seconds": secs} for i, (status, body, secs) in enumerate(results)]
        batch_sizes = list(service.dream_batch_sizes)
        status, body, _ = _post(port, "/v1/dream", {"file": uris[0], "model": "vgg19"})
        other_model = {"status": status, "error": json.loads(body).get("error") if status != 200 else None}
        if other_model != {"status": 422, "error": "unknown_model"}:
            raise AssertionError(f"inception_v3 server, POST /v1/dream model=vgg19: {status} {str(body)[:300]}")
        xs = np.stack([service.decode_preprocess(u) for u in uris[:DREAM_BATCH]])
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)
    shapes = octave_shapes(size, size, DREAM_DEFAULTS["octaves"], 1.4, bundle.min_dream_size)
    out = {"phase": "dream", "card": label, "model": "inception_v3", "server_cache": cache_state(service),
           "boot_s": boot_s, "warmup": warm,
           "graph_counts": graph_counts, "layers": list(bundle.dream_layers), "octave_shapes": shapes,
           "ascent_steps": len(shapes) * DREAM_DEFAULTS["steps"], "work": dream_work(torch, bundle, shapes),
           "responses": responses,
           "batch_sizes": batch_sizes, "other_model": other_model}

    # 4 dreams of 50 steps on 5 rungs: a pyramid replay and 10 step replays a rung
    if graph_counts["replays"] < len(shapes) * (1 + DREAM_DEFAULTS["steps"]) * len(batch_sizes):
        raise AssertionError(f"the served dreams did not replay their captured programs: {graph_counts}")

    # one default dream of a sequential spec and of ReLU6 through the engine
    engine = {}
    for model in ("vgg16", "mobilenet_v2"):
        b = build_bundle(model, "cuda")
        svc = DeconvService(b, **CACHE_OFF)
        xm = svc.decode_preprocess(uris[0])[None]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        img, losses = svc.run_dream(Dream(b.dream_layers), xm)
        secs = time.perf_counter() - t0
        counts_by_path[f"{model} dream"] = ops.launch_counts()
        ladder = octave_shapes(b.image_size, b.image_size, DREAM_DEFAULTS["octaves"], 1.4, b.min_dream_size)
        entry = {"layers": list(b.dream_layers), "octave_shapes": ladder, "seconds": secs,
                 "loss": float(losses[0]), "max_change": float(np.abs(img - xm).max()),
                 "work": dream_work(torch, b, ladder)}
        engine[model] = entry
        if not (img.shape == xm.shape and np.isfinite(img).all() and entry["loss"] > 0 and entry["max_change"] > 0):
            raise AssertionError(f"{model} dream: {entry}")
        del b, svc
    out["engine"] = engine
    bad = {path: c for path, c in counts_by_path.items() if any(c.values())}
    if bad:
        raise AssertionError(f"a hand-written kernel launched on the dream path: {bad}")
    out["launches"] = counts_by_path

    # the card against the CPU, one full-width image at the route's defaults
    out["card_vs_cpu"] = dream_card_vs_cpu(bundle, torch.from_numpy(xs[:1]))
    emit(out)
    dream_times(torch, service, xs, shapes, out["work"]["tflop_per_image"], label)
    return {"counts_by_path": counts_by_path, "service": service, "xs": xs}


def eager_dream(torch, bundle, x, shapes):
    """The default dream of ``x`` (on the card) run eagerly, one aten call
    at a time: each rung's pyramid step, then the eager ascent loop (what
    ``deepdream_batch`` ran before the capture)."""
    from deconv_api_tpu_torch.engine.deepdream import _ascend, _pyramid_step
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS

    layers = bundle.dream_layers
    fwd, cur, losses = bundle.dream_forward(layers), None, None
    for i, hw in enumerate(shapes):
        cur = _pyramid_step(cur, x, hw, shapes[i - 1] if i else None)
        cur, losses = _ascend(fwd, bundle.params, cur, layers, DREAM_DEFAULTS["steps"], DREAM_DEFAULTS["lr"])
    return cur, losses


def dream_times(torch, service, xs, shapes, tflop_per_image: float, label: str) -> None:
    """Host-clock p50 of the default InceptionV3 dream at batch 4, captured
    (``run_dream``) against eager in turns, and at batch 1 captured and
    eager (one call), with the rates its p50 implies and one profiled call
    each."""
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS, Dream

    steps = len(shapes) * DREAM_DEFAULTS["steps"]
    times = {"phase": "dream_throughput", "card": label, "model": "inception_v3", "ascent_steps": steps}
    dream, bundle = Dream(service.bundle.dream_layers), service.bundle
    base = torch.from_numpy(xs[:DREAM_BATCH]).cuda()
    in_turns(torch, times, {"eager": lambda: eager_dream(torch, bundle, base, shapes)[0].cpu(),
                            "captured": lambda: service.run_dream(dream, xs[:DREAM_BATCH])},
             f"batch{DREAM_BATCH}", reps=2, items=DREAM_BATCH, warmup=0, profile_repeats=False)
    times["batch1_captured"] = _timed(torch, lambda: service.run_dream(dream, xs[:1]), reps=3, items=1, warmup=1)
    times["batch1_eager"] = _timed(torch, lambda: eager_dream(torch, bundle, base[:1], shapes)[0].cpu(), reps=1,
                                   items=1, warmup=0)
    for key, b in ((f"batch{DREAM_BATCH}_captured", DREAM_BATCH), (f"batch{DREAM_BATCH}_eager", DREAM_BATCH),
                   ("batch1_captured", 1), ("batch1_eager", 1)):
        p50 = times[key]["p50_ms"] / 1e3
        times[key].update(dreams_per_s=b / p50, ascent_steps_per_s=steps / p50, image_steps_per_s=b * steps / p50,
                          conv_tflop_per_s=b * tflop_per_image / p50)
    times["capture_s"] = {f"batch{b}": sum(p.capture_s for rung in bundle.dream_program(dream.layers, shapes, b)
                                          for p in rung) for b in (1, 2, DREAM_BATCH)}
    emit(times)


# --- phase 9 -------------------------------------------------------------------

PADDED = ((3, 4), (5, 8))  # (images, bucket)
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5  # a split batch's bars in the JAX package (tests/test_parallel.py)
DREAM_RTOL, DREAM_ATOL = 2e-4, 2e-5  # a batched dream against its solo runs (tests/test_deepdream.py)
BF16_MIN_PSNR_DB, FP32_MIN_PSNR_DB = 52.0, 65.0
# a padded fp32 row whose forward switch flipped on a near-tie, against its
# solo run at bucket 1, of its largest magnitude: twice the largest reading
# of 2.6e-2 (PERF.md §6)
FLIPPED_MAX_REL_ERR = 5e-2


def _host_tree(out) -> dict:
    return {name: {k: v.detach().cpu() for k, v in e.items()} for name, e in out.items()}


def _captured_vs_eager(torch, bundle, batch, layer, top_k, settings) -> dict:
    """One captured program (at ``len(batch)``) against its eager run on the
    same batch: equal indices and valid, and the uint8 output byte-equal,
    or else held at the PSNR bar of its backward dtype with the bytes that
    differ reported."""
    import numpy as np

    from deconv_api_tpu_torch.engine.crosscheck import psnr_db

    post = settings["post"]
    prog = bundle.program(layer, "all", top_k, len(batch), bug_compat=True, backward_dtype="bfloat16", **settings)
    with bundle.programs.replaying():
        got = _host_tree(prog(batch))
    want = _host_tree(bundle.batched_visualizer(layer, "all", top_k, True, "bfloat16", **settings)(bundle.params, batch))
    bar = BF16_MIN_PSNR_DB if bundle.spec is not None else FP32_MIN_PSNR_DB
    row = {"model": bundle.name, "layer": layer, "top_k": top_k, **settings, "layers": len(want),
           "kernels": prog.kernels, "capture_s": prog.capture_s, "indices_equal": True, "differing_bytes": 0}
    psnrs = []
    for name in want:
        g, w = got[name], want[name]
        row["indices_equal"] &= bool(torch.equal(g["indices"], w["indices"]) and torch.equal(g["valid"], w["valid"]))
        row["differing_bytes"] += int((g[post] != w[post]).sum())
        a, b = g[post].numpy(), w[post].numpy()
        psnrs += [psnr_db(x, y) for x, y in zip(a.reshape(-1, *a.shape[-3:]), b.reshape(-1, *b.shape[-3:]))]
    row["byte_equal"] = row["differing_bytes"] == 0
    row["min_psnr_db"] = min(psnrs) if np.isfinite(min(psnrs)) else "identical"
    row["ok"] = bool(row["indices_equal"] and (row["byte_equal"] or min(psnrs) >= bar))
    if not row["byte_equal"]:
        # find the kernel that differs: the eager program against itself,
        # and the kernels it runs only with cuDNN's non-deterministic
        # algorithms allowed; with them barred, two eager runs agree
        eager = bundle.batched_visualizer(layer, "all", top_k, True, "bfloat16", **settings)
        run = lambda: _host_tree(eager(bundle.params, batch))  # noqa: E731
        row["eager_vs_eager_differing_bytes"] = sum(int((run()[n][post] != want[n][post]).sum()) for n in want)
        names, prev = {}, torch.backends.cudnn.deterministic
        try:
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                names[det] = {k["kernel"] for k in device_breakdown(torch, run, top=None).get("top", [])}
                if det:
                    a, b = run(), run()
                    row["deterministic_eager_vs_eager_differing_bytes"] = sum(
                        int((a[n][post] != b[n][post]).sum()) for n in a)
        finally:
            torch.backends.cudnn.deterministic = prev
        row["kernels_only_when_nondeterministic"] = sorted(names[False] - names[True])
    return row


def forward_switches(torch, bundle, layer: str, x) -> list:
    """The int8 switches of every forward pool of a sequential bundle's
    eager forward to ``layer`` on the batch ``x`` (on the card)."""
    from deconv_api_tpu_torch.engine.deconv import _forward_chain
    from deconv_api_tpu_torch.models.spec import entry_chain

    switches: dict = {}
    with torch.no_grad():
        _forward_chain(entry_chain(bundle.spec.truncated(layer)), bundle.params, x, switches)
    return [idx.cpu() for idx, _ in switches.values()]


def phase_capture(torch, vgg16, dag: dict, dream: dict, xs, label: str) -> None:
    """The captured programs against their eager runs and their solo runs,
    at full width on the card.  Every bar is checked and reported before
    the phase fails on any:
    - each deconv program, batch 8: VGG16's grid, tiles and sweep at both
      fused_unpool settings and its tiles at lowc_kpack=auto, and the grids
      of ResNet50, InceptionV3, MobileNet v1/v2 and VGG19: equal indices,
      the uint8 output byte-equal (else the PSNR bar, the bytes reported);
      the kernels each graph holds (K1 and K2 in VGG16's POST / graph, K3
      and K3g at fused_unpool=auto, K2g in the lowc_kpack=auto tiles graph);
    - padded buckets, 3 images in bucket 4 and 5 in bucket 8, each real row
      against its solo runs: VGG16's fp32 projections against the image
      alone in the same bucket through the same graph (indices equal, the
      JAX package's elementwise rtol 1e-4 / atol 1e-5) and at bucket 1
      (indices equal; 1e-4 of the largest magnitude on every image whose
      forward switches all agree, at least one a bucket, and
      FLIPPED_MAX_REL_ERR on the others, the flips counted and the
      elementwise bar reported: cuDNN sums in another order at another
      batch), and its served bf16 grids (>= 52 dB); the default InceptionV3
      dream, 3 in bucket 4, whole in float64 (within rtol 2e-4 / atol 2e-5)
      and one float32 top-rung step (the dream step bars), the whole float32
      dream reported (float32 dreams part at ReLU kinks);
    - one captured InceptionV3 ascent step at 299 against one eager step
      from the same input: byte-equal, or the dream step bars (uint8 >= 40
      dB, loss within 1e-3, update >= 40 dB); the whole captured dream
      against the whole eager dream, reported only."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.engine.capture import ProgramCache
    from deconv_api_tpu_torch.engine.crosscheck import DREAM_LOSS_REL_ERR, DREAM_MIN_PSNR_DB, MAX_REL_ERR, psnr_db
    from deconv_api_tpu_torch.engine.deepdream import _ascend, dream_programs, octave_shapes, run_dream_programs
    from deconv_api_tpu_torch.models.weights import tree_map
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS, DeconvService, Dream, Program
    from deconv_api_tpu_torch.serving.batcher import pad_to_bucket

    ops.reset_launch_counts()
    out = {"phase": "capture", "card": label}
    failed = []
    batch = torch.from_numpy(xs).cuda()
    cases = []
    for fused in ("off", "auto"):
        cases += [(vgg16, "block5_conv1", K, {"post": "grid", "fused_unpool": fused}),
                  (vgg16, "block5_conv1", 8, {"post": "tiles", "fused_unpool": fused}),
                  (vgg16, V1_SWEEP_FROM, 8, {"post": "tiles", "fused_unpool": fused, "sweep": True}),
                  (vgg16, "block5_conv1", 8, {"post": "tiles", "fused_unpool": fused, "lowc_kpack": "auto"})]
    for model in ("resnet50", "inception_v3", "mobilenet_v1", "mobilenet_v2", "vgg19"):
        cases.append((dag["bundles"][model], DAG_LAYERS.get(model, VGG19_LAYER), K, {"post": "grid"}))
    rows = []
    for bundle, layer, top_k, settings in cases:
        xb = batch if bundle.name == "vgg16" else torch.from_numpy(dag["batches"][bundle.name]).cuda()
        rows.append(_captured_vs_eager(torch, bundle, xb, layer, top_k, settings))
        if not rows[-1]["ok"]:
            failed.append(f"captured vs eager: {rows[-1]}")
    out["captured_vs_eager"] = rows
    held = {(r["model"], r["post"], r["fused_unpool"] if r["model"] == "vgg16" else None,
             r.get("lowc_kpack", "off"), r.get("sweep", False)): r["kernels"] for r in rows}
    need = {("vgg16", "grid", "off", "off", False): ("pool_argmax", "unpool_argmax"),
            ("vgg16", "grid", "auto", "off", False): ("pool_argmax", "fused_unpool_conv"),
            ("vgg16", "tiles", "off", "auto", False): ("pool_argmax", "unpool_argmax_grouped"),
            ("vgg16", "tiles", "auto", "auto", False): ("fused_unpool_conv", "fused_unpool_conv_grouped")}
    for key, kernels in need.items():
        if not all(held[key].get(k, 0) > 0 for k in kernels):
            failed.append(f"graph {key} holds {held[key]}, expected {kernels}")

    # padded buckets against solo runs, the fp32 programs captured under
    # cuDNN's deterministic algorithms.  Each real row against two solo
    # runs of its image: (1) alone in the same bucket (every row that
    # image), through the same graph, which isolates the padding from the
    # algorithm cuDNN picks for a batch size: the JAX package's elementwise
    # bar and equal indices hold there; (2) at bucket 1, where cuDNN may
    # sum in another order and a forward switch whose window holds a
    # near-tie can flip, moving a projected value by a pixel: equal
    # indices, 1e-4 of the largest magnitude on every image whose switches
    # all agree (at least one such image a bucket), FLIPPED_MAX_REL_ERR on
    # the others, and the served bf16 grids at >= 52 dB
    padded = []
    service = DeconvService(vgg16, max_batch=B, **CACHE_OFF)
    out["server_cache"] = cache_state(service)
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for n, bucket in PADDED:
            fp32 = vgg16.program("block5_conv1", "all", K, bucket, post=None)
            solo = vgg16.program("block5_conv1", "all", K, 1, post=None)
            xp = torch.from_numpy(pad_to_bucket(xs[:n], bucket))
            with vgg16.programs.replaying():
                got = _host_tree(fp32(xp))["block5_conv1"]
            row = {"images": n, "bucket": bucket, "same_bucket_indices_equal": True, "same_bucket_max_abs_err": 0.0,
                   "same_bucket_elementwise_outside": 0, "indices_equal": True, "switch_flips": [],
                   "fp32_rel_err": [], "fp32_max_abs_err": 0.0, "fp32_elementwise_outside": 0, "fp32_elements": 0}
            padded_switches = forward_switches(torch, vgg16, "block5_conv1", xp.cuda())
            for i in range(n):
                with vgg16.programs.replaying():
                    alone = _host_tree(fp32(torch.from_numpy(pad_to_bucket(xs[i : i + 1], bucket))))["block5_conv1"]
                    want = _host_tree(solo(batch[i : i + 1]))["block5_conv1"]
                g, a = got["images"][i], alone["images"][i]
                row["same_bucket_indices_equal"] &= bool(torch.equal(got["indices"][i], alone["indices"][i]))
                row["same_bucket_max_abs_err"] = max(row["same_bucket_max_abs_err"], float((g - a).abs().max()))
                row["same_bucket_elementwise_outside"] += int(((g - a).abs() > FP32_ATOL + FP32_RTOL * a.abs()).sum())
                row["indices_equal"] &= bool(torch.equal(got["indices"][i], want["indices"][0]))
                row["switch_flips"].append(sum(int((p[i] != s[0]).sum()) for p, s in zip(
                    padded_switches, forward_switches(torch, vgg16, "block5_conv1", batch[i : i + 1]))))
                w = want["images"][0]
                row["fp32_max_abs_err"] = max(row["fp32_max_abs_err"], float((g - w).abs().max()))
                row["fp32_rel_err"].append(float((g - w).abs().max() / w.abs().max()))
                row["fp32_elementwise_outside"] += int(((g - w).abs() > FP32_ATOL + FP32_RTOL * w.abs()).sum())
                row["fp32_elements"] += w.numel()
            unflipped = [e for e, f in zip(row["fp32_rel_err"], row["switch_flips"]) if not f]
            row["fp32_within"] = bool(unflipped) and all(
                e <= (FLIPPED_MAX_REL_ERR if f else MAX_REL_ERR) for e, f in zip(row["fp32_rel_err"], row["switch_flips"]))
            grids = service.run_program(Program("block5_conv1"), xs[:n])["block5_conv1"]
            solo_grids = [service.run_program(Program("block5_conv1"), xs[i : i + 1])["block5_conv1"] for i in range(n)]
            row["bf16_grid_min_psnr_db"] = min(psnr_db(grids["grid"][i], s["grid"][0]) for i, s in enumerate(solo_grids))
            row["bf16_indices_equal"] = all(np.array_equal(grids["indices"][i], s["indices"][0])
                                            for i, s in enumerate(solo_grids))
            ok = (row["same_bucket_indices_equal"] and row["same_bucket_elementwise_outside"] == 0
                  and row["indices_equal"] and row["fp32_within"] and row["bf16_indices_equal"]
                  and row["bf16_grid_min_psnr_db"] >= BF16_MIN_PSNR_DB)
            if not np.isfinite(row["bf16_grid_min_psnr_db"]):
                row["bf16_grid_min_psnr_db"] = "identical"
            padded.append(row)
            if not ok:
                failed.append(f"padded VGG16 rows against solo runs: {row}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    out["padded_vs_solo"] = padded

    svc, dxs = dream["service"], dream["xs"]
    dbundle, dream_req = svc.bundle, Dream(svc.bundle.dream_layers)
    layers, size = dbundle.dream_layers, dbundle.image_size
    shapes = octave_shapes(size, size, DREAM_DEFAULTS["octaves"], 1.4, dbundle.min_dream_size)
    lr = DREAM_DEFAULTS["lr"]
    # held: the whole default dream in float64 (far from every ReLU kink),
    # 3 images padded to bucket 4 against each solo, through the captured
    # programs; and one float32 ascent step of the top rung, bucket 4
    # against bucket 1 from the same inputs, at the dream step bars
    p64 = tree_map(lambda t: t.double(), dbundle.params)
    fwd, cache64 = dbundle.dream_forward(layers), ProgramCache(dbundle.device)

    def dream64(x):  # as DeconvService.run_dream, in float64
        rungs = dream_programs(cache64, fwd, p64, layers, shapes, tuple(x.shape), torch.float64)
        with cache64.replaying():
            return tuple(t.cpu() for t in run_dream_programs(rungs, x.cuda(), DREAM_DEFAULTS["steps"], lr))

    x64 = torch.from_numpy(pad_to_bucket(dxs[:3], 4)).double()
    got_x, got_l = dream64(x64)
    solo = [dream64(x64[i : i + 1]) for i in range(3)]
    d64 = {"images": 3, "bucket": 4,
           "max_abs_err": max(float((got_x[i] - s[0][0]).abs().max()) for i, s in enumerate(solo)),
           "within": all(torch.allclose(got_x[i], s[0][0], rtol=DREAM_RTOL, atol=DREAM_ATOL)
                         and torch.allclose(got_l[i], s[1][0], rtol=DREAM_RTOL) for i, s in enumerate(solo))}
    del cache64, p64
    steps = {b: dbundle.dream_program(layers, shapes, b)[-1][1] for b in (4, 1)}
    xs4 = torch.from_numpy(pad_to_bucket(dxs[:3], 4))
    with dbundle.dream_programs.replaying():
        steps[4].load(xs4, torch.tensor(lr))
        l4, x4 = steps[4].replay().cpu(), steps[4].static[0].cpu()
        one = []
        for i in range(3):
            steps[1].load(xs4[i : i + 1], torch.tensor(lr))
            one.append((steps[1].replay().cpu(), steps[1].static[0].cpu()))
    f32 = {"step_max_abs_err": max(float((x4[i] - o[1][0]).abs().max()) for i, o in enumerate(one)),
           "step_min_uint8_psnr_db": min(psnr_db(dbundle.unpreprocess(x4[i].numpy()), dbundle.unpreprocess(o[1][0].numpy()))
                                         for i, o in enumerate(one)),
           "step_loss_rel_err": max(abs(float(l4[i]) / float(o[0][0]) - 1) for i, o in enumerate(one)),
           "step_min_update_snr_db": min(float(10 * torch.log10(
               (o[1][0].double() - xs4[i].double()).square().sum()
               / (x4[i].double() - o[1][0].double()).square().sum())) for i, o in enumerate(one))}
    f32_ok = (f32["step_min_uint8_psnr_db"] >= DREAM_MIN_PSNR_DB and f32["step_loss_rel_err"] <= DREAM_LOSS_REL_ERR
              and f32["step_min_update_snr_db"] >= DREAM_MIN_PSNR_DB)
    # reported: the whole float32 dream, padded against solo
    got_x, got_l = svc.run_dream(dream_req, dxs[:3])  # bucket 4
    solo = [svc.run_dream(dream_req, dxs[i : i + 1]) for i in range(3)]
    out["padded_dream_vs_solo"] = {
        "float64_whole_dream": d64, "float32_top_rung_step": f32,
        "float32_whole_dream_reported": {
            "max_abs_err": max(float(np.abs(got_x[i] - s[0][0]).max()) for i, s in enumerate(solo)),
            "within": all(np.allclose(got_x[i], s[0][0], rtol=DREAM_RTOL, atol=DREAM_ATOL) for i, s in enumerate(solo)),
            "loss_rel_err": max(abs(float(got_l[i]) / float(s[1][0]) - 1) for i, s in enumerate(solo))}}
    if not (d64["within"] and f32_ok):
        failed.append(f"padded dream rows against solo dreams: {out['padded_dream_vs_solo']}")

    # one captured ascent step against one eager step, at the top rung
    x = torch.from_numpy(dxs[:1]).cuda()
    _, step = dbundle.dream_program(layers, shapes, 1)[-1]
    with dbundle.dream_programs.replaying():
        step.load(x, torch.tensor(lr))
        cap_l = step.replay().cpu()
        cap_x = step.static[0].cpu()
    eag_x, eag_l = (t.cpu() for t in _ascend(dbundle.dream_forward(layers), dbundle.params, x, layers, 1, lr))
    moved, want = (cap_x.double() - x.cpu().double()), (eag_x.double() - x.cpu().double())
    snr = float(10 * torch.log10(want.square().sum() / (moved - want).square().sum()))
    step_row = {"byte_equal": bool(torch.equal(cap_x, eag_x) and torch.equal(cap_l, eag_l)),
                "max_abs_err": float((cap_x - eag_x).abs().max()),
                "uint8_psnr_db": psnr_db(dbundle.unpreprocess(cap_x[0].numpy()), dbundle.unpreprocess(eag_x[0].numpy())),
                "loss_rel_err": float(((cap_l - eag_l).abs() / eag_l.abs()).max()),
                "update_snr_db": snr if np.isfinite(snr) else "identical"}
    if not (step_row["byte_equal"] or (step_row["uint8_psnr_db"] >= DREAM_MIN_PSNR_DB
                                      and step_row["loss_rel_err"] <= DREAM_LOSS_REL_ERR and snr >= DREAM_MIN_PSNR_DB)):
        failed.append(f"captured ascent step against eager: {step_row}")
    if not np.isfinite(step_row["uint8_psnr_db"]):
        step_row["uint8_psnr_db"] = "identical"
    out["dream_step_captured_vs_eager"] = step_row
    cap_dream = svc.run_dream(dream_req, dxs[:1])
    eag_dream = [t.cpu().numpy() for t in eager_dream(torch, dbundle, x, shapes)]
    scale = float(np.abs(eag_dream[0]).max())
    psnr = psnr_db(dbundle.unpreprocess(cap_dream[0][0]), dbundle.unpreprocess(eag_dream[0][0]))
    out["dream_captured_vs_eager_reported"] = {
        "rel_err": float(np.abs(cap_dream[0] - eag_dream[0]).max()) / scale,
        "uint8_psnr_db": psnr if np.isfinite(psnr) else "identical",
        "loss_rel_err": float(abs(cap_dream[1][0] / eag_dream[1][0] - 1))}

    torch.cuda.synchronize()
    out["graph_counts"] = dict(ops.graph_counts)
    out["memory"] = {"reserved_bytes": torch.cuda.memory_reserved(), "allocated_bytes": torch.cuda.memory_allocated(),
                     "programs": [[b.name, len(b.programs), len(b.dream_programs)]
                                  for b in (vgg16, dbundle, *dag["bundles"].values())]}
    out["failed"] = failed
    emit(out)
    if failed:
        raise AssertionError(f"capture phase: {len(failed)} bar(s) missed: {failed}")


# --- phase 10 ------------------------------------------------------------------

MULTI_SERVED = ("vgg16", "resnet50", "inception_v3", "mobilenet_v2")
MULTI_LAYERS = {"vgg16": "block5_conv1", "resnet50": "conv5_block3_out", "inception_v3": "mixed10",
                "mobilenet_v2": "out_relu"}


def pool_blocks(torch, pool) -> list:
    """The blocks of the graph memory pool ``pool`` still allocated, as
    (size, state): what keeps its segments from being freed."""
    return [(b["size"], b["state"]) for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool)
            for b in seg["blocks"] if b["state"] != "inactive"]


class _SizedBundle:
    """A model whose weights are one f32 tensor of ``nbytes`` on the CPU:
    the stand-in for a served model in the CPU replay of the multi-model
    server's residency."""

    def __init__(self, torch, name: str, nbytes: int):
        self.name, self.device = name, torch.device("cpu")
        self.params = {"w": torch.empty(nbytes // 4)}
        self.weight_dtype, self.managed, self.stored = "f32", False, None

    def page_out(self) -> None:
        self.stored = None


def phase_multi_model(torch, uris: list, label: str) -> dict:
    """One server of four models on the card under a budget that holds three
    (VGG16 the default, ResNet50 pinned, InceptionV3 and MobileNet v2 on
    demand): requests InceptionV3, MobileNet v2 (which evicts InceptionV3),
    InceptionV3 (which evicts MobileNet v2), VGG16, ResNet50 and a small
    InceptionV3 dream, each step's residency and page counts held against
    a CPU replay of the same sequence through the port's manager; then
    VGG16 unpinned and paged out under a lowered budget, and served again
    from graphs captured anew.  Checks: the evicted models' weights, graphs
    and pools freed, InceptionV3's grid after its page-in against its grid
    before, VGG16's byte-equal under ``cudnn.deterministic`` (both its
    captures ran under it), K1 and K2 in VGG16's new graphs, and no model
    with a batch in flight ever evicted."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.crosscheck import psnr_db
    from deconv_api_tpu_torch.serving.app import pool_bytes
    from deconv_api_tpu_torch.serving.models import build_bundle
    from deconv_api_tpu_torch.serving.weight_manager import WeightManager, tree_nbytes

    sizes = {m: tree_nbytes(build_bundle(m, "cpu").params) for m in MULTI_SERVED}
    budget = sizes["vgg16"] + sizes["resnet50"] + sizes["inception_v3"] + sizes["mobilenet_v2"] // 2
    replay = WeightManager({m: (lambda m=m: _SizedBundle(torch, m, sizes[m])) for m in MULTI_SERVED}, "vgg16",
                           pinned=("resnet50",), budget_bytes=budget)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # VGG16's boot graphs
    torch.cuda.empty_cache()
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda", "--max-batch", str(B),
                           "--serve-models", ",".join(MULTI_SERVED), "--pinned-models", "resnet50",
                           "--hbm-budget-bytes", str(budget), *CACHE_OFF_FLAGS])
    boot_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = deterministic
    service, port = server.service, server.server_address[1]
    weights = service.weights
    warm = {m: warmup_report(torch, service, reserved0, weights.peek_bundle(m)) for m in ("vgg16", "resnet50")}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    for m in ("vgg16", "resnet50"):  # the warmup's checkouts
        replay.checkout(m)
        replay.release(m)
    steps, per_model = [], {}

    def step(what: str, model: str | None = None) -> None:
        """``model``'s checkout in the replay, then both snapshots held equal."""
        if model is not None:
            replay.checkout(model)
            replay.release(model)
        got, want = weights.snapshot(), replay.snapshot()
        if got != want:
            raise AssertionError(f"multi_model after {what}: server {got}, CPU replay {want}")
        steps.append({"step": what, "resident": got["lanes"]["0"]["resident"], "bytes": got["lanes"]["0"]["bytes"],
                      "page_ins": got["page_ins"], "page_outs": got["page_outs"], "overcommits": got["overcommits"]})

    def serve(model: str, path: str = "/", **form) -> dict:
        """One request for ``model``; what its model's page-in and captures cost."""
        bundle = weights.peek_bundle(model)
        before = {id(p) for b in (bundle,) if b is not None for c in (b.programs, b.dream_programs)
                  for p in c.programs().values()}
        ins = weights.page_ins
        alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        form = {"file": uris[0], "model": model, **form}
        status, body, secs = _post(port, path, form)
        if status != 200:
            raise AssertionError(f"multi_model {model} POST {path}: {status} {str(body)[:300]}")
        bundle = weights.peek_bundle(model)
        new = [p for c in (bundle.programs, bundle.dream_programs) for p in c.programs().values()
               if id(p) not in before]
        entry = {"model": model, "path": path, "seconds": secs, "paged_in": weights.page_ins > ins,
                 "page_in_ms": weights.page_in_s[model] * 1e3 if weights.page_ins > ins else 0.0,
                 "captures": len(new), "capture_s": sum(p.capture_s for p in new),
                 "allocated_delta": torch.cuda.memory_allocated() - alloc0,
                 "reserved_delta": torch.cuda.memory_reserved() - res0}
        per_model.setdefault(model, []).append(entry)
        step(f"POST {path} {model}", model)
        return body

    def grid(model: str, xs) -> dict:
        out = service.visualize_batch(MULTI_LAYERS[model], xs, model=model)
        replay.checkout(model)
        replay.release(model)
        return out

    out = {"phase": "multi_model", "card": label, "server_cache": cache_state(service),
           "served": list(MULTI_SERVED), "default": "vgg16",
           "pinned": list(weights.pinned), "budget_bytes": budget, "weight_bytes": sizes, "boot_s": boot_s,
           "warmup": warm, "warmup_wall_s_by_model": dict(service.warmup_wall_s_by_model)}
    try:
        step("boot")
        ops.reset_launch_counts()
        inc = weights.bundle("inception_v3")
        x_inc = service.decode_preprocess(uris[1], inc)[None]
        serve("inception_v3", layer="mixed10")
        before = grid("inception_v3", x_inc)
        pools = {"deconv": inc.programs.pool, "dream": inc.dream_programs.pool}
        pool_before = {k: pool_bytes(p) for k, p in pools.items()}
        serve("mobilenet_v2", layer="out_relu")  # evicts InceptionV3
        freed = {k: pool_bytes(p) for k, p in pools.items()}
        if inc.stored is not None or len(inc.programs) or any(freed.values()):
            raise AssertionError(f"InceptionV3's page-out left {len(inc.programs)} programs, pools {freed}, "
                                 f"blocks {[pool_blocks(torch, p) for p in pools.values()]}")
        out["inception_v3_page_out"] = {"pool_bytes_before": pool_before, "pool_bytes_after": freed,
                                        "allocated_delta": per_model["mobilenet_v2"][0]["allocated_delta"],
                                        "reserved_delta": per_model["mobilenet_v2"][0]["reserved_delta"]}
        serve("inception_v3", layer="mixed10")  # evicts MobileNet v2
        after = grid("inception_v3", x_inc)
        repaged = {"min_psnr_db": min(psnr_db(a, b) for a, b in zip(before["grid"], after["grid"])),
                   "indices_equal": bool((before["indices"] == after["indices"]).all())}
        out["inception_v3_repaged_vs_before"] = repaged
        if not repaged["indices_equal"] or repaged["min_psnr_db"] < 65.0:
            raise AssertionError(f"InceptionV3 after its page-in: {repaged}")
        serve("vgg16", layer="block5_conv1")
        vgg = service.bundle
        xs = np.stack([service.decode_preprocess(u, vgg) for u in uris[:B]])
        g1 = grid("vgg16", xs)  # from the boot's graph, captured under cudnn.deterministic
        serve("resnet50", layer="conv5_block3_out")
        body = serve("inception_v3", "/v1/dream", steps="2", octaves="2")
        out["dream"] = _check_dream(200, body, "multi_model inception_v3 dream", inc.image_size, inc.dream_layers)
        torch.cuda.synchronize()
        counts = ops.launch_counts()

        # VGG16, the least recently used, unpinned and paged out under a
        # lowered budget, then served again
        pools = {"deconv": vgg.programs.pool, "dream": vgg.dream_programs.pool}
        pool_before = {k: pool_bytes(p) for k, p in pools.items()}
        for m in (weights, replay):
            m.pinned, m.budget_bytes = ("resnet50",), budget - sizes["vgg16"]
        torch.cuda.synchronize()
        alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        evicted = weights.enforce_budget()
        alloc1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        if replay.enforce_budget() != evicted or evicted != ["vgg16"]:
            raise AssertionError(f"the lowered budget evicted {evicted}")
        step("vgg16 unpinned, budget lowered")
        page_out = {"allocated_freed": alloc0 - alloc1, "reserved_freed": res0 - res1,
                    "weight_bytes": sizes["vgg16"], "pool_bytes_before": pool_before,
                    "pool_bytes_after": {k: pool_bytes(p) for k, p in pools.items()}}
        out["vgg16_page_out"] = page_out
        if (page_out["allocated_freed"] < sizes["vgg16"] or page_out["reserved_freed"] < sum(pool_before.values())
                or any(page_out["pool_bytes_after"].values())):
            raise AssertionError(f"VGG16's page-out: {page_out}, blocks {[pool_blocks(torch, p) for p in pools.values()]}")
        for m in (weights, replay):
            m.pinned, m.budget_bytes = ("vgg16", "resnet50"), budget
        torch.backends.cudnn.deterministic = True  # VGG16's new graphs
        ops.reset_launch_counts()
        serve("vgg16", layer="block5_conv1")
        torch.cuda.synchronize()
        vgg_counts = ops.launch_counts()
        g2 = grid("vgg16", xs)
        torch.backends.cudnn.deterministic = deterministic
        recaptured = [p.kernels for p in vgg.programs.programs().values()]
        same = bool((g1["grid"] == g2["grid"]).all() and (g1["indices"] == g2["indices"]).all())
        out["vgg16_recaptured"] = {"byte_equal": same, "graph_kernels": recaptured, "launches": vgg_counts}
        if not same:
            raise AssertionError("VGG16's grid from its new graphs differs from its boot graphs'")
        if not (vgg_counts["pool_argmax"] > 0 and vgg_counts["unpool_argmax"] > 0):
            raise AssertionError(f"VGG16's new graphs launched no K1 or K2: {vgg_counts}")

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=30) as r:
            readyz = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/config", timeout=30) as r:
            config = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        inflight = service.metrics.counter("weight_evict_inflight_total")
        out.update(steps=steps, per_model=per_model, readyz=readyz, graph_pool_bytes=config["graph_pool_bytes"],
                   weights=config["weights"], evict_inflight_total=inflight, launches=counts,
                   page_ins=weights.page_ins, page_outs=weights.page_outs)
        if config["weights"] != weights.snapshot() or readyz["models"] != weights.ready_block() or not readyz["ready"]:
            raise AssertionError(f"/readyz {readyz}, /v1/config weights {config['weights']}")
        if inflight != 0 or "deconv_weight_evict_inflight_total 0" not in metrics.splitlines():
            raise AssertionError(f"a model with a batch in flight was evicted: {inflight}")
        emit(out)
        return {"counts": counts, "vgg16_counts": vgg_counts}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)


# --- phase 11 ------------------------------------------------------------------

LOAD_LAYER = "block5_conv1"
LOAD_CLIENTS = 256  # concurrent keep-alive clients (BASELINE.json config 5)
LOAD_PROCS = 4  # client processes, LOAD_CLIENTS / LOAD_PROCS threads each
LOAD_IMAGES = 16  # distinct 256x240 PNGs
LOAD_RUNS = (1, 2)  # pipeline_depth of each run, in turns
LOAD_REQUESTS = 1024  # per run
OWN_PSNR_DB = 52.0  # an answer against its own image's reference
OTHER_PSNR_DB = 30.0  # ... and against every other image's, at most
SHED_BURST, SHED_TIMEOUT_S = 512, 15.0  # the shed drill's burst and request timeout


def _load_client(port: int, bodies: list, refs_path: str, n_threads: int, n_requests: int, first: int,
                 ready, go, out_q) -> None:
    """One client process: ``n_threads`` keep-alive ``http.client``
    connections share ``n_requests`` ``POST /`` (request k posts image
    ``(first + k) % len(bodies)``).  After the timed part it checks every
    200 answer against the references in ``refs_path``, the data URLs the
    server sends for each image alone at each bucket and row: the same data URL as
    one of its own image's, else its decoded JPEG within OWN_PSNR_DB of one
    of them (JPEG against JPEG: against the raw grid the encode alone costs
    some 24 dB) and at most OTHER_PSNR_DB of every other image's.  Puts one
    summary dict on ``out_q``."""
    import http.client
    import itertools

    import numpy as np

    counter, lock = itertools.count(), threading.Lock()
    records = []
    # connected one by one before the start: a storm of simultaneous
    # connects would overflow the listen backlog (asyncio's default, 100)
    conns = []
    for _ in range(n_threads):
        conns.append(http.client.HTTPConnection("127.0.0.1", port, timeout=120))
        conns[-1].connect()

    def worker(conn):
        go.wait()
        while True:
            with lock:
                k = next(counter)
            if k >= n_requests:
                break
            img = (first + k) % len(bodies)
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/", body=bodies[img],
                             headers={"content-type": "application/x-www-form-urlencoded"})
                resp = conn.getresponse()
                body = resp.read()
                status, retry = resp.status, resp.getheader("retry-after")
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                status, body, retry = -1, repr(e).encode(), None
            records.append((img, status, time.perf_counter() - t0, time.time(), body, retry))
        conn.close()

    threads = [threading.Thread(target=worker, args=(c,)) for c in conns]
    for t in threads:
        t.start()
    ready.put(os.getpid())
    go.wait()
    t_start = time.time()
    cpu0 = time.process_time()
    for t in threads:
        t.join()
    cpu_s = time.process_time() - cpu0
    with open(refs_path) as f:
        ref_urls = json.load(f)
    exact = {img: set(urls) for img, urls in enumerate(ref_urls)}
    decoded = {}  # (image, bucket) -> the reference's decoded JPEG
    out = {"pid": os.getpid(), "t_start": t_start, "t_end": max(r[3] for r in records), "cpu_s": cpu_s, "statuses": {},
           "errors": {}, "latency_s": [], "exact": 0, "psnr_checked": 0, "min_own_psnr": None,
           "max_other_psnr": None, "failures": [], "retry_after": []}
    for img, status, secs, _, body, retry in records:
        out["statuses"][status] = out["statuses"].get(status, 0) + 1
        if status != 200:
            try:
                code = json.loads(body).get("error")
            except (ValueError, AttributeError):
                code = body[:80].decode("utf-8", "replace")
            out["errors"][f"{status} {code}"] = out["errors"].get(f"{status} {code}", 0) + 1
            if retry is not None:
                out["retry_after"].append(int(retry))
            continue
        out["latency_s"].append(secs)
        url = json.loads(body)
        if url in exact[img]:
            out["exact"] += 1
            continue
        for j, urls_j in enumerate(ref_urls):
            for b, u in enumerate(urls_j):
                if (j, b) not in decoded:
                    decoded[j, b] = _decode_jpeg_url(u)
        got = _decode_jpeg_url(url)
        psnr = [[_psnr(got, decoded[j, b]) for b in range(len(urls_j))] for j, urls_j in enumerate(ref_urls)]
        own = max(psnr[img])
        other = max(max(p) for j, p in enumerate(psnr) if j != img)
        out["psnr_checked"] += 1
        out["min_own_psnr"] = own if out["min_own_psnr"] is None else min(out["min_own_psnr"], own)
        out["max_other_psnr"] = other if out["max_other_psnr"] is None else max(out["max_other_psnr"], other)
        if own < OWN_PSNR_DB or other > OTHER_PSNR_DB:
            out["failures"].append({"image": img, "own_psnr": own, "other_psnr": other})
    out_q.put(out)


def _decode_jpeg_url(url: str):
    """A served data URL's JPEG as float64 BGR pixels."""
    import cv2
    import numpy as np

    raw = base64.b64decode(urllib.parse.unquote(url.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR).astype(np.float64)


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * float(np.log10(255.0**2 / mse))


def _quantiles(values: list) -> dict:
    import numpy as np

    if not values:
        return {}
    ms = np.asarray(values) * 1e3
    return {f"p{q}_ms": float(np.percentile(ms, q)) for q in (50, 90, 99)}


@contextlib.contextmanager
def replay_events(torch):
    """A CUDA event pair recorded around every graph replay while the block
    runs (on the replaying thread's stream, inside the dispatch step):
    yields the list of (start, end) pairs, whose elapsed times sum to the
    card's time in the replays."""
    from deconv_api_tpu_torch.engine.capture import CapturedProgram

    pairs, real = [], CapturedProgram.replay

    def replay(self):
        if self.graph is None:
            return real(self)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(self)
        end.record()
        pairs.append((start, end))
        return out

    CapturedProgram.replay = replay
    try:
        yield pairs
    finally:
        CapturedProgram.replay = real


def _span_totals(service) -> dict:
    """The flight recorder's per-span (count, seconds) totals so far."""
    with service.recorder._lock:
        return {k: (v[0], v[1]) for k, v in service.recorder._span_stats.items()}


def _drive_load(torch, server, bodies: list, refs_path: str, n_requests: int, first: int = 0,
                clients: int = LOAD_CLIENTS) -> dict:
    """``n_requests`` ``POST /`` from ``clients`` keep-alive clients in
    LOAD_PROCS spawned processes, all started together.  Returns the run's
    images/s, latency quantiles, status counts, batch-size histogram, the
    card's busy share (CUDA events around the replays), the server
    process's CPU time, each request span's mean, and the clients' checks
    of every 200 answer."""
    import multiprocessing

    service, port = server.service, server.server_address[1]
    deadline = time.monotonic() + 10
    while service.server._nconn and time.monotonic() < deadline:  # the last run's sockets closed
        time.sleep(0.05)
    ctx = multiprocessing.get_context("spawn")
    ready, out_q, go = ctx.Queue(), ctx.Queue(), ctx.Event()
    per = clients // LOAD_PROCS
    share = [n_requests // LOAD_PROCS + (i < n_requests % LOAD_PROCS) for i in range(LOAD_PROCS)]
    procs = [ctx.Process(target=_load_client, args=(port, bodies, refs_path, per, share[i], first + i, ready, go,
                                                    out_q), daemon=True) for i in range(LOAD_PROCS)]
    try:
        for p in procs:
            p.start()
        for _ in procs:
            ready.get(timeout=120)
        service.batch_sizes.clear()
        replays0, spans0 = ops_graph_replays(), _span_totals(service)
        with replay_events(torch) as pairs:
            cpu0 = time.process_time()
            go.set()
            results = [out_q.get(timeout=600) for _ in procs]
            cpu_s = time.process_time() - cpu0
        torch.cuda.synchronize()
        replay_ms = sum(start.elapsed_time(end) for start, end in pairs)
        spans1 = _span_totals(service)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    statuses, errors_ = collections.Counter(), collections.Counter()
    latencies, failures, retry = [], [], []
    for r in results:
        statuses.update({int(k): v for k, v in r["statuses"].items()})
        errors_.update(r["errors"])
        latencies += r["latency_s"]
        failures += r["failures"]
        retry += r["retry_after"]
    wall = max(r["t_end"] for r in results) - min(r["t_start"] for r in results)
    spans = {k: (n - spans0.get(k, (0, 0.0))[0], t - spans0.get(k, (0, 0.0))[1]) for k, (n, t) in spans1.items()}
    own = [r["min_own_psnr"] for r in results if r["min_own_psnr"] is not None]
    other = [r["max_other_psnr"] for r in results if r["max_other_psnr"] is not None]
    return {
        "requests": n_requests, "wall_s": wall, "images_per_s": statuses[200] / wall,
        **_quantiles(latencies), "statuses": dict(statuses), "errors": dict(errors_),
        "n_503": statuses[503], "n_504": statuses[504],
        "batch_size_histogram": dict(sorted(collections.Counter(service.batch_sizes).items())),
        "replays": ops_graph_replays() - replays0, "replay_ms": replay_ms,
        "device_busy_share": replay_ms / 1e3 / wall, "host_cpus": os.cpu_count(),
        "server_cpu_cores": cpu_s / wall, "server_cpu_ms_per_request": cpu_s * 1e3 / n_requests,
        "client_cpu_cores": sum(r["cpu_s"] for r in results) / wall,
        "span_mean_ms": {k: t * 1e3 / n for k, (n, t) in sorted(spans.items()) if n},
        "answers_exact": sum(r["exact"] for r in results), "answers_psnr_checked": sum(r["psnr_checked"] for r in results),
        "min_own_psnr_db": min(own) if own else None, "max_other_psnr_db": max(other) if other else None,
        "failures": failures[:10], "n_failures": len(failures), "retry_after": sorted(set(retry)),
    }


def ops_graph_replays() -> int:
    from deconv_api_tpu_torch import ops

    return ops.graph_counts["replays"]


def _second_server(torch, bundle, **cfg):
    """A warmed, started server of the same VGG16 bundle (its captured
    programs are the bundle's, so the warmup only fills the rings) with
    ``cfg`` over the defaults, the cache off unless ``cfg`` turns it on."""
    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService

    service = DeconvService(bundle, ServerConfig(model=bundle.name, max_batch=B, **{**CACHE_OFF, **cfg}))
    service.start()
    service.warmup()
    return DeconvHTTPServer(service, "127.0.0.1", 0)


def _request(port: int, path: str, method: str = "GET", form: dict | None = None, headers=None):
    """(status, JSON body, headers) of one request."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        body = urllib.parse.urlencode(form).encode() if form is not None else None
        conn.request(method, path, body=body, headers={"content-type": "application/x-www-form-urlencoded",
                                                       **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def _burst(port: int, bodies: list, n: int, threads: int) -> list:
    """``n`` concurrent ``POST /`` over ``threads`` connections of this
    process: [(status, error code, retry-after, seconds)]."""
    import concurrent.futures
    import http.client

    def one(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/", body=bodies[i % len(bodies)],
                         headers={"content-type": "application/x-www-form-urlencoded"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            return (resp.status, body.get("error") if isinstance(body, dict) else None, resp.getheader("retry-after"),
                    time.perf_counter() - t0)
        finally:
            conn.close()

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        return list(pool.map(one, range(n)))


def cold_capture_stall(torch, server, uris: list, bodies: list) -> dict:
    """What one cold capture does to concurrent ``POST /``: a burst of 128
    over 32 connections of this process alone, then the same burst with a
    ``/v1/deconv sweep=true`` whose program no warmup captured posted 0.3 s
    in.  The capture holds ``DEVICE_LOCK`` exclusively, so every
    dispatcher's device work and every fetch's event poll waits for it."""
    from deconv_api_tpu_torch import ops

    port = server.server_address[1]
    alone = [r[3] for r in _burst(port, bodies, 128, 32)]
    sweep, captures0 = {}, ops.graph_counts["captures"]

    def post_sweep():
        time.sleep(0.3)
        t0 = time.perf_counter()
        status, body, _ = _request(port, "/v1/deconv", "POST", {"file": uris[0], "layer": LOAD_LAYER, "sweep": "true"})
        sweep.update(status=status, seconds=time.perf_counter() - t0, layers=len(body.get("layers", {})))

    thread = threading.Thread(target=post_sweep)
    thread.start()
    during = [r[3] for r in _burst(port, bodies, 128, 32)]
    thread.join(300)
    return {"sweep": sweep, "captures": ops.graph_counts["captures"] - captures0,
            "post_alone": {**_quantiles(alone), "max_ms": max(alone) * 1e3},
            "post_during_capture": {**_quantiles(during), "max_ms": max(during) * 1e3}}


def host_costs_ms(service, uri: str, body: bytes, grid) -> dict:
    """The server's per-request host work, one call at a time on this
    process's main thread (median of 20): the form parse of a request body,
    the image's decode and preprocess, and the grid's JPEG data URL."""
    from deconv_api_tpu_torch.serving import codec

    def median_ms(fn):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {"form_parse": median_ms(lambda: urllib.parse.parse_qsl(body.decode(), keep_blank_values=True)),
            "decode_preprocess": median_ms(lambda: service.decode_preprocess(uri)),
            "encode_data_url": median_ms(lambda: codec.encode_data_url(grid)),
            "body_bytes": len(body)}


def _stop(server) -> None:
    server.shutdown()
    server.server_close()
    server.service.close()


def load_drills(torch, bundle, uris: list, bodies: list, refs_path: str) -> dict:
    """The deadline, shed and breaker drills on servers of the same bundle;
    each fails the phase unless it answers as it should."""
    out = {}
    form = {"file": uris[0], "layer": LOAD_LAYER}
    # deadline: x-deadline-ms 1 while a burst fills the queue
    server = _second_server(torch, bundle)
    port, service = server.server_address[1], server.service
    try:
        before = service.metrics.counter("deadline_expired_total")
        burst = threading.Thread(target=_burst, args=(port, bodies, 256, 128))
        burst.start()
        time.sleep(0.05)
        status, body, _ = _request(port, "/", "POST", form, {"x-deadline-ms": "1"})
        burst.join(120)
        after = service.metrics.counter("deadline_expired_total")
        out["deadline"] = {"status": status, "error": body.get("error"), "deadline_expired_total": [before, after],
                           "server_cache": cache_state(service)}
        if (status, body.get("error")) != (504, "deadline_expired") or after <= before:
            raise AssertionError(f"deadline drill: {out['deadline']}")
    finally:
        _stop(server)
    # shed: SHED_BURST concurrent clients against a SHED_TIMEOUT_S request
    # timeout, shedding at a 1 s drain estimate, once the server has
    # measured its batches.  Each dispatch is held 100 ms
    # (device.dispatch_delay_ms), so the queue in front of the dispatcher
    # grows: without it the host's parse and decode, which come before the
    # queue, bound the rate below the card's and the queue never fills.  A
    # request is shed after its decode, and an admitted batch's grid
    # encodes wait on the codec pool behind the burst's decodes (6 s for
    # the whole burst on the H100's host): the timeout leaves room for both.
    server = _second_server(torch, bundle, request_timeout_s=SHED_TIMEOUT_S, shed_factor=1.0 / SHED_TIMEOUT_S,
                            max_connections=2 * SHED_BURST, faults="device.dispatch_delay_ms=p1:100")
    try:
        _drive_load(torch, server, bodies, refs_path, 256, clients=64)
        burst = _drive_load(torch, server, bodies, refs_path, SHED_BURST, clients=SHED_BURST)
        out["shed"] = {k: burst[k] for k in ("statuses", "errors", "retry_after", "n_failures", "wall_s")}
        out["shed"]["server_cache"] = cache_state(server.service)
        if (not burst["errors"].get("503 overloaded") or not burst["retry_after"] or min(burst["retry_after"]) < 1
                or burst["errors"].get("504 request_timeout") or burst["n_failures"]):
            raise AssertionError(f"shed drill: {out['shed']}")
    finally:
        _stop(server)
    # breaker: device.dispatch_error armed for breaker_threshold dispatches
    server = _second_server(torch, bundle, fault_injection=True, breaker_cooldown_s=1.0)
    port, service = server.server_address[1], server.service
    try:
        threshold = service.cfg.breaker_threshold
        service.faults.arm("device.dispatch_error", f"n{threshold}")
        failed = [_request(port, "/", "POST", form)[:2] for _ in range(threshold)]
        ready_open = _request(port, "/readyz")
        rejected = _request(port, "/", "POST", form)
        time.sleep(service.cfg.breaker_cooldown_s + 0.1)
        probe = _request(port, "/", "POST", form)
        ready_closed = _request(port, "/readyz")
        b = out["breaker"] = {
            "threshold": threshold, "failed": [[s, body.get("error")] for s, body in failed],
            "readyz_open": [ready_open[0], ready_open[1]["checks"]["breaker_not_open"]],
            "rejected": [rejected[0], rejected[1].get("error"), rejected[2].get("retry-after")],
            "probe": probe[0], "readyz_closed": ready_closed[0], "state": service.lane_pool.state_name(),
            "breaker_open_total": service.metrics.counter("breaker_open_total"),
            "server_cache": cache_state(service),
        }
        if (any(f != [500, "fault_injected"] for f in b["failed"]) or b["readyz_open"] != [503, False]
                or b["rejected"][:2] != [503, "breaker_open"] or int(b["rejected"][2] or 0) < 1
                or b["probe"] != 200 or b["readyz_closed"] != 200 or b["state"] != "closed"):
            raise AssertionError(f"breaker drill: {b}")
    finally:
        _stop(server)
    return out


def sync_check(torch, service, uris: list) -> dict:
    """One dispatch step each of the grid, tiles and dream programs under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in them
    raises.  Their fetches must return what a plain run returns."""
    import numpy as np

    from deconv_api_tpu_torch.serving.app import DEFAULT_TOP_K, Dream, Program

    bundle = service.bundle
    xs = np.stack([service.decode_preprocess(u) for u in uris[:B]])
    grid, tiles = Program(LOAD_LAYER), Program(LOAD_LAYER, top_k=DEFAULT_TOP_K, post="tiles")
    dream = Dream(bundle.dream_layers)
    steps = {"grid": (lambda: service._enqueue_program(grid, xs), lambda: service.run_program(grid, xs)),
             "tiles": (lambda: service._enqueue_program(tiles, xs), lambda: service.run_program(tiles, xs)),
             "dream": (lambda: service._enqueue_dream(dream, xs[:4]), lambda: service.run_dream(dream, xs[:4]))}
    out = {}
    for name, (dispatch, plain) in steps.items():
        want = plain()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            fetch = dispatch()
            dispatch_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = fetch()
        if name == "dream":
            ok = bool(np.isfinite(got[0]).all() and got[0].shape == want[0].shape)
        else:
            ok = all(np.array_equal(got[LOAD_LAYER][k], want[LOAD_LAYER][k]) for k in want[LOAD_LAYER])
        out[name] = {"dispatch_ms": dispatch_ms, "equal_to_plain_run": ok}
        if not ok:
            raise AssertionError(f"sync check {name}: the fetched rows differ from a plain run")
    return out


def load_at_defaults(torch, bundle, bodies: list, refs_path: str, label: str) -> dict:
    """One more load turn of LOAD_REQUESTS over the same images, on a
    server of the same bundle at every default (the response cache and
    singleflight on, ``pipeline_depth`` 2) with ``--slo api=3000:99 --tsdb
    on``: images/s and latency as the cache-off turns print them, the
    cache's hits, coalesced answers and misses, the rows the card computed,
    and, read back after one more scrape tick, the
    ``request_duration_seconds`` history from ``/v1/metrics/history`` and
    the ``api`` SLO's 5m burn rate from the history and from ``/metrics``.
    The launch counts are read around the turn alone."""
    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.config import ServerConfig

    defaults = ServerConfig()
    server = _second_server(torch, bundle, cache_bytes=defaults.cache_bytes, singleflight=defaults.singleflight,
                            slos="api=3000:99", tsdb="on")
    service, port = server.service, server.server_address[1]
    names = ("cache_hits_total", "cache_coalesced_total", "cache_misses_total")
    try:
        # one request of another image opens the request_duration series,
        # then a scrape tick takes its baseline before the turn
        _request_raw(port, {"file": image_uris(LOAD_IMAGES + 1)[-1], "layer": LOAD_LAYER})
        time.sleep(1.5 * service.cfg.tsdb_interval_s)
        before = {n: service.metrics.counter(n) for n in names}
        ops.reset_launch_counts()
        run = _drive_load(torch, server, bodies, refs_path, LOAD_REQUESTS)
        torch.cuda.synchronize()
        launches, graph_counts = ops.launch_counts(), dict(ops.graph_counts)
        cache = {n: service.metrics.counter(n) - before[n] for n in names}
        time.sleep(2 * service.cfg.tsdb_interval_s)  # a scrape tick after the last answer
        _, hist, _ = _request(port, "/v1/metrics/history?family=request_duration_seconds_count&range_s=300")
        _, burn, _ = _request(port, "/v1/metrics/history?family=slo_burn_rate&label=slo%3Dapi%2Cwindow%3D5m"
                                    "&range_s=300")
        text = service.metrics_text()
    finally:
        _stop(server)
    burn_line = next((line for line in text.splitlines()
                      if line.startswith('deconv_slo_burn_rate{slo="api",window="5m"}')), None)
    series = hist.get("series") or [{}]
    points = series[0].get("points") or []
    out = {"phase": "load_run_defaults", "card": label, "server_cache": cache_state(service),
           "slos": "api=3000:99", "tsdb": "on", **run, "cache": cache, "launches": launches,
           "graph_counts": graph_counts,
           "rows": sum(k * v for k, v in run["batch_size_histogram"].items()),
           # counters are kept as rates (req/s between ticks); the ticks run
           # on the event loop, and the widest gap between two points shows
           # how late the busy loop let them run
           "request_duration_history": {"label": series[0].get("label"), "tier": series[0].get("tier"),
                                        "points": len(points), "max_rate_per_s": max((p[1] for p in points),
                                                                                     default=None),
                                        "max_gap_s": max((b[0] - a[0] for a, b in zip(points, points[1:])),
                                                         default=None)},
           "slo_burn_rate_5m": {"history_last": (burn.get("series") or [{}])[0].get("points", [[None, None]])[0][1],
                                "metrics_line": burn_line}}
    emit(out)
    if not points or burn_line is None or not burn.get("series"):
        raise AssertionError(f"load at the defaults: no history or no burn rate: {out}")
    return out


def phase_load(torch, label: str) -> dict:
    """BASELINE.json config 5 on one card: 256 concurrent keep-alive
    clients post ``POST /`` (16 distinct 256x240 PNGs) to a VGG16 server at
    every default, block5_conv1, at ``pipeline_depth`` 1 and 2 in turns;
    every 200 answer is checked against its own image's grid served alone
    at every bucket and row.  Then the dispatch step under sync-debug "error", and
    the deadline, shed and breaker drills."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.serving import codec
    from deconv_api_tpu_torch.serving.app import Program
    from deconv_api_tpu_torch.serving.batcher import buckets

    # the servers log each shed and timeout at WARNING: kept off stderr here
    logging.getLogger("deconv").setLevel(logging.ERROR)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    servers = {2: build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda", *CACHE_OFF_FLAGS])}
    boot_s = time.perf_counter() - t0
    bundle = servers[2].service.bundle
    servers[1] = _second_server(torch, bundle, pipeline_depth=1)
    out = {"phase": "load", "card": label, "model": "vgg16", "layer": LOAD_LAYER,
           "server_cache": {d: cache_state(s.service) for d, s in servers.items()}, "clients": LOAD_CLIENTS,
           "client_processes": LOAD_PROCS, "images": LOAD_IMAGES, "boot_s": boot_s, "runs": []}
    try:
        uris = image_uris(LOAD_IMAGES)
        bodies = [urllib.parse.urlencode({"file": u, "layer": LOAD_LAYER}).encode() for u in uris]
        # each image's grid served alone at every bucket, at every row of
        # the batch: a row's bits may depend on its position (the last row
        # of a bucket-4 batch differs from the others by up to 2 levels),
        # never on its batch-mates
        service = servers[2].service
        xs = np.stack([service.decode_preprocess(u) for u in uris])
        sizes = buckets(service.max_batch)
        alone = [{b: service.run_program(Program(LOAD_LAYER), np.repeat(xs[i : i + 1], b, 0))[LOAD_LAYER]["grid"]
                  for b in sizes} for i in range(LOAD_IMAGES)]
        refs = [[g for b in sizes for g in a[b]] for a in alone]
        urls = [sorted({codec.encode_data_url(g) for g in r}) for r in refs]
        # per bucket: the rows whose grid differs from row 0's for some
        # image, and by how many levels at most
        rows_unlike = {b: sorted({r for a in alone for r in range(b) if not np.array_equal(a[b][r], a[b][0])})
                       for b in sizes}
        level_diff = {b: max(int(np.abs(a[b].astype(np.int16) - a[b][0]).max()) for a in alone) for b in sizes}
        jpegs = [_decode_jpeg_url(r[0]) for r in urls]
        cross = max(_psnr(jpegs[i], jpegs[j]) for i in range(LOAD_IMAGES) for j in range(LOAD_IMAGES) if i != j)
        out["references"] = {"buckets": sizes, "distinct_urls_per_image": [len(u) for u in urls],
                             "rows_unlike_row0": rows_unlike, "max_level_diff_from_row0": level_diff,
                             "max_cross_image_psnr_db": cross}
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        refs_path = os.path.join(ROOT, "build", "load_refs.json")
        with open(refs_path, "w") as f:
            json.dump(urls, f)
        if cross > OTHER_PSNR_DB:
            raise AssertionError(f"two load images' grids lie within {cross:.1f} dB of each other")

        out["host_costs_ms"] = host_costs_ms(service, uris[0], bodies[0], refs[0][0])
        for depth in (2, 1):  # a warm-up run of each server, not reported as a turn
            warm = _drive_load(torch, servers[depth], bodies, refs_path, 256)
            emit({"phase": "load_warmup", "card": label, "pipeline_depth": depth,
                  **{k: warm[k] for k in ("images_per_s", "statuses", "n_failures")}})
        ops.reset_launch_counts()
        for k, depth in enumerate(LOAD_RUNS):
            run = {"pipeline_depth": depth, **_drive_load(torch, servers[depth], bodies, refs_path, LOAD_REQUESTS,
                                                         first=k)}
            out["runs"].append(run)
            emit({"phase": "load_run", "card": label, **run})
        torch.cuda.synchronize()
        counts, graph_counts = ops.launch_counts(), dict(ops.graph_counts)
        out["launches"], out["graph_counts"] = counts, graph_counts
        out["defaults_run"] = load_at_defaults(torch, bundle, bodies, refs_path, label)
        defaults_counts = out["defaults_run"]["launches"]
        out["by_depth"] = {
            d: {"images_per_s": [r["images_per_s"] for r in out["runs"] if r["pipeline_depth"] == d],
                "p50_ms": [r.get("p50_ms") for r in out["runs"] if r["pipeline_depth"] == d],
                "p99_ms": [r.get("p99_ms") for r in out["runs"] if r["pipeline_depth"] == d],
                "device_busy_share": [r["device_busy_share"] for r in out["runs"] if r["pipeline_depth"] == d]}
            for d in sorted(set(LOAD_RUNS))}
        out["weight_evict_inflight_total"] = sum(s.service.metrics.counter("weight_evict_inflight_total")
                                                 for s in servers.values())
        out["cold_capture"] = cold_capture_stall(torch, servers[2], uris, bodies)
        out["sync_check"] = sync_check(torch, servers[2].service, uris)
        out["drills"] = load_drills(torch, bundle, uris, bodies, refs_path)
        emit(out)
        bad = [r for r in out["runs"] if r["statuses"].get(200) != r["requests"] or r["n_failures"]]
        if bad:
            raise AssertionError(f"load: runs with a non-200 answer or a wrong grid: {bad}")
        if counts["pool_argmax"] != 4 * graph_counts["replays"] or counts["unpool_argmax"] != 4 * graph_counts["replays"]:
            raise AssertionError(f"load: K1/K2 launches {counts} are not 4 x the {graph_counts['replays']} replays")
        if out["weight_evict_inflight_total"]:
            raise AssertionError("load: a page-out hit a batch in flight")
        d = out["defaults_run"]
        if (d["statuses"].get(200) != d["requests"] or d["n_failures"] or d["rows"] > LOAD_IMAGES
                or d["launches"]["pool_argmax"] != 4 * d["graph_counts"]["replays"]):
            raise AssertionError(f"load at the defaults: {d}")
        return {"counts": counts, "defaults_counts": defaults_counts}
    finally:
        for server in servers.values():
            _stop(server)


# --- phase 12 ------------------------------------------------------------------

CACHE_IMAGES = 16  # distinct images posted twice: misses, then hits
CACHE_CONCURRENT = 64  # identical posts in flight together
RECOMPUTE_PSNR_DB = 52.0  # a no-cache recompute may land in another batch row


def _keep_alive_post(conn, form, headers=None):
    """(status, x-cache or None, body bytes, seconds) of one ``POST /`` on a
    kept-alive ``http.client`` connection; ``form`` is a dict or its
    urlencoded body, encoded before the clock starts (percent-encoding a
    250 KB data URL takes the client some 20 ms)."""
    body = form if isinstance(form, bytes) else urllib.parse.urlencode(form).encode()
    t0 = time.perf_counter()
    conn.request("POST", "/", body=body,
                 headers={"content-type": "application/x-www-form-urlencoded", **(headers or {})})
    resp = conn.getresponse()
    body = resp.read()
    return resp.status, resp.getheader("x-cache"), body, time.perf_counter() - t0


def phase_cache(torch, label: str) -> dict:
    """The response cache in front of ``POST /`` on a VGG16 server at every
    default (captured graphs, ``pipeline_depth`` 2, the cache and
    singleflight on), block5_conv1.  The cache path, its launch counts read
    around it: CACHE_IMAGES distinct images, then the same again (each hit
    byte-equal to its miss, no graph replay and no K1/K2 launch during the
    hits); CACHE_CONCURRENT concurrent identical posts of one more image
    (one dispatched row, every answer byte-equal); a ``no-cache`` recompute
    (JPEG against JPEG >= RECOMPUTE_PSNR_DB) and a ``no-store`` one that
    leaves the entry as it was.  Then a 422 ``unknown_layer``, negative-
    cached, and an unknown model, answered 422 before any flight; last a
    server that writes its L2 to a temporary ``l2_dir`` and a fresh server
    on the directory that answers ``x-cache: l2``, byte-equal, without a
    replay."""
    import concurrent.futures
    import http.client
    import shutil
    import tempfile

    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.serving.http import Request

    def device_work():
        counts = ops.launch_counts()
        return {"replays": ops.graph_counts["replays"], "pool_argmax": counts["pool_argmax"],
                "unpool_argmax": counts["unpool_argmax"]}

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    torch.cuda.empty_cache()
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda"])  # every default
    boot_s = time.perf_counter() - t0
    service, port = server.service, server.server_address[1]
    out = {"phase": "cache", "card": label, "model": "vgg16", "layer": LOAD_LAYER,
           "server_cache": cache_state(service), "pipeline_depth": service.cfg.pipeline_depth, "boot_s": boot_s,
           "warmup": warmup_report(torch, service, reserved0)}
    failed = []
    uris = image_uris(CACHE_IMAGES + 2)
    forms = [{"file": u, "layer": LOAD_LAYER} for u in uris]
    bodies = [urllib.parse.urlencode(f).encode() for f in forms]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        # warmup captured the deepest layer's programs: one request of
        # another image captures the bucket-1 block5_conv1 graph first
        _keep_alive_post(conn, bodies[CACHE_IMAGES + 1])
        ops.reset_launch_counts()
        w0 = device_work()
        misses = [_keep_alive_post(conn, b) for b in bodies[:CACHE_IMAGES]]
        w1 = device_work()
        hits = [_keep_alive_post(conn, b) for b in bodies[:CACHE_IMAGES]]
        w2 = device_work()
        out["misses_then_hits"] = {
            "miss_p50_ms": statistics.median(m[3] for m in misses) * 1e3,
            "hit_p50_ms": statistics.median(h[3] for h in hits) * 1e3,
            # the server's own time of a hit: key (the form parse on the
            # codec pool and the digest) and lookup
            "server_cache_hit_stage_p50_ms": service.metrics.snapshot()["stages"]["cache_hit"]["p50_s"] * 1e3,
            "x_cache": [[m[1] for m in misses], [h[1] for h in hits]],
            "device_work_misses": delta(w0, w1), "device_work_hits": delta(w1, w2),
            "hits_byte_equal": sum(h[2] == m[2] for h, m in zip(hits, misses)),
        }
        mh = out["misses_then_hits"]
        if ({m[0] for m in misses + hits} != {200} or mh["x_cache"] != [["miss"] * CACHE_IMAGES, ["hit"] * CACHE_IMAGES]
                or mh["hits_byte_equal"] != CACHE_IMAGES or any(mh["device_work_hits"].values())):
            failed.append(f"misses then hits: {mh}")

        # CACHE_CONCURRENT identical posts, released together
        service.batch_sizes.clear()
        barrier = threading.Barrier(CACHE_CONCURRENT)
        counters = ("cache_misses_total", "cache_coalesced_total", "cache_hits_total")
        c0, w0 = {n: service.metrics.counter(n) for n in counters}, device_work()

        def one(_):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.connect()
            try:
                barrier.wait(60)
                return _keep_alive_post(c, bodies[CACHE_IMAGES])
            finally:
                c.close()

        with concurrent.futures.ThreadPoolExecutor(CACHE_CONCURRENT) as pool:
            answers = list(pool.map(one, range(CACHE_CONCURRENT)))
        rows = sum(service.batch_sizes)
        out["coalescing"] = {
            "posts": CACHE_CONCURRENT, "x_cache": dict(collections.Counter(a[1] for a in answers)),
            "counters": {n: service.metrics.counter(n) - c0[n] for n in counters},
            "dispatched_rows": rows, "device_work": delta(w0, device_work()),
            "distinct_bodies": len({a[2] for a in answers}), "p50_ms": statistics.median(a[3] for a in answers) * 1e3,
        }
        co = out["coalescing"]
        if ({a[0] for a in answers} != {200} or rows != 1 or co["distinct_bodies"] != 1
                or co["x_cache"].get("miss") != 1 or co["device_work"]["replays"] != 1):
            failed.append(f"coalescing: {co}")

        # a forced recompute, then one that must not store
        key = service._request_key(Request("POST", "/", {}, {"content-type": "application/x-www-form-urlencoded"},
                                           bodies[0]), "/")
        first = service.cache.peek(key)
        w0 = device_work()
        again = _keep_alive_post(conn, bodies[0], {"cache-control": "no-cache"})
        refreshed = service.cache.peek(key)
        kept = _keep_alive_post(conn, bodies[0], {"cache-control": "no-store"})
        recompute_psnr = _psnr(_decode_jpeg_url(json.loads(again[2])), _decode_jpeg_url(json.loads(misses[0][2])))
        out["no_cache"] = {
            "x_cache": [again[1], kept[1]], "device_work": delta(w0, device_work()),
            "recompute_vs_miss_psnr_db": recompute_psnr if np.isfinite(recompute_psnr) else "identical",
            "entry_refreshed_by_no_cache": first is not None and refreshed is not first,
            "entry_kept_by_no_store": service.cache.peek(key) is refreshed,
        }
        nc = out["no_cache"]
        if (again[0] != 200 or kept[0] != 200 or nc["x_cache"] != ["bypass", "bypass"] or recompute_psnr < RECOMPUTE_PSNR_DB
                or not nc["entry_refreshed_by_no_cache"] or not nc["entry_kept_by_no_store"]
                or nc["device_work"]["replays"] != 2):
            failed.append(f"no-cache / no-store: {nc}")
        torch.cuda.synchronize()
        out["launches"], out["graph_counts"] = ops.launch_counts(), dict(ops.graph_counts)

        # deterministic 4xx: negative-cached; an unknown model before any flight
        bad_layer = {"file": forms[0]["file"], "layer": "no_such_layer"}
        neg = [_keep_alive_post(conn, bad_layer) for _ in range(2)]
        misses0 = service.metrics.counter("cache_misses_total")
        unknown = _keep_alive_post(conn, {**forms[0], "model": "vgg19"})
        out["negative"] = {
            "unknown_layer": [[n[0], json.loads(n[2]).get("error"), n[1]] for n in neg],
            "unknown_model": [unknown[0], json.loads(unknown[2]).get("error"), unknown[1]],
            "lookups_for_unknown_model": service.metrics.counter("cache_misses_total") - misses0,
            "flights_open": len(service.flights),
        }
        ng = out["negative"]
        if (ng["unknown_layer"] != [[422, "unknown_layer", "miss"], [422, "unknown_layer", "hit-negative"]]
                or ng["unknown_model"] != [422, "unknown_model", None] or ng["lookups_for_unknown_model"]
                or ng["flights_open"]):
            failed.append(f"negative cache: {ng}")
    finally:
        conn.close()
        _stop(server)

    # the L2 across a restart: two servers of the same bundle on one directory
    defaults = ServerConfig()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    l2_dir = tempfile.mkdtemp(prefix="l2-", dir=os.path.join(ROOT, "build"))
    try:
        cfg = {"cache_bytes": defaults.cache_bytes, "singleflight": defaults.singleflight, "l2_dir": l2_dir}
        writer = _second_server(torch, service.bundle, **cfg)
        try:
            written = _request_raw(writer.server_address[1], forms[0])
        finally:
            _stop(writer)  # flushes the L2 writer
        reader = _second_server(torch, service.bundle, **cfg)
        try:
            w0 = device_work()
            read = _request_raw(reader.server_address[1], forms[0])
            w1 = device_work()
            l2_hits = reader.service.metrics.counter("cache_l2_hits_total")
        finally:
            _stop(reader)
        out["l2_restart"] = {"x_cache": [written[1], read[1]], "byte_equal": read[2] == written[2],
                             "device_work": delta(w0, w1), "l2_hits": l2_hits, "files": len(os.listdir(l2_dir))}
        l2 = out["l2_restart"]
        if (written[0] != 200 or read[0] != 200 or l2["x_cache"] != ["miss", "l2"] or not l2["byte_equal"]
                or any(l2["device_work"].values()) or l2_hits != 1):
            failed.append(f"L2 across a restart: {l2}")
    finally:
        shutil.rmtree(l2_dir, ignore_errors=True)
    emit(out)
    if failed:
        raise AssertionError("cache: " + "; ".join(failed))
    return {"counts": out["launches"]}


# --- phase 13 ------------------------------------------------------------------

QUALITY_LAYER = "block5_conv1"
# two tenants: an interactive one with no quota, a bulk one with a
# device-time budget small enough to be hit under the turn's load
QUALITY_TENANTS = ('{"inter": {"class": "interactive"}, '
                   '"bulk1": {"class": "bulk", "rate_ms": 20, "burst_ms": 40}}')
QOS_TURN_REQUESTS = 48  # per tenant, 8 threads each
INT8_CONVS = 11  # the 3x3 convs of VGG16 up to block5_conv1: K5 launches per int8 replay


def _concurrent_posts(port: int, forms: list, headers=None) -> list:
    """``POST /`` of every form at once: (status, body, seconds) each."""
    import concurrent.futures
    import http.client

    def one(form):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            status, _, body, secs = _keep_alive_post(conn, form, headers)
            return status, body, secs
        finally:
            conn.close()

    with concurrent.futures.ThreadPoolExecutor(len(forms)) as pool:
        return list(pool.map(one, forms))


def phase_quality(torch, label: str) -> dict:
    """Per-request ``quality`` and QoS on a VGG16 server at 224, cache off,
    ``--tenants`` (so ``--qos``), block5_conv1.  The launch counts are
    zeroed before the first request and read after the last.
    1. ``quality=bogus`` answered 422 ``illegal_quality``; the 8 images at
       ``quality=full``, ``bf16`` and ``int8`` (dynamic), 8 at once each:
       every answer 200, K5's three entries launched INT8_CONVS times each
       per int8 replay (and per warm-up run of a capture) and not at all by
       the others, each int8 graph holding INT8_CONVS of each;
       the bf16 and int8 grids' PSNR against the full grids, printed;
    2. a calibration artifact that ``engine/quant.py:collect_ranges``
       writes from the 8 images, and a second server of the same bundle on
       its directory: its int8 answers, its key's digest, their PSNR;
    3. the captured batch-8 grid programs of the four tiers timed in turns
       (p50 and images/s, one profiled call each);
    4. a QoS turn: an interactive and a bulk tenant, QOS_TURN_REQUESTS
       each from 8 threads apiece at once: each class's served share and
       429s; the bulk answers come from the int8 tier (their key carries
       the int8 prefix, ``quant_int8_batches_total`` grows, each answer
       nearer its image's int8 grid than its full one) and the interactive
       ones from the full tier."""
    import concurrent.futures
    import shutil
    import tempfile

    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine import quant
    from deconv_api_tpu_torch.engine.capture import WARMUP_RUNS
    from deconv_api_tpu_torch.serving.cache import canonical_digest
    from deconv_api_tpu_torch.serving.http import Request

    torch.cuda.empty_cache()
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda", "--max-batch", str(B),
                           *CACHE_OFF_FLAGS, "--tenants", QUALITY_TENANTS])
    service, bundle, port = server.service, server.service.bundle, server.server_address[1]
    out = {"phase": "quality", "card": label, "model": bundle.name, "layer": QUALITY_LAYER,
           "server_cache": cache_state(service), "qos": service.qos is not None,
           "boot_s": time.perf_counter() - t0, "warmup": warmup_report(torch, service, reserved0)}
    failed = []
    uris = image_uris(B)
    forms = [{"file": u, "layer": QUALITY_LAYER} for u in uris]
    total = collections.Counter()
    calib_dir = None

    def counted(fn):
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        got = {**ops.launch_counts(), **ops.graph_counts}
        total.update(got)
        return result, got

    def k5_launches(counts) -> int:
        """K5 launches an int8 window should show: INT8_CONVS per replay,
        and per capture its warm-up runs (eager, ``engine/capture.py``)."""
        return INT8_CONVS * (counts["replays"] + WARMUP_RUNS * counts["captures"])

    def psnrs(answers, refs) -> list:
        return [_psnr(_decode_jpeg_url(json.loads(a[1])), _decode_jpeg_url(json.loads(r[1])))
                for a, r in zip(answers, refs)]

    try:
        bogus, _ = counted(lambda: _concurrent_posts(port, [{**forms[0], "quality": "bogus"}]))
        code = json.loads(bogus[0][1]).get("error")
        out["bogus"] = [bogus[0][0], code]
        if out["bogus"] != [422, "illegal_quality"]:
            failed.append(f"quality=bogus: {out['bogus']}")
        tiers, answers = {}, {}
        for tier in ("full", "bf16", "int8"):
            int8_before = service.metrics.counter("quant_int8_batches_total")
            answers[tier], counts = counted(lambda: _concurrent_posts(port, [{**f, "quality": tier} for f in forms]))
            k5 = counts["conv_q8"]
            tiers[tier] = {"statuses": sorted({a[0] for a in answers[tier]}), "replays": counts["replays"],
                           "captures": counts["captures"], "conv_q8": k5, "quantize_q8": counts["quantize_q8"],
                           "quantize_w_q8": counts["quantize_w_q8"], "pool_argmax": counts["pool_argmax"],
                           "int8_batches": service.metrics.counter("quant_int8_batches_total") - int8_before,
                           "p50_s": statistics.median(a[2] for a in answers[tier])}
            want_k5 = k5_launches(counts) if tier == "int8" else 0
            if (tiers[tier]["statuses"] != [200] or not counts["replays"] or k5 != want_k5
                    or counts["quantize_q8"] != want_k5 or counts["quantize_w_q8"] != want_k5):
                failed.append(f"quality={tier}: {tiers[tier]}")
        for tier in ("bf16", "int8"):
            tiers[tier]["psnr_vs_full_db"] = psnrs(answers[tier], answers["full"])
        # a dynamic int8 program's key: ("deconv", the float key's ten
        # fields, "dynamic", bucket, shape)
        int8_graphs = [(p.kernels.get("conv_q8", 0), p.kernels.get("quantize_q8", 0), p.kernels.get("quantize_w_q8", 0))
                       for k, p in bundle.programs.programs().items() if len(k) == 14 and k[11] == "dynamic"]
        tiers["int8"]["k5_per_graph"] = int8_graphs
        if not int8_graphs or set(int8_graphs) != {(INT8_CONVS,) * 3}:
            failed.append(f"int8 graphs hold {int8_graphs} K5 launches, expected {INT8_CONVS} of each entry")
        out["tiers"] = tiers

        # the calibrated int8 tier: an artifact from the 8 images
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        calib_dir = tempfile.mkdtemp(prefix="calib-", dir=os.path.join(ROOT, "build"))
        images = [service.decode_preprocess(u) for u in uris]
        t_cal = time.perf_counter()
        ranges = quant.collect_ranges(bundle.spec, bundle.params, images, layer=QUALITY_LAYER)
        _, digest = quant.save_calibration(calib_dir, bundle.name, ranges, image_size=bundle.image_size,
                                           n_images=len(images),
                                           source="chip_smoke image_uris")
        calibrated = _second_server(torch, bundle, calibration_dir=calib_dir)
        try:
            cal_port = calibrated.server_address[1]
            cal_answers, counts = counted(lambda: _concurrent_posts(cal_port, [{**f, "quality": "int8"}
                                                                               for f in forms]))
            body = urllib.parse.urlencode({**forms[0], "quality": "int8"}).encode()
            key = calibrated.service._request_key(
                Request("POST", "/", {}, {"content-type": "application/x-www-form-urlencoded"}, body), "/")
            want_key = canonical_digest(f"{calibrated.service._model_prefix(bundle.name)}|/|q=int8:{digest}",
                                        "application/x-www-form-urlencoded", body, exclude=("model", "quality"))
            cal = {"collect_s": time.perf_counter() - t_cal, "entries": len(ranges), "digest": digest,
                   "statuses": sorted({a[0] for a in cal_answers}), "replays": counts["replays"],
                   "captures": counts["captures"], "conv_q8": counts["conv_q8"],
                   "quantize_q8": counts["quantize_q8"], "quantize_w_q8": counts["quantize_w_q8"],
                   "k5_expected": k5_launches(counts), "key_carries_digest": key == want_key,
                   "config_calibration": calibrated.service.config()["quality"]["calibration"],
                   "psnr_vs_full_db": psnrs(cal_answers, answers["full"]),
                   "psnr_vs_dynamic_int8_db": psnrs(cal_answers, answers["int8"])}
        finally:
            _stop(calibrated)
        out["calibrated"] = cal
        if (cal["statuses"] != [200] or not cal["key_carries_digest"] or not cal["replays"]
                or not cal["conv_q8"] == cal["quantize_q8"] == cal["quantize_w_q8"] == cal["k5_expected"]
                or cal["config_calibration"] != {bundle.name: digest}):
            failed.append(f"calibrated int8: {cal}")

        # the captured batch-8 programs of each tier, timed in turns
        batch = torch.from_numpy(np.stack(images)).to(bundle.device)
        settings = {"full": {}, "bf16": {"dtype": torch.bfloat16}, "int8": {"quant": "dynamic"},
                    "int8_calibrated": {"quant": quant.quant_spec(ranges)}}
        runs = {name: captured_run(bundle, batch, QUALITY_LAYER, K, "grid", **kw)[0] for name, kw in settings.items()}
        times = {}
        for turn, order in enumerate((list(runs), list(runs)[::-1])):
            for name in order:
                times.setdefault(name, []).append(_timed(torch, runs[name], reps=20, profiled=turn == 0))
        out["captured"] = {name: {"p50_ms": [t["p50_ms"] for t in ts], "images_per_s": [t["images_per_s"] for t in ts],
                                  "profile": ts[0].get("profile")} for name, ts in times.items()}
        out["tiers_summary"] = {name: {"p50_ms": c["p50_ms"], "images_per_s": c["images_per_s"],
                                       "device_busy_ms": (c["profile"] or {}).get("device_busy_ms"),
                                       "idle_share": (c["profile"] or {}).get("idle_share")}
                                for name, c in out["captured"].items()}

        # the QoS turn: an interactive and a bulk tenant at once
        shares = {"inter": [], "bulk1": []}
        int8_before = service.metrics.counter("quant_int8_batches_total")

        def tenant_turn(tenant):
            def one(i):
                return _concurrent_posts(port, [forms[i % B]], {"x-tenant": tenant})[0] + (i % B,)

            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                shares[tenant] = list(pool.map(one, range(QOS_TURN_REQUESTS)))

        def turn():
            threads = [threading.Thread(target=tenant_turn, args=(t,)) for t in shares]
            t_turn = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            return time.perf_counter() - t_turn

        wall, counts = counted(turn)
        served = {t: [a for a in shares[t] if a[0] == 200] for t in shares}
        n_served = sum(len(v) for v in served.values())
        near = {t: sum(_psnr(_decode_jpeg_url(json.loads(a[1])), _decode_jpeg_url(json.loads(answers["int8"][a[3]][1])))
                       > _psnr(_decode_jpeg_url(json.loads(a[1])), _decode_jpeg_url(json.loads(answers["full"][a[3]][1])))
                       for a in served[t]) for t in served}
        bulk_req = Request("POST", "/", {}, {"content-type": "application/x-www-form-urlencoded", "x-tenant": "bulk1"},
                           urllib.parse.urlencode(forms[0]).encode())
        bulk_req.tclass = service.qos.class_of(service.qos.tenant_of(bulk_req.headers))  # as the QoS wrap stamps it
        bulk_key = service._request_key(bulk_req, "/")
        want_bulk_key = canonical_digest(f"{service._model_prefix(bundle.name)}|/|q=int8:dynamic",
                                         "application/x-www-form-urlencoded", bulk_req.body,
                                         exclude=("model", "quality"))
        out["qos_turn"] = {
            "wall_s": wall, "requests": {t: len(v) for t, v in shares.items()},
            "served_share": {service.qos.class_of(t): len(v) / max(1, n_served) for t, v in served.items()},
            "429": {t: sum(a[0] == 429 for a in v) for t, v in shares.items()},
            "other_statuses": sorted({a[0] for v in shares.values() for a in v} - {200, 429}),
            "nearer_int8_than_full": near, "int8_batches": service.metrics.counter("quant_int8_batches_total") - int8_before,
            "bulk_key_has_int8_prefix": bulk_key == want_bulk_key, "replays": counts["replays"],
            "captures": counts["captures"], "conv_q8": counts["conv_q8"], "p50_s": {t: statistics.median(a[2] for a in v) if v else None
                                                    for t, v in served.items()},
            "tenants": service.qos.snapshot()["tenants"],
        }
        qt = out["qos_turn"]
        if (qt["other_statuses"] or not served["inter"] or not served["bulk1"] or not qt["int8_batches"]
                or not qt["bulk_key_has_int8_prefix"] or near["bulk1"] != len(served["bulk1"]) or near["inter"]):
            failed.append(f"QoS turn: {qt}")
    finally:
        _stop(server)
        if calib_dir is not None:
            shutil.rmtree(calib_dir, ignore_errors=True)
    out["launches"] = dict(total)
    emit(out)
    if failed:
        raise AssertionError("quality: " + "; ".join(failed))
    return {"counts": {k: v for k, v in total.items() if k in ops.launch_counts()}}


# --- phase 14 -------------------------------------------------------------------


JOBS_LAYER = "block3_conv1"  # the deconv and sweep jobs' layer
JOBS_SLOW_MS = 300  # device.dispatch_delay_ms while a job is crashed, cancelled or parked mid-dream


def _raw(port: int, path: str, method: str = "GET", form: dict | None = None, headers=None):
    """(status, body bytes, seconds) of one request."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        body = urllib.parse.urlencode(form).encode() if form is not None else None
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers={"content-type": "application/x-www-form-urlencoded",
                                                       **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), time.perf_counter() - t0
    finally:
        conn.close()


def _job_doc(port: int, job_id: str) -> dict:
    return _request(port, f"/v1/jobs/{job_id}")[1]


def _await_job(port: int, job_id: str, checkpoints: int | None = None, timeout_s: float = 300.0) -> dict:
    """Poll a job until it is terminal or parked, or with ``checkpoints``
    until it has that many."""
    deadline = time.perf_counter() + timeout_s
    while True:
        doc = _job_doc(port, job_id)
        if doc["state"] in ("done", "failed", "cancelled", "parked") or (
                checkpoints is not None and doc["checkpoints"] >= checkpoints):
            return doc
        if time.perf_counter() > deadline:
            raise AssertionError(f"job {job_id} did not finish within {timeout_s} s: {doc}")
        time.sleep(0.005)


def _run_job(port: int, form: dict, headers=None) -> tuple[dict, bytes, float]:
    """Submit a job and wait for it: (its final document, its answer's
    bytes, seconds from the submit to the answer read)."""
    t0 = time.perf_counter()
    status, body, _ = _request(port, "/v1/jobs", "POST", form, headers)
    if status != 202:
        raise AssertionError(f"job submit {form.get('type')}: {status} {body}")
    doc = _await_job(port, body["id"])
    status, result, _ = _raw(port, f"/v1/jobs/{body['id']}/result")
    return doc, result if status == 200 else b"", time.perf_counter() - t0


def _arm(port: int, **form) -> None:
    status, body, _ = _request(port, "/v1/debug/faults", "POST", form)
    if status != 200:
        raise AssertionError(f"faults {form}: {status} {body}")


def phase_jobs(torch, label: str) -> dict:
    """The durable job tier on a VGG16 server at 224 with ``--jobs-dir`` (a
    directory under ``build/``), fault injection on and the cache off,
    under ``cudnn.deterministic`` (so the restarted server's graphs compute
    the bits the first one's do).  Each job but the parked one is counted
    alone: the launch counts are zeroed just before its submit and read
    just after its answer, with no synchronous request in that window, and
    printed as the job's own path.
    1. a deconv job at block3_conv1 (full, then ``quality=int8``) and a
       sweep job from block3_conv1, each answer byte-equal to the
       synchronous ``/v1/deconv`` answers at the same layers (the sweep's
       entry by entry, one request a layer), with both wall times; each
       job one replay a layer it projects, nothing captured, K1 and K2 once
       for each pool up to that layer and, at int8, K5's three entries once
       for each conv up to it;
    2. a default dream job (the model's dream layers, 10 steps on the 8
       rungs of 10 octaves over 16 px), byte-equal to ``/v1/dream``; two
       dream jobs at once (their octaves batched together: whether the
       first answers the solo bytes is printed); then
       the same dream again with ``jobs.runner_crash`` armed once its first
       octave is durable (its octaves slowed by ``device.dispatch_delay_ms``
       to leave the time): resumed once, one checkpoint per rung plus the
       input, byte-equal to the first;
    3. a dream cancelled once its first octave is durable: cancelled with
       fewer checkpoints; the octave in flight runs to its end (at most
       one pyramid and ``steps`` step replays) and no replay follows it;
    4. a dream parked by the server's drain once its first octave is
       durable, and a second server on the same directory that reclaims
       it and answers the first dream's bytes.
    No hand-written kernel lies on a dream job's path: its counts stay 0
    (the parked job's are not read: the second server's warmup shares its
    window)."""
    import shutil
    import tempfile

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.deepdream import octave_shapes
    from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    jobs_dir = tempfile.mkdtemp(prefix="jobs-", dir=os.path.join(ROOT, "build"))
    argv = ["serve", "--port", "0", "--model", "vgg16", "--device", "cuda", "--max-batch", str(B),
            *CACHE_OFF_FLAGS, "--jobs-dir", jobs_dir, "--fault-injection"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.empty_cache()
    t0, reserved0 = time.perf_counter(), torch.cuda.memory_reserved()
    server = build_server(argv)
    service, bundle, port = server.service, server.service.bundle, server.server_address[1]
    out = {"phase": "jobs", "card": label, "model": bundle.name, "server_cache": cache_state(service),
           "cudnn_deterministic": True, "boot_s": time.perf_counter() - t0,
           "warmup": warmup_report(torch, service, reserved0)}
    failed, second = [], None
    uri = image_uris(1)[0]
    rungs = len(octave_shapes(bundle.image_size, bundle.image_size, DREAM_DEFAULTS["octaves"], 1.4,
                              bundle.min_dream_size))
    out["rungs"] = rungs
    counts = {}

    def counted(name, fn):
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        counts[name] = {**ops.launch_counts(), **ops.graph_counts}
        return result

    def slowed_dream(key: str):
        """A default dream job, slowed, once its first octave is durable."""
        _arm(port, arm=f"device.dispatch_delay_ms=p1:{JOBS_SLOW_MS}")
        status, body, _ = _request(port, "/v1/jobs", "POST", {"type": "dream", "file": uri},
                                   {"x-idempotency-key": key})
        if status != 202:
            raise AssertionError(f"dream job {key}: {status} {body}")
        return body["id"], _await_job(port, body["id"], checkpoints=2)

    try:
        # 1. deconv and sweep jobs against the synchronous route.  Each job
        # is counted alone: the counts are zeroed just before its submit and
        # read just after its answer, and every synchronous request (which
        # also captures the job's programs) runs outside that window
        kinds = {l.name: l.kind for l in bundle.spec.layers}
        order = list(kinds)

        def per_replay(layer: str, quality: str) -> dict:
            """Launches of one replay at ``layer``: K1 and K2 once for each
            pool up to it; at int8, K5's three entries once for each conv."""
            upto = [kinds[n] for n in order[: order.index(layer) + 1]]
            convs = upto.count("conv") if quality == "int8" else 0
            want = dict.fromkeys(ops.launch_counts(), 0)
            want.update(pool_argmax=upto.count("pool"), unpool_argmax=upto.count("pool"),
                        conv_q8=convs, quantize_q8=convs, quantize_w_q8=convs)
            return want

        def projections():
            rows = {}
            for name, form in (("deconv", {"type": "deconv", "layer": JOBS_LAYER}),
                               ("deconv_int8", {"type": "deconv", "layer": JOBS_LAYER, "quality": "int8"}),
                               ("sweep", {"type": "sweep", "layer": JOBS_LAYER})):
                sync_form = {k: v for k, v in form.items() if k != "type"}
                layers = bundle.sweep_layers(JOBS_LAYER) if name == "sweep" else (JOBS_LAYER,)
                # the synchronous requests first, so that the job captures
                # nothing and no timed call captures
                sync_first = _raw(port, "/v1/deconv", "POST", {"file": uri, **sync_form})
                if name == "sweep":
                    _raw(port, "/v1/deconv", "POST", {"file": uri, **sync_form, "sweep": "true"})
                    for layer in layers:
                        _raw(port, "/v1/deconv", "POST", {"file": uri, "layer": layer})
                doc, body, wall = counted(f"{name} job", lambda: _run_job(port, {**form, "file": uri}))
                got = counts[f"{name} job"]
                want = {k: sum(per_replay(layer, form.get("quality", "full"))[k] for layer in layers)
                        for k in ops.launch_counts()}
                row = {"state": doc["state"], "checkpoints": doc["checkpoints"], "job_s": wall,
                       "first_sync_s": sync_first[2], "launches": {k: got[k] for k in want},
                       "expected_launches": want, "replays": got["replays"], "captures": got["captures"]}
                if name == "sweep":
                    sync_sweep = _raw(port, "/v1/deconv", "POST", {"file": uri, **sync_form, "sweep": "true"})
                    row["sync_sweep_s"] = sync_sweep[2]
                    entries = json.loads(body)["layers"] if body else {}
                    equal, per_layer_s = [], 0.0
                    for layer, entry in entries.items():
                        status, sync, secs = _raw(port, "/v1/deconv", "POST", {"file": uri, "layer": layer})
                        per_layer_s += secs
                        sync = json.loads(sync)
                        equal.append(status == 200 and (sync["filters"], sync["images"]) ==
                                     (entry["filters"], entry["images"]))
                    row.update(layers=len(entries), equal_per_layer=equal, sync_per_layer_s=per_layer_s,
                               equal=bool(equal) and all(equal) and doc["checkpoints"] == 1 + len(entries))
                else:
                    status, sync, secs = _raw(port, "/v1/deconv", "POST", {"file": uri, **sync_form})
                    row.update(sync_s=secs, equal=status == 200 and body == sync)
                rows[name] = row
                if doc["state"] != "done" or not row["equal"]:
                    failed.append(f"{name} job: {row}")
                # one replay a dispatched layer, none captured, and each
                # kernel launched as often as those replays launch it
                if (row["launches"] != want or (got["replays"], got["captures"]) != (len(layers), 0)
                        or not want["pool_argmax"] or (name == "deconv_int8" and not want["conv_q8"])):
                    failed.append(f"{name} job launches {row['launches']} in {got['replays']} replays and "
                                  f"{got['captures']} captures, expected {want} in {len(layers)} replays")
            return rows

        out["projections"] = projections()

        # 2.-4. dream jobs
        def dreams():
            rows = {}
            sync_first = _raw(port, "/v1/dream", "POST", {"file": uri})
            doc, ref, wall = counted("dream job", lambda: _run_job(port, {"type": "dream", "file": uri},
                                                                   {"x-idempotency-key": "ref"}))
            sync = _raw(port, "/v1/dream", "POST", {"file": uri})
            rows["dream"] = {"state": doc["state"], "checkpoints": doc["checkpoints"], "job_s": wall,
                             "sync_s": sync[2], "first_sync_s": sync_first[2],
                             "equal_to_sync": sync[0] == 200 and sync[1] == ref}
            if doc["state"] != "done" or doc["checkpoints"] != 1 + rungs or not rows["dream"]["equal_to_sync"]:
                failed.append(f"dream job: {rows['dream']}")
            # two jobs at once (the server's two runners): their octaves
            # share batches of 2; reported, not held, against the solo bytes
            batches = len(service.dream_dispatcher.batch_sizes)
            pair = [None, None]

            def one(i):
                pair[i] = _run_job(port, {"type": "dream", "file": image_uris(2)[i]}, {"x-idempotency-key": f"pair{i}"})

            def both():
                threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)

            counted("two dream jobs at once", both)
            sizes = list(service.dream_dispatcher.batch_sizes)[batches:]
            rows["two_at_once"] = {"states": [p[0]["state"] for p in pair], "job_s": [p[2] for p in pair],
                                   "batch_sizes": sizes, "first_equal_to_solo": pair[0][1] == ref}
            def crashed():
                try:
                    job_id, at = slowed_dream("crash")
                    _arm(port, arm="jobs.runner_crash=n1")
                    return job_id, at, _await_job(port, job_id)
                finally:
                    _arm(port, disarm="all")

            job_id, at, doc = counted("crash-resumed dream job", crashed)
            body = _raw(port, f"/v1/jobs/{job_id}/result")[1]
            rows["crash_resumed"] = {"state": doc["state"], "attempts": doc["attempts"], "resumed": doc["resumed"],
                                     "checkpoints": doc["checkpoints"], "armed_at_checkpoints": at["checkpoints"],
                                     "equal": body == ref}
            if (doc["state"], doc["attempts"], doc["checkpoints"]) != ("done", 2, 1 + rungs) or body != ref:
                failed.append(f"crash-resumed dream: {rows['crash_resumed']}")
            def cancelled():
                try:
                    job_id, at = slowed_dream("cancel")
                    status = _raw(port, f"/v1/jobs/{job_id}", "DELETE")[0]
                    doc = _await_job(port, job_id)
                    # the octave already dispatched runs to its end (its
                    # answer is dropped); no octave after it is dispatched
                    replays = [ops.graph_counts["replays"]]
                    for wait_s in (JOBS_SLOW_MS / 1e3 + 0.5, 1.0):
                        time.sleep(wait_s)
                        replays.append(ops.graph_counts["replays"])
                    return job_id, status, doc, replays
                finally:
                    _arm(port, disarm="all")

            job_id, status, doc, replays = counted("cancelled dream job", cancelled)
            in_flight, later = replays[1] - replays[0], replays[2] - replays[1]
            rows["cancelled"] = {"delete_status": status, "state": doc["state"], "checkpoints": doc["checkpoints"],
                                 "replays_of_the_octave_in_flight": in_flight, "replays_after_it": later,
                                 "result_status": _raw(port, f"/v1/jobs/{job_id}/result")[0]}
            if (status, doc["state"], later) != (200, "cancelled", 0) or in_flight > 1 + DREAM_DEFAULTS["steps"] \
                    or doc["checkpoints"] >= 1 + rungs:
                failed.append(f"cancelled dream: {rows['cancelled']}")
            return rows, ref

        rows, ref = dreams()
        out["dreams"] = rows
        dream_windows = [k for k in counts if "dream" in k]
        if any(counts[w][k] for w in dream_windows for k in ops.launch_counts()):
            failed.append(f"dream jobs launched hand-written kernels: { {w: counts[w] for w in dream_windows} }")

        # 4. parked by the drain, finished by the next server
        job_id, at = slowed_dream("park")
        _stop(server)  # the drain: the running job parks at its next checkpoint
        server = service = bundle = None
        gc.collect()
        parked = json.loads(open(os.path.join(jobs_dir, "journal.jsonl")).read().splitlines()[-1])
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        second = build_server(argv)
        port2 = second.server_address[1]
        doc = _await_job(port2, job_id)
        body = _raw(port2, f"/v1/jobs/{job_id}/result")[1]
        out["parked"] = {"last_journal_record": parked, "reclaimed": second.service.jobs.reclaimed,
                         "state": doc["state"], "resumed": doc["resumed"], "checkpoints": doc["checkpoints"],
                         "restart_to_done_s": time.perf_counter() - t1, "equal": body == ref}
        if (parked.get("state") != "parked" or second.service.jobs.reclaimed != 1 or doc["state"] != "done"
                or body != ref):
            failed.append(f"parked dream: {out['parked']}")
        out["jobs_state"] = second.service.config()["jobs"]
    finally:
        for s in (server, second):
            if s is not None:
                _stop(s)
        server = second = service = bundle = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(jobs_dir, ignore_errors=True)
    out["launches"] = counts
    emit(out)
    if failed:
        raise AssertionError("jobs: " + "; ".join(failed))
    return {"counts": {f"jobs: {window}": {k: c[k] for k in ops.launch_counts()} for window, c in counts.items()}}


# --- phase 15 -------------------------------------------------------------------


def phase_settings(torch, label: str) -> dict:
    """The server settings on VGG16 at 224, block5_conv1, cache off.
    1. boots: ``warmup_wall_s`` of a fresh VGG16 server at the defaults
       (the default dream warmed) and of one with ``warmup_dream`` off, and
       that one's first default ``/v1/dream`` (its graphs captured then)
       beside its second;
    2. on the second server's bundle, servers that warm one bucket: a
       ``fused_unpool=auto`` server's 8 ``POST /`` at once, counted (K3 4
       times a grid replay, K2 none); the same with ``backward_dtype=
       float32`` (K3's fp32 form), timed as requests and as the captured
       batch-8 grid program beside the default's; a ``dtype=bfloat16``
       server's ``quality=full`` grids against the default server's
       ``quality=bf16`` grids, one request at a time (equal bytes)."""
    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.engine.capture import WARMUP_RUNS
    from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
    from deconv_api_tpu_torch.serving.models import build_bundle

    def boot(bundle, **cfg):
        gc.collect()  # the closed servers' graphs and pools, then their memory
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        service = DeconvService(bundle, ServerConfig(model=bundle.name, max_batch=B, **{**CACHE_OFF, **cfg}))
        service.start()
        service.warmup()
        server = DeconvHTTPServer(service, "127.0.0.1", 0)
        return server, {"warmup_wall_s": service.warmup_wall_s, "deconv_graphs": len(bundle.programs),
                        "dream_graphs": len(bundle.dream_programs),
                        "boot_reserved_bytes": torch.cuda.memory_reserved() - reserved0}

    out = {"phase": "settings", "card": label, "layer": QUALITY_LAYER}
    failed, servers = [], []
    uris = image_uris(B)
    forms = [{"file": u, "layer": QUALITY_LAYER} for u in uris]
    by_path = {}

    def counted(name, fn):
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        got = {**ops.launch_counts(), **ops.graph_counts}
        by_path[name] = {k: got[k] for k in ops.launch_counts()}
        return result, got

    try:
        # 1. the boot with and without the default dream
        with_dream, out["boot_with_dream"] = boot(build_bundle("vgg16", "cuda"))
        first = _raw(with_dream.server_address[1], "/v1/dream", "POST", {"file": uris[0]})
        out["boot_with_dream"]["first_dream_s"] = first[2]
        _stop(with_dream)
        del with_dream
        bundle = build_bundle("vgg16", "cuda")
        default, out["boot_without_dream"] = boot(bundle, warmup_dream=False)
        servers.append(default)
        dport = default.server_address[1]
        dreams = [_raw(dport, "/v1/dream", "POST", {"file": uris[0]}) for _ in range(2)]
        out["boot_without_dream"].update(first_dream_s=dreams[0][2], second_dream_s=dreams[1][2],
                                         dream_graphs_after=len(bundle.dream_programs))
        if first[0] != 200 or any(d[0] != 200 for d in dreams):
            failed.append(f"default dreams: {[first[0]] + [d[0] for d in dreams]}")

        # 2. fused_unpool=auto, with the bf16 and the fp32 backward, each
        # server warming one bucket (the counts allow for captures)
        one = {"warmup_all_buckets": False, "warmup_dream": False}
        for name, cfg in (("fused_auto", {"fused_unpool": "auto"}),
                          ("fused_auto_fp32", {"fused_unpool": "auto", "backward_dtype": "float32"})):
            server, _ = boot(bundle, **one, **cfg)
            servers.append(server)
            port = server.server_address[1]
            answers, counts = counted(f"settings {name} POST /", lambda: _concurrent_posts(port, forms))
            seq = [_concurrent_posts(port, [forms[i % B]])[0][2] for i in range(10)]
            row = {"statuses": sorted({a[0] for a in answers}), "replays": counts["replays"],
                   "captures": counts["captures"], "fused_unpool_conv": counts["fused_unpool_conv"],
                   "unpool_argmax": counts["unpool_argmax"],
                   "pool_argmax": counts["pool_argmax"], "p50_request_ms_one_at_a_time": statistics.median(seq) * 1e3,
                   "p50_request_ms_8_at_once": statistics.median(a[2] for a in answers) * 1e3,
                   "resolved": server.service.config()["fused_unpool_resolved"]}
            out[name] = row
            # 4 a replay, and 4 in each eager warm-up run of a capture
            k3 = 4 * (row["replays"] + WARMUP_RUNS * row["captures"])
            if (row["statuses"] != [200] or not row["replays"] or row["fused_unpool_conv"] != k3
                    or row["unpool_argmax"] or row["resolved"] != "kernel"):
                failed.append(f"{name}: {row}")
        batch = torch.from_numpy(np.stack([default.service.decode_preprocess(u) for u in uris])).cuda()
        runs = {"default": captured_run(bundle, batch, QUALITY_LAYER, K, "grid")[0],
                "fused_auto_fp32": captured_run(bundle, batch, QUALITY_LAYER, K, "grid", fused_unpool="auto",
                                                backward_dtype="float32")[0]}
        in_turns(torch, out, runs, "grid_program", reps=10, profile_repeats=False)

        # 3. dtype=bfloat16 at quality=full against the default's bf16 tier,
        # one request at a time (a row's bits depend on its batch-mates)
        bf16, _ = boot(bundle, **one, dtype="bfloat16")
        servers.append(bf16)
        full_on_bf16, counts = counted("settings dtype=bfloat16 POST /",
                                       lambda: [_concurrent_posts(bf16.server_address[1], [f])[0] for f in forms])
        tier = [_concurrent_posts(dport, [{**f, "quality": "bf16"}])[0] for f in forms]
        out["dtype_bfloat16"] = {"statuses": sorted({a[0] for a in full_on_bf16 + tier}),
                                 "equal": [a[1] == b[1] for a, b in zip(full_on_bf16, tier)],
                                 "replays": counts["replays"], "pool_argmax": counts["pool_argmax"],
                                 "unpool_argmax": counts["unpool_argmax"]}
        if out["dtype_bfloat16"]["statuses"] != [200] or not all(out["dtype_bfloat16"]["equal"]):
            failed.append(f"dtype=bfloat16: {out['dtype_bfloat16']}")
    finally:
        for s in servers:
            _stop(s)
    emit(out)
    if failed:
        raise AssertionError("settings: " + "; ".join(failed))
    return {"counts": by_path}


FLEET_MODEL, FLEET_DEVICE, FLEET_LAYER = "vgg16", "cuda", "block5_conv1"
FLEET_TOKEN = "chip-smoke-fleet"
FLEET_HITS = 64  # hits timed through the router and straight to their owners, in turns
FLEET_HEDGE_DELAY_MS = 300  # fleet.head_delay_ms on one backend during the hedge run
FLEET_DRAIN_GRACE_S = 2.0
# a backend process: main() of ``serve`` with its kernel launch counts
# zeroed on SIGUSR1 and written to a file on SIGUSR2 and at exit, so the
# phase reads what each process launched between its boot and its end
FLEET_BACKEND = r"""
import json, os, signal, sys
from deconv_api_tpu_torch import ops
out = sys.argv[1]
def dump(*_):
    with open(out + ".tmp", "w") as f:
        json.dump({"launches": ops.launch_counts(), "replays": ops.graph_counts["replays"]}, f)
    os.replace(out + ".tmp", out)
signal.signal(signal.SIGUSR1, lambda *_: ops.reset_launch_counts())
signal.signal(signal.SIGUSR2, dump)
from deconv_api_tpu_torch.__main__ import main
rc = main(sys.argv[2:])
dump()
sys.exit(rc)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric_lines(port: int, path: str = "/metrics") -> dict:
    """``name{labels}`` -> value of a Prometheus exposition."""
    status, body, _ = _raw(port, path)
    assert status == 200, (path, status)
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            try:
                out[name] = float(value)
            except ValueError:
                pass
    return out


def _fleet_post(conn, body: bytes, headers=None):
    """(status, x-backend, x-cache, body, seconds) of one kept-alive ``POST /``."""
    t0 = time.perf_counter()
    conn.request("POST", "/", body=body, headers={"content-type": "application/x-www-form-urlencoded",
                                                  **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, resp.getheader("x-backend"), resp.getheader("x-cache"), data, time.perf_counter() - t0


def phase_fleet(torch, label: str) -> dict:
    """The fleet router of ``serving/fleet.py`` in front of three VGG16
    ``serve`` processes on the card (b0, b1, b2: every default, so the
    response cache and singleflight are on, with ``--peer-fill``, the fleet
    token and ``--drain-grace-s 2``), which register with one
    ``fleet-router`` process (no ``--backends``).
    1. affinity: the load phase's 16 PNGs posted twice through the router
       at block5_conv1: 16 misses then 16 hits, each hit from its miss's
       backend, the backends' ``cache_misses_total`` up by 16, every answer
       byte-equal to the same post made to its owner;
    2. router cost: 64 hits through the router and the same 64 straight to
       their owners, in turns (p50, p99);
    3. hedging: ``fleet.head_delay_ms`` of 300 ms armed on b2 through the
       router's ``/v1/debug/faults``, 64 hits to keys b2 owns: hedges
       fired, won and denied, p50/p99 beside the run without the fault
       (``--slow-floor-ms 1000`` keeps the gray-failure demotion out of it);
    4. ``/v1/metrics/fleet`` with every backend's families, and one
       request's ``/v1/debug/trace/{id}`` joining the router's and its
       backend's spans;
    5. drain: SIGTERM to b0 while a client keeps posting the 16 images
       through the router: every answer 200, b0 out of the ring by its own
       announcement, each of b0's keys ``peer-fill`` once on its new owner
       then ``hit``, no device batch on the new owners, b0's exit code 0;
    6. failover: SIGKILL to b1: the answers stay 200, the router ejects b1
       (``router_backend_state`` 2), and b2 then serves all 16 images.
    The backends' kernel launches from their boot to their end are read
    back from each process (``FLEET_BACKEND``)."""
    import http.client
    import signal

    from deconv_api_tpu_torch import ops

    gc.collect()
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "build", "fleet")
    os.makedirs(work, exist_ok=True)
    launcher = os.path.join(work, "backend.py")
    with open(launcher, "w") as f:
        f.write(FLEET_BACKEND)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    rport = _free_port()
    names, procs, logs, dumps = [], {}, [], {}
    router_cmd = [sys.executable, "-m", "deconv_api_tpu_torch", "fleet-router", "--host", "127.0.0.1",
                  "--port", str(rport), "--fleet-token", FLEET_TOKEN, "--fault-injection",
                  "--slow-floor-ms", "1000"]
    out = {"phase": "fleet", "card": label, "model": FLEET_MODEL, "layer": FLEET_LAYER, "backends": 3,
           "router": " ".join(router_cmd[3:])}

    def spawn(key, cmd):
        log = open(os.path.join(work, f"{key}.log"), "w")
        logs.append(log)
        procs[key] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)

    def log_tail(key, n=30):
        with open(os.path.join(work, f"{key}.log")) as f:
            return "".join(f.readlines()[-n:])

    def dump(key):
        path = os.path.join(work, f"{key}.json")
        mtime = os.path.getmtime(path) if os.path.exists(path) else 0.0
        procs[key].send_signal(signal.SIGUSR2)
        deadline = time.perf_counter() + 30
        while not os.path.exists(path) or os.path.getmtime(path) == mtime:
            assert time.perf_counter() < deadline and procs[key].poll() is None, log_tail(key)
            time.sleep(0.01)
        with open(path) as f:
            return json.load(f)

    try:
        t0 = time.perf_counter()
        spawn("router", router_cmd)
        for i in range(3):
            port = _free_port()
            names.append(f"127.0.0.1:{port}")
            spawn(f"b{i}", [sys.executable, launcher, os.path.join(work, f"b{i}.json"), "serve", "--model",
                            FLEET_MODEL, "--device", FLEET_DEVICE, "--host", "127.0.0.1", "--port", str(port), "--peer-fill",
                            "--fleet-token", FLEET_TOKEN, "--fleet-routers", f"127.0.0.1:{rport}",
                            "--fleet-advertise", names[-1], "--drain-grace-s", str(FLEET_DRAIN_GRACE_S),
                            "--no-warmup-dream"])
        bports = [int(n.rsplit(":", 1)[1]) for n in names]
        while True:
            for key, proc in procs.items():
                assert proc.poll() is None, f"{key} exited {proc.returncode}: {log_tail(key)}"
            try:
                ready = _request(rport, "/readyz")[1]
            except OSError:
                ready = {}
            if ready.get("backends", {}).get("healthy") == 3:
                break
            assert time.perf_counter() - t0 < 300, ready
            time.sleep(0.1)
        out["boot_s"] = time.perf_counter() - t0
        for i in range(3):
            procs[f"b{i}"].send_signal(signal.SIGUSR1)  # launches from here on count
        cfg = _request(rport, "/v1/config")[1]
        assert {n: (m["state"], m["source"]) for n, m in cfg["members"].items()} == \
            {n: ("healthy", "announce") for n in names}, cfg["members"]

        uris = image_uris(LOAD_IMAGES)
        bodies = [urllib.parse.urlencode({"file": u, "layer": FLEET_LAYER}).encode() for u in uris]
        rconn = http.client.HTTPConnection("127.0.0.1", rport, timeout=120)
        direct = {n: http.client.HTTPConnection("127.0.0.1", p, timeout=120) for n, p in zip(names, bports)}

        def misses():
            return [_metric_lines(p).get("deconv_cache_misses_total", 0.0) for p in bports]

        # 1. affinity: one logical cache
        m0 = misses()
        first = [_fleet_post(rconn, b) for b in bodies]
        second = [_fleet_post(rconn, b) for b in bodies]
        owner = [r[1] for r in first]
        assert [(r[0], r[2]) for r in first] == [(200, "miss")] * LOAD_IMAGES, [(r[0], r[2]) for r in first]
        assert [(r[0], r[2]) for r in second] == [(200, "hit")] * LOAD_IMAGES, [(r[0], r[2]) for r in second]
        assert [r[1] for r in second] == owner and all(a[3] == b[3] for a, b in zip(first, second))
        own = [_fleet_post(direct[o], b) for o, b in zip(owner, bodies)]
        assert all(d[0] == 200 and d[2] == "hit" and d[3] == r[3] for d, r in zip(own, first))
        m1 = misses()
        assert sum(m1) - sum(m0) == LOAD_IMAGES, (m0, m1)
        out["affinity"] = {"owners": {n: owner.count(n) for n in names}, "misses": LOAD_IMAGES,
                           "hits": LOAD_IMAGES, "cache_misses_total_delta": sum(m1) - sum(m0),
                           "miss_ms": _quantiles([r[4] for r in first]),
                           "answer_bytes": len(first[0][3])}

        # 2. the router's cost on a hit
        via, straight = [], []
        for k in range(FLEET_HITS):
            i = k % LOAD_IMAGES
            r = _fleet_post(rconn, bodies[i])
            d = _fleet_post(direct[owner[i]], bodies[i])
            assert (r[0], r[1], r[2], d[0], d[2]) == (200, owner[i], "hit", 200, "hit") and r[3] == d[3]
            via.append(r[4])
            straight.append(d[4])
        out["router_cost"] = {"hits": FLEET_HITS, "router_ms": _quantiles(via), "direct_ms": _quantiles(straight),
                              "p50_added_ms": _quantiles(via)["p50_ms"] - _quantiles(straight)["p50_ms"]}

        # 3. hedging against a slow backend
        slow = names[2]
        keys = [i for i in range(LOAD_IMAGES) if owner[i] == slow]
        assert keys, out["affinity"]

        def hedges():
            m = _metric_lines(rport)
            return {k: m.get(f"router_hedges_{k}_total", 0.0) for k in ("fired", "won", "budget_denied")}

        def run_hits():
            ms, by = [], collections.Counter()
            for k in range(FLEET_HITS):
                r = _fleet_post(rconn, bodies[keys[k % len(keys)]])
                assert r[0] == 200, r[:3]
                ms.append(r[4])
                by[r[1]] += 1
            return _quantiles(ms), dict(by)

        base_q, _ = run_hits()
        h0 = hedges()
        tokens = _request(rport, "/v1/config")[1]["tail_tolerance"]["hedge_tokens"]
        armed = _request(rport, "/v1/debug/faults", "POST",
                         {"arm": f"fleet.head_delay_ms=p1:{FLEET_HEDGE_DELAY_MS}@{slow}"})
        assert armed[0] == 200, armed
        slow_q, served_by = run_hits()
        h1 = hedges()
        assert _request(rport, "/v1/debug/faults", "POST", {"disarm": "all"})[0] == 200
        delta = {k: h1[k] - h0[k] for k in h0}
        budget = tokens + FLEET_HITS * 0.05  # --hedge-budget-pct 5: burst tokens plus 5% of the requests
        assert delta["won"] >= 1 and delta["fired"] <= budget, (delta, tokens)
        states = {n: m["state"] for n, m in _request(rport, "/v1/config")[1]["members"].items()}
        out["hedging"] = {"slow_backend": slow, "head_delay_ms": FLEET_HEDGE_DELAY_MS, "keys": len(keys),
                          "requests": FLEET_HITS, "tokens_before": tokens, "budget": budget, **delta,
                          "served_by": served_by, "ms_without_fault": base_q, "ms_with_fault": slow_q,
                          "states_after": states}

        # 4. federation and one joined trace
        fed = _metric_lines(rport, "/v1/metrics/fleet")
        for n in names:
            assert f'deconv_requests_total{{backend="{n}"}}' in fed and fed[f'fleet_scrape_ok{{backend="{n}"}}'] == 1
        r = _fleet_post(rconn, bodies[0], {"x-request-id": "fleet-trace-1"})
        status, doc, _ = _request(rport, "/v1/debug/trace/fleet-trace-1")
        sources = {s["source"] for s in doc["timeline"]}
        assert status == 200 and r[1] in doc["backends"] and {"router", r[1]} <= sources, doc
        out["federation"] = {"families": len({k.split("{")[0] for k in fed}), "backends_scraped":
                             fed.get("fleet_backends_scraped"), "trace_spans": len(doc["timeline"]),
                             "trace_sources": sorted(sources)}

        # 5. drain b0 under traffic
        gone, stays = names[0], names[1:]
        before = {n: _metric_lines(p) for n, p in zip(names[1:], bports[1:])}
        answers, stop = [], threading.Event()

        def client():
            conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=120)
            while not stop.is_set():
                for i, b in enumerate(bodies):
                    answers.append((time.perf_counter(), i, *_fleet_post(conn, b)[:3]))
            conn.close()

        th = threading.Thread(target=client, daemon=True)
        th.start()
        time.sleep(0.3)
        t_sig = time.perf_counter()
        procs["b0"].send_signal(signal.SIGTERM)
        while True:
            m = _request(rport, "/v1/config")[1]["members"][gone]
            if m["state"] == "draining":
                break
            assert time.perf_counter() - t_sig < 10, m
            time.sleep(0.005)
        left_ms = (time.perf_counter() - t_sig) * 1e3
        assert m["announced_drain"] and not m["in_ring"], m
        b0_rc = procs["b0"].wait(60)
        dumps["b0"] = json.load(open(os.path.join(work, "b0.json")))
        n_done = len(answers)
        while len(answers) < n_done + LOAD_IMAGES:
            time.sleep(0.01)
        stop.set()
        th.join(60)
        after = {n: _metric_lines(p) for n, p in zip(names[1:], bports[1:])}
        assert all(a[2] == 200 for a in answers), collections.Counter(a[2] for a in answers)
        moved = [i for i in range(LOAD_IMAGES) if owner[i] == gone]
        seen = {i: [(a[3], a[4]) for a in answers if a[1] == i and a[3] != gone] for i in moved}
        for i, got in seen.items():
            assert got and got[0][1] == "peer-fill" and all(c == "hit" for _b, c in got[1:]), (i, got)
            assert len({b for b, _c in got}) == 1, (i, got)

        def delta_of(family):
            return {n: after[n].get(family, 0.0) - before[n].get(family, 0.0) for n in stays}

        fills = delta_of("deconv_cache_peer_fills_total")
        batches = delta_of("deconv_batches_total")
        assert sum(fills.values()) == len(moved) and sum(batches.values()) == 0 and b0_rc == 0, \
            (fills, batches, b0_rc)
        out["drain"] = {"backend": gone, "exit_code": b0_rc, "left_ring_ms": left_ms,
                        "announced_drain": m["announced_drain"], "answers": len(answers),
                        "non_200": sum(a[2] != 200 for a in answers), "keys_moved": len(moved),
                        "peer_fills": fills, "device_batches_on_new_owners": batches,
                        "cache_misses_total_delta": delta_of("deconv_cache_misses_total"),
                        "new_owners": {i: seen[i][0][0] for i in moved}}

        # 6. failover: b1 killed
        killed, last = names[1], names[2]
        dumps["b1"] = dump("b1")
        procs["b1"].send_signal(signal.SIGKILL)
        procs["b1"].wait(30)
        rconn.close()
        rconn = http.client.HTTPConnection("127.0.0.1", rport, timeout=120)
        passes = []
        for _ in range(2):
            passes.append([_fleet_post(rconn, b)[:3] for b in bodies])
        statuses = [a[0] for p in passes for a in p]
        state = _metric_lines(rport).get(f'router_backend_state{{backend="{killed}"}}')
        assert set(statuses) == {200} and state == 2, (collections.Counter(statuses), state)
        assert [a[1] for a in passes[1]] == [last] * LOAD_IMAGES, passes[1]
        out["failover"] = {"killed": killed, "answers": len(statuses), "non_200": 0, "backend_state": state,
                           "second_pass_backends": sorted({a[1] for a in passes[1]}),
                           "second_pass_cache": dict(collections.Counter(a[2] for a in passes[1]))}
        rconn.close()
        for c in direct.values():
            c.close()
        dumps["b2"] = dump("b2")
        procs["b2"].send_signal(signal.SIGTERM)
        out["b2_exit_code"] = procs["b2"].wait(60)
        procs["router"].send_signal(signal.SIGTERM)
        out["router_exit_code"] = procs["router"].wait(30)
        assert out["b2_exit_code"] == 0 and out["router_exit_code"] == 0, out
    finally:
        for key, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        for log in logs:
            log.close()
    names_k = sorted(ops.launch_counts())
    counts = {k: int(sum(d["launches"].get(k, 0) for d in dumps.values())) for k in names_k}
    out["launches"] = {key: {k: v for k, v in d["launches"].items() if v} for key, d in dumps.items()}
    out["replays"] = {key: d["replays"] for key, d in dumps.items()}
    emit(out)
    assert counts["pool_argmax"] > 0 and counts["unpool_argmax"] > 0, out["launches"]
    return {"counts": counts}


# --- phase 17 ------------------------------------------------------------------

WEIGHTS_DIR = os.path.join(ROOT, "build", "weights_smoke")
# the served models and their layers: the first, a sequential model, is the
# default, and the CLI's, the int8 tier's and the profile's
WEIGHTS_LAYERS = {"vgg16": "block5_conv1", "resnet50": "conv5_block3_out"}
WEIGHTS_DEVICE = "cuda"
WEIGHTS_SEED = 1  # the files' weights: another He-normal draw than the servers' seed-0 init
GOLDEN_MAX_REL_ERR = 1e-4  # tests/test_weights_golden.py's bar against Keras's activations
UNLIKE_PSNR_DB = 40.0  # two grids of other weights lie below this
PROFILE_BATCHES = 2
ONE_BUCKET_FLAGS = ["--no-warmup-all-buckets", "--no-warmup-dream", *CACHE_OFF_FLAGS]


def _rel_err(ref, got) -> float:
    import numpy as np

    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-6)


def weights_golden(torch, counted) -> dict:
    """(a) The Keras-written fixture as the port's npz
    (``tests/fixtures/torch/vgg16_block1.npz``): VGG16 truncated at
    block1_pool at 64x64 on the card within GOLDEN_MAX_REL_ERR of Keras's
    activations and the seed-0 init not; K1 at block1_pool bit-exact
    against its plain version, its pooled map within the bar too."""
    import dataclasses

    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.models import VGG16_SPEC, init_params
    from deconv_api_tpu_torch.models.apply import spec_forward
    from deconv_api_tpu_torch.models.weights import load_model_weights
    from deconv_api_tpu_torch.ops import pool

    spec = dataclasses.replace(VGG16_SPEC.truncated("block1_pool"), input_shape=(64, 64, 3))
    dev = torch.device(WEIGHTS_DEVICE)
    init = init_params(spec, torch.Generator(device=dev).manual_seed(0), dev)
    t0 = time.perf_counter()
    params = load_model_weights("vgg16", spec, os.path.join(ROOT, "tests", "fixtures", "torch", "vgg16_block1.npz"),
                                init)
    load_s = time.perf_counter() - t0
    exp = np.load(os.path.join(ROOT, "tests", "fixtures", "golden", "vgg16_block1_expected.npz"))
    x = torch.from_numpy(exp["x"]).to(dev)
    with torch.no_grad():
        _, acts = spec_forward(spec)(params, x)
        _, init_acts = spec_forward(spec)(init, x)
        conv = acts["block1_conv2"].contiguous()
        (pooled, idx), _ = counted("weights golden block1_pool (K1)", lambda: ops.maxpool_with_argmax(conv))
        want_pooled, want_idx = pool.maxpool_argmax_plain(conv)
    out = {"load_s": load_s, "device": str(params["block1_conv1"]["w"].device),
           "rel_err": {k: _rel_err(exp[k], acts[k].cpu()) for k in ("block1_conv1", "block1_pool")},
           "k1_rel_err_block1_pool": _rel_err(exp["block1_pool"], pooled.cpu()),
           "k1_bit_exact": bool(torch.equal(bits(torch, pooled), bits(torch, want_pooled))
                                and torch.equal(idx, want_idx)),
           "init_rel_err_block1_conv1": _rel_err(exp["block1_conv1"], init_acts["block1_conv1"].cpu())}
    out["ok"] = (max(*out["rel_err"].values(), out["k1_rel_err_block1_pool"]) < GOLDEN_MAX_REL_ERR
                 and out["k1_bit_exact"] and out["init_rel_err_block1_conv1"] > 1e-2
                 and out["device"].startswith(WEIGHTS_DEVICE))
    return out


def weights_served(torch, counted, uri: str) -> dict:
    """(b) ``serve --serve-models vgg16,resnet50 --weights DIR`` on
    ``vgg16.npz`` and ``resnet50.npz`` (He-normal from WEIGHTS_SEED, not the
    servers' seed-0 init) beside the same server without ``--weights``,
    under cuDNN's deterministic algorithms (a ResNet50 grid's bytes
    otherwise vary between runs).  Each model's ``POST /`` at its deepest
    layer is byte-equal to the server's in-process captured grid of the
    same image and unlike the init server's; its host archive equals the
    file; both models are paged out (VGG16 unpinned, the budget lowered)
    and served again with the same bytes; VGG16's ``quality=int8`` grid is
    unlike the init server's int8 grid (and its PSNR against its own full
    grid is reported); the two servers' cache-key prefixes differ in
    ``weights_path`` alone."""
    import numpy as np

    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.engine.crosscheck import psnr_db
    from deconv_api_tpu_torch.models.weights import flat_arrays, save_npz
    from deconv_api_tpu_torch.serving import codec
    from deconv_api_tpu_torch.serving.models import build_bundle

    files, out = {}, {"write_s": {}}
    for name in WEIGHTS_LAYERS:
        t0 = time.perf_counter()
        files[name] = os.path.join(WEIGHTS_DIR, f"{name}.npz")
        save_npz(build_bundle(name, WEIGHTS_DEVICE, seed=WEIGHTS_SEED).params, files[name])
        out["write_s"][name] = time.perf_counter() - t0
    out["files_mb"] = {n: os.path.getsize(f) / 1e6 for n, f in files.items()}
    default = next(iter(WEIGHTS_LAYERS))
    argv = ["serve", "--port", "0", "--device", WEIGHTS_DEVICE, "--model", default, "--serve-models",
            ",".join(WEIGHTS_LAYERS), "--hbm-budget-bytes", str(4 << 30), *ONE_BUCKET_FLAGS]
    servers = []
    try:
        t0 = time.perf_counter()
        servers.append(build_server([*argv, "--weights", WEIGHTS_DIR]))
        out["boot_s_with_weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        servers.append(build_server(argv))
        out["boot_s_init"] = time.perf_counter() - t0
        for server in servers:
            threading.Thread(target=server.serve_forever, daemon=True).start()
        (svc, port), (init_svc, init_port) = ((s.service, s.server_address[1]) for s in servers)

        def post(p, name, **extra):
            status, body, _ = _request(p, "/", "POST", {"file": uri, "layer": WEIGHTS_LAYERS[name], "model": name,
                                                        **extra})
            if status != 200:
                raise AssertionError(f"weights POST / {name} {extra}: {status} {body}")
            return body

        def requests():
            first = {name: post(port, name) for name in WEIGHTS_LAYERS}
            weights, pinned, budget = svc.weights, svc.weights.pinned, svc.weights.budget_bytes
            weights.pinned, weights.budget_bytes = (), 1
            paged_out = weights.enforce_budget()
            weights.pinned, weights.budget_bytes = pinned, budget
            t0 = time.perf_counter()
            again = {name: post(port, name) for name in WEIGHTS_LAYERS}
            return first, paged_out, time.perf_counter() - t0, again, post(port, default, quality="int8")

        (first, paged_out, again_s, again, int8), counts = counted(
            "weights POST / (vgg16 and resnet50 from files, paged out and in, int8)", requests)
        out.update(paged_out=paged_out, served_again_s=again_s, page_in_s=dict(svc.weights.page_in_s),
                   snapshot={k: svc.weights.snapshot()[k] for k in ("page_ins", "page_outs", "overcommits")},
                   launches={k: counts[k] for k in ("pool_argmax", "unpool_argmax", "conv_q8", "quantize_q8",
                                                    "quantize_w_q8", "replays", "captures")})
        out["models"] = {}
        for name, layer in WEIGHTS_LAYERS.items():
            bundle = svc.weights.bundle(name)
            grid = svc.visualize_batch(layer, svc.decode_preprocess(uri, bundle)[None], model=name)["grid"][0]
            init_bundle = init_svc.weights.bundle(name)
            init_grid = init_svc.visualize_batch(layer, init_svc.decode_preprocess(uri, init_bundle)[None],
                                                 model=name)["grid"][0]
            with np.load(files[name]) as f:
                want = {k: f[k] for k in f.files}
            host = flat_arrays(bundle.params)
            out["models"][name] = {
                "served_equals_inprocess": first[name] == codec.encode_data_url(grid),
                "after_page_in_equals_first": again[name] == first[name],
                "host_archive_equals_file": sorted(want) == sorted(host)
                and all(np.array_equal(want[k], host[k]) for k in want),
                "psnr_vs_init_db": psnr_db(grid, init_grid),
            }
        init_int8 = post(init_port, default, quality="int8")
        out["int8"] = {"psnr_vs_init_int8_db": _psnr(_decode_jpeg_url(int8), _decode_jpeg_url(init_int8)),
                       "psnr_vs_own_full_db": _psnr(_decode_jpeg_url(int8), _decode_jpeg_url(first[default]))}
        prefixes = [s._model_prefix(default).split("|") for s in (svc, init_svc)]
        out["prefix_fields_that_differ"] = [[a, b] for a, b in zip(*prefixes) if a != b]
    finally:
        for server in servers:
            _stop(server)
    out["ok"] = (all(all(v for k, v in m.items() if k != "psnr_vs_init_db") and m["psnr_vs_init_db"] < UNLIKE_PSNR_DB
                     for m in out["models"].values())
                 and out["int8"]["psnr_vs_init_int8_db"] < UNLIKE_PSNR_DB
                 and out["prefix_fields_that_differ"] == [[WEIGHTS_DIR, ""]]
                 and sorted(out["paged_out"]) == sorted(WEIGHTS_LAYERS)
                 and all(counts[k] > 0 for k in ("pool_argmax", "unpool_argmax", "conv_q8")))
    return out


def _png_pixels(path: str):
    import numpy as np
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


def weights_cli(torch, counted, by_path: dict) -> dict:
    """(c) ``visualize`` and ``visualize --sweep`` at block5_conv1 and
    ``dream --steps 2 --octaves 2``, each with ``--weights vgg16.npz``, as
    subprocesses (on the card, all started together with ``doctor``), and
    the same three commands in this process on the same file: equal
    pixels.  ``doctor`` prints every check ok, and its selftest (a child
    process of its own) launches K1 and K2."""
    import contextlib
    import io

    import numpy as np

    from deconv_api_tpu_torch import ops
    from deconv_api_tpu_torch.__main__ import main

    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (12, 11, 3)).astype(np.float64)
    img = np.clip(np.kron(base, np.ones((24, 24, 1))) + rng.normal(0, 12, (288, 264, 3)), 0, 255).astype(np.uint8)
    image = os.path.join(WEIGHTS_DIR, "in.png")
    with open(image, "wb") as f:
        f.write(png_bytes(img))
    model, layer = next(iter(WEIGHTS_LAYERS.items()))
    common = ["--weights", os.path.join(WEIGHTS_DIR, f"{model}.npz"), "--model", model, "--platform", WEIGHTS_DEVICE]
    commands = {
        "visualize": ["visualize", "--image", image, "--layer", layer, *common],
        "sweep": ["visualize", "--image", image, "--layer", layer, "--sweep", *common],
        "dream": ["dream", "--image", image, "--steps", "2", "--octaves", "2", *common],
    }
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p)}
    procs, t0 = {}, time.perf_counter()
    for name, args in [*commands.items(), ("doctor", ["doctor", "--platform", WEIGHTS_DEVICE])]:
        argv = args if name == "doctor" else [*args, "--output", os.path.join(WEIGHTS_DIR, f"sub_{name}.png")]
        procs[name] = subprocess.Popen([sys.executable, "-m", "deconv_api_tpu_torch", *argv], cwd=ROOT, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results, wall = {}, {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        wall[name] = time.perf_counter() - t0
        lines = [json.loads(l) for l in stdout.splitlines() if l.startswith("{")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"weights CLI {name}: rc {proc.returncode}\n{stdout[-800:]}\n{stderr[-1500:]}")
        results[name] = lines
    out = {"subprocess_wall_s": wall, "doctor": results["doctor"]}

    def in_process():
        lines = {}
        for name, args in commands.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main([*args, "--output", os.path.join(WEIGHTS_DIR, f"in_{name}.png")])
            if rc != 0:
                raise AssertionError(f"weights CLI {name} in this process: rc {rc}")
            lines[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
        return lines

    t0 = time.perf_counter()
    inproc, _ = counted("weights CLI visualize, sweep and dream (in this process)", in_process)
    out["in_process_wall_s"] = time.perf_counter() - t0
    sub = {name: results[name][-1] for name in commands}
    pairs = {"visualize": [(sub["visualize"]["output"], inproc["visualize"]["output"])],
             "sweep": [(sub["sweep"]["outputs"][k], inproc["sweep"]["outputs"][k]) for k in inproc["sweep"]["outputs"]],
             "dream": [(sub["dream"]["output"], inproc["dream"]["output"])]}
    out["equal_pixels"], out["max_level_diff"] = {}, {}
    for name, files in pairs.items():
        diffs = [int(np.abs(_png_pixels(a).astype(np.int16) - _png_pixels(b)).max()) for a, b in files]
        out["equal_pixels"][name] = max(diffs) == 0
        out["max_level_diff"][name] = max(diffs)
    out["lines_equal"] = {
        "visualize": sub["visualize"]["filters"] == inproc["visualize"]["filters"],
        "sweep": list(sub["sweep"]["outputs"]) == list(inproc["sweep"]["outputs"]),
        "dream": sub["dream"]["loss"] == inproc["dream"]["loss"]}
    out["sweep_layers"] = len(inproc["sweep"]["outputs"])
    selftest = next(l for l in results["doctor"] if l["check"] == "selftest")
    by_path["weights doctor selftest (its child process)"] = {k: selftest.get("launches", {}).get(k, 0)
                                                              for k in ops.launch_counts()}
    out["ok"] = (all(out["equal_pixels"].values()) and all(out["lines_equal"].values())
                 and all(l["ok"] for l in results["doctor"])
                 and [l["check"] for l in results["doctor"]] == ["backend", "rtt", "build", "selftest", "overall"]
                 and selftest["launches"].get("pool_argmax", 0) > 0 and selftest["launches"].get("unpool_argmax", 0) > 0)
    return out


def weights_profile(torch, counted) -> dict:
    """(d) A VGG16 server with ``--profile-dir`` (its startup budget set to
    0 by ``DECONV_PROFILE_BATCHES``): ``POST /v1/profile batches=2``, then
    two ``POST /`` one after the other.  Two Chrome traces appear, and in
    each the kernel events name K1's and K2's kernels, inside the graph
    replay."""
    import glob

    from deconv_api_tpu_torch.__main__ import build_server

    model, layer = next(iter(WEIGHTS_LAYERS.items()))
    prof = os.path.join(WEIGHTS_DIR, "profile")
    prev = os.environ.get("DECONV_PROFILE_BATCHES")
    os.environ["DECONV_PROFILE_BATCHES"] = "0"
    try:
        server = build_server(["serve", "--port", "0", "--device", WEIGHTS_DEVICE, "--model", model, "--profile-dir",
                               prof, *ONE_BUCKET_FLAGS])
    finally:
        if prev is None:
            os.environ.pop("DECONV_PROFILE_BATCHES")
        else:
            os.environ["DECONV_PROFILE_BATCHES"] = prev
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    uris = image_uris(2)
    try:
        armed = _request(port, "/v1/profile", "POST", {"batches": str(PROFILE_BATCHES)})[:2]

        def traced():
            t0 = time.perf_counter()
            statuses = [_request(port, "/", "POST", {"file": u, "layer": layer})[0] for u in uris]
            return statuses, time.perf_counter() - t0

        (statuses, traced_s), counts = counted("weights profile POST / (two traced batches)", traced)
    finally:
        _stop(server)
    out = {"armed": armed, "statuses": statuses, "traced_requests_s": traced_s,
           "launches": {k: counts[k] for k in ("pool_argmax", "unpool_argmax", "replays", "captures")}, "traces": []}
    for path in sorted(glob.glob(os.path.join(prof, "trace-*.pt.trace.json"))):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        # a kernel of a replay: its launch correlates with a cudaGraphLaunch
        launches = {e.get("args", {}).get("correlation") for e in events
                    if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")}
        in_graph = [e for e in kernels if e.get("args", {}).get("correlation") in launches]
        out["traces"].append({
            "mb": os.path.getsize(path) / 1e6, "kernel_events": len(kernels), "kernel_events_in_a_graph": len(in_graph),
            "k1": sum("pool_argmax_kernel" in e.get("name", "") for e in kernels),
            "k2": sum("unpool_kernel" in e.get("name", "") for e in kernels),
            "k1_in_a_graph": sum("pool_argmax_kernel" in e.get("name", "") for e in in_graph),
            "k2_in_a_graph": sum("unpool_kernel" in e.get("name", "") for e in in_graph)})
    out["ok"] = (armed == (200, {"armed": PROFILE_BATCHES, "profile_dir": prof}) and statuses == [200] * 2
                 and len(out["traces"]) == PROFILE_BATCHES
                 and all(t["k1"] and t["k2"] and t["k1_in_a_graph"] and t["k2_in_a_graph"] for t in out["traces"]))
    return out


def phase_weights(torch, label: str) -> dict:
    """Pretrained weights on the card: (a) the golden fixture, (b) a
    two-model server on weight files, paged out and in, at the int8 tier
    too, (c) the CLI's ``visualize``, ``dream`` and ``doctor``, (d) a
    ``torch.profiler`` trace armed by ``POST /v1/profile``.  Each part's
    launches are counted in a window of its own."""
    import shutil

    from deconv_api_tpu_torch import ops

    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    os.makedirs(WEIGHTS_DIR)
    by_path = {}

    def counted(name, fn):
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        got = {**ops.launch_counts(), **ops.graph_counts}
        by_path[name] = {k: got[k] for k in ops.launch_counts()}
        return result, got

    out = {"phase": "weights", "card": label}
    wall = {}
    uri = image_uris(1)[0]
    prev_det = torch.backends.cudnn.deterministic
    for part, run in (("golden", lambda: weights_golden(torch, counted)),
                      ("served", lambda: weights_served(torch, counted, uri)),
                      ("cli", lambda: weights_cli(torch, counted, by_path)),
                      ("profile", lambda: weights_profile(torch, counted))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = part == "served"
        t0 = time.perf_counter()
        try:
            out[part] = run()
        finally:
            torch.backends.cudnn.deterministic = prev_det
        wall[part] = time.perf_counter() - t0
    out["wall_s"] = wall
    emit(out)
    failed = [part for part in wall if not out[part]["ok"]]
    if failed:
        raise AssertionError(f"weights: {failed} failed (see the phase's line)")
    return {"counts": by_path}


# --- phases 18 and 19 ------------------------------------------------------------

WARM_DIR = os.path.join(ROOT, "build", "warm_boot")
WARM_STORE = os.path.join(WARM_DIR, "aot")  # the store both phases boot against
WARM_MODEL, WARM_DEVICE, WARM_LAYER = "vgg16", "cuda", "block5_conv1"
WARM_CORRUPT = "unpool_argmax"  # the entry the third boot finds damaged
AUTOSCALE_TOKEN = "chip-smoke-autoscale"
AUTOSCALE_JOBS = 8  # deconv jobs on b0, slowed: the hot queue
AUTOSCALE_UP_QUEUE = 4  # --autoscale-up-queue
AUTOSCALE_JOB_DELAY_MS = 1500  # device.dispatch_delay_ms on b0 while its jobs queue
AUTOSCALE_HOLD_OCTAVES = 3  # b1's dream job, its octaves slowed to end ...
AUTOSCALE_HOLD_S = 6.0  # ... this long past the earliest scale-down
AUTOSCALE_COOLDOWN_DOWN_S = 30  # no scale-down before the launch is this old
# A serve process (its first argument: where it writes its report; its
# output goes to <report>.log): times its boot (the import, the service's
# init with the model and its weights, the kernel libraries' resolution,
# the warmup, /ready), notes every nvcc process it starts, zeroes the
# launch counts once it is ready and writes them with its report at its
# end and on SIGUSR2.  cuDNN runs its deterministic algorithms, so two
# boots' answers compare byte for byte.
WARM_BACKEND = r"""
import json, os, signal, subprocess, sys, time
t0 = time.perf_counter()
out = sys.argv[1]
with open(out + ".pid", "w") as f:
    f.write(str(os.getpid()))
log = os.open(out + ".log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
os.dup2(log, 1)
os.dup2(log, 2)
nvcc = []
popen_init = subprocess.Popen.__init__
def noting_init(self, args, *a, **k):
    argv = [args] if isinstance(args, (str, bytes)) else list(args)
    if argv and os.path.basename(str(argv[0])) == "nvcc":
        nvcc.append(" ".join(map(str, argv[1:])))
    popen_init(self, args, *a, **k)
subprocess.Popen.__init__ = noting_init
import torch
torch.backends.cudnn.deterministic = True
from deconv_api_tpu_torch import __main__ as cli, ops
from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.serving import aot, app
report = {"import_s": time.perf_counter() - t0, "package": os.path.dirname(os.path.abspath(cli.__file__))}
def timed(cls, name, key):
    fn = getattr(cls, name)
    def wrapper(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            report[key] = report.get(key, 0.0) + time.perf_counter() - t
    setattr(cls, name, wrapper)
timed(app.DeconvService, "__init__", "init_s")
timed(aot.KernelResolver, "resolve", "resolve_s")
timed(app.DeconvService, "warmup", "warmup_s")
build_server, services = cli.build_server, []
def ready(argv=None):
    server = build_server(argv)
    report["ready_s"] = time.perf_counter() - t0
    services.append(server.service)
    ops.reset_launch_counts()
    return server
cli.build_server = ready
def dump(*_):
    s = services[0] if services else None
    doc = {**report, "nvcc": list(nvcc), "built": sorted(_build.build_logs), "launches": ops.launch_counts(),
           "replays": ops.graph_counts["replays"], "warmup_wall_s": s.warmup_wall_s if s else None}
    if s is not None and s.aot is not None:
        doc.update(outcomes=s.aot.outcomes, build_seconds=s.aot.build_seconds,
                   keys={n: s.aot.key(n) for n in _build.KERNELS} if s.aot.outcomes else {},
                   libraries={n: lib._name for n, lib in s.aot.loaded.items()})
    with open(out + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(out + ".tmp", out)
signal.signal(signal.SIGUSR2, dump)
rc = cli.main(sys.argv[2:])
dump()
sys.exit(rc)
"""


def _fresh_copy(dest: str) -> str:
    """A copy of the package alone under ``dest``: what a new host's
    checkout holds, with no ``build/`` and no bytecode."""
    import shutil

    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "deconv_api_tpu_torch"), os.path.join(dest, "deconv_api_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return dest


def _backend_script(work: str) -> str:
    path = os.path.join(work, "backend.py")
    with open(path, "w") as f:
        f.write(WARM_BACKEND)
    return path


def _log_tail(report: str, n: int = 30) -> str:
    try:
        with open(report + ".log") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "(no log)"


def _await_ready(port: int, proc, report: str, timeout_s: float = 300.0) -> None:
    deadline = time.perf_counter() + timeout_s
    while True:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"backend exited {proc.returncode} before /ready: {_log_tail(report)}")
        try:
            status, body, _ = _request(port, "/readyz")
            if status == 200 and body.get("ready"):
                return
        except OSError:
            pass
        if time.perf_counter() > deadline:
            raise AssertionError(f"backend not ready in {timeout_s} s: {_log_tail(report)}")
        time.sleep(0.05)


def _kill_reported(work: str) -> None:
    """SIGKILL every backend of ``work`` whose pid file names a live process."""
    import glob
    import signal

    for path in glob.glob(os.path.join(work, "*.pid")):
        try:
            with open(path) as f:
                os.kill(int(f.read()), signal.SIGKILL)
        except (OSError, ValueError):
            pass


def phase_warm_boot(torch, label: str) -> dict:
    """The warm boot (``serving/aot.py``): three VGG16 ``serve`` processes
    at every default with ``--aot-dir`` on one store, each from a fresh
    copy of the package (no ``build/``), one after the other:
    1. cold: the store empty, so 4 misses, each library built by nvcc (the
       four together) and stored;
    2. warm: 4 hits, 0 misses, and no nvcc process at all (its ``Popen``
       calls noted); its ``POST /`` byte-equal to the cold boot's;
    3. one entry's body damaged (``WARM_CORRUPT``): 1 corrupt, 1 miss and
       1 nvcc build of that kernel, 3 hits, the same answer.
    Each prints its boot split: the import, the service's init (the model
    built and its weights made on the card), the libraries' resolution,
    the warmup's captures, and /ready from the process's start and from
    the spawn.  Every process shares the one card."""
    import shutil
    import signal

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(WARM_DIR, ignore_errors=True)
    os.makedirs(WARM_DIR)
    script = _backend_script(WARM_DIR)
    form = {"file": image_uris(1)[0], "layer": WARM_LAYER}
    out = {"phase": "warm_boot", "card": label, "model": WARM_MODEL, "layer": WARM_LAYER, "store": WARM_STORE}
    boots = {}

    def boot(key: str) -> dict:
        copy = _fresh_copy(os.path.join(WARM_DIR, key))
        report = os.path.join(WARM_DIR, f"{key}.json")
        port = _free_port()
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, script, report, "serve", "--model", WARM_MODEL, "--device",
                                 WARM_DEVICE, "--host", "127.0.0.1", "--port", str(port), "--aot-dir", WARM_STORE],
                                cwd=copy,
                                env={**os.environ, "PYTHONPATH": copy},
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            _await_ready(port, proc, report)
            spawn_to_ready = time.perf_counter() - t0
            aot_block = _request(port, "/v1/config")[1]["aot"]
            status, answer, post_s = _raw(port, "/", "POST", form)
            assert status == 200, (key, status, answer[:200])
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(120)
        with open(report) as f:
            doc = json.load(f)
        real = os.path.realpath(copy)
        assert rc == 0 and os.path.realpath(doc["package"]).startswith(real), (rc, doc["package"], _log_tail(report))
        assert all(os.path.realpath(p).startswith(os.path.join(real, "build")) for p in doc["libraries"].values()), \
            doc["libraries"]
        doc.update(rc=rc, spawn_to_ready_s=spawn_to_ready, aot=aot_block, answer=answer, post_s=post_s)
        boots[key] = doc
        return doc

    try:
        cold = boot("cold")
        assert cold["outcomes"] == {k: "miss" for k in cold["keys"]}, cold["outcomes"]
        assert (cold["aot"]["misses"], cold["aot"]["stores"], cold["aot"]["hits"]) == (4, 4, 0), cold["aot"]
        assert sorted(cold["built"]) == sorted(cold["keys"]), cold["built"]
        warm = boot("warm")
        assert warm["outcomes"] == {k: "hit" for k in warm["keys"]}, warm["outcomes"]
        assert (warm["aot"]["hits"], warm["aot"]["misses"], warm["aot"]["corrupt"]) == (4, 0, 0), warm["aot"]
        assert warm["nvcc"] == [] and warm["built"] == [] and warm["keys"] == cold["keys"], (warm["nvcc"], warm["built"])
        assert warm["answer"] == cold["answer"], "the warm boot's answer differs from the cold boot's"
        damaged = os.path.join(WARM_STORE, warm["keys"][WARM_CORRUPT] + ".aot")
        with open(damaged, "r+b") as f:
            f.seek(-64, os.SEEK_END)
            tail = f.read(64)
            f.seek(-64, os.SEEK_END)
            f.write(bytes(b ^ 0xFF for b in tail))
        again = boot("corrupt")
        assert again["outcomes"] == {k: "miss" if k == WARM_CORRUPT else "hit" for k in again["keys"]}, \
            again["outcomes"]
        assert (again["aot"]["corrupt"], again["aot"]["misses"], again["aot"]["hits"], again["aot"]["stores"]) == \
            (1, 1, 3, 1), again["aot"]
        assert again["built"] == [WARM_CORRUPT] and len(again["nvcc"]) == 1, (again["built"], again["nvcc"])
        assert again["answer"] == cold["answer"], "the rebuilt kernel's answer differs"
    finally:
        _kill_reported(WARM_DIR)
    for key, doc in boots.items():
        out[key] = {
            "outcomes": doc["outcomes"], "aot": doc["aot"], "nvcc_processes": len(doc["nvcc"]),
            "nvcc_build_s": doc["build_seconds"],
            "split_s": {"import": doc["import_s"], "init": doc["init_s"], "resolve": doc.get("resolve_s", 0.0),
                        "warmup_captures": doc["warmup_s"] - doc.get("resolve_s", 0.0), "ready": doc["ready_s"],
                        "spawn_to_ready": doc["spawn_to_ready_s"]},
            "warmup_wall_s": doc["warmup_wall_s"], "post_ms": doc["post_s"] * 1e3, "answer_bytes": len(doc["answer"]),
            "exit_code": doc["rc"],
        }
    out["answers_byte_equal"] = True
    out["warm_saving_s"] = boots["cold"]["ready_s"] - boots["warm"]["ready_s"]
    emit(out)
    names = sorted(boots["cold"]["launches"])
    counts = {k: int(sum(d["launches"].get(k, 0) for d in boots.values())) for k in names}
    assert counts["pool_argmax"] > 0 and counts["unpool_argmax"] > 0, counts
    return {"counts": counts}


def _journal(path: str) -> list:
    """The decision journal's data records (its header skipped)."""
    from deconv_api_tpu_torch.serving.autoscale import DecisionJournal

    return DecisionJournal.replay(path)


def _await_record(path: str, kind: str, procs: dict, timeout_s: float, **match) -> dict:
    deadline = time.perf_counter() + timeout_s
    while True:
        for rec in _journal(path):
            if rec.get("kind") == kind and all(rec.get(k) == v for k, v in match.items()):
                return rec
        for key, proc in procs.items():
            assert proc.poll() is None, f"{key} exited {proc.returncode}"
        if time.perf_counter() > deadline:
            raise AssertionError(f"no {kind} {match} in the journal within {timeout_s} s: {_journal(path)}")
        time.sleep(0.1)


def phase_autoscale(torch, label: str) -> dict:
    """The closed loop (``serving/autoscale.py``) on the card: a
    ``fleet-router --autoscale enforce --autoscale-min 1 --autoscale-max 2``
    whose launch command is a VGG16 ``serve`` of a fresh copy of the
    package on the warm-boot phase's store (``--aot-dir``), with
    ``--l2-dir``, ``--jobs-dir`` and the fleet token; it starts with one
    such backend (b0) that the phase launches.
    1. hot: ``AUTOSCALE_JOBS`` deconv jobs on b0, slowed by
       ``device.dispatch_delay_ms``, hold its job queue over
       ``--autoscale-up-queue``: the controller launches b1, which boots
       warm and registers; ``autoscaler_boot_to_warm_seconds`` stops at its
       first warm counter on the federation plane (its 4 store hits);
    2. cold, held: once b1 serves, a dream job runs on b1 (its octaves
       slowed to end ``AUTOSCALE_HOLD_S`` past the earliest scale-down), so
       its queue is 1 and the fleet's mean 0.5: cold.  Past
       ``--autoscale-cooldown-down-s`` the controller announces b1's
       drain, and its jobs gate holds the reap while the job runs: the
       drain announced, then the job done, then the reap (SIGTERM: b1's
       own drain, ``--drain-grace-s 2``);
    3. through it all a client posts the 8 images through the router: every
       answer 200, and the fleet is back to 1.
    The router, both backends and the client share one card and the
    machine's 8 cores."""
    import shlex
    import shutil
    import signal
    import http.client

    gc.collect()
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "build", "autoscale")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    script = _backend_script(work)
    host = _fresh_copy(os.path.join(work, "host"))
    env = {**os.environ, "PYTHONPATH": host}
    rport = _free_port()
    journal = os.path.join(work, "journal.jsonl")

    def serve_argv(port) -> list:
        return [sys.executable, script, os.path.join(work, f"b{port}.json"), "serve", "--model", WARM_MODEL,
                "--device", WARM_DEVICE, "--host", "127.0.0.1", "--port", str(port), "--aot-dir", WARM_STORE,
                "--l2-dir", os.path.join(work, "l2", f"b{port}"), "--jobs-dir", os.path.join(work, "jobs", f"b{port}"),
                "--fleet-token", AUTOSCALE_TOKEN, "--fleet-routers", f"127.0.0.1:{rport}",
                "--fleet-advertise", f"127.0.0.1:{port}", "--drain-grace-s", str(FLEET_DRAIN_GRACE_S),
                "--fault-injection"]

    router_cmd = [sys.executable, "-m", "deconv_api_tpu_torch", "fleet-router", "--host", "127.0.0.1",
                  "--port", str(rport), "--fleet-token", AUTOSCALE_TOKEN, "--probe-interval-s", "0.5",
                  "--autoscale", "enforce", "--autoscale-min", "1", "--autoscale-max", "2",
                  "--autoscale-interval-s", "1", "--autoscale-up-queue", str(AUTOSCALE_UP_QUEUE),
                  "--autoscale-cooldown-up-s", "5", "--autoscale-cooldown-down-s", str(AUTOSCALE_COOLDOWN_DOWN_S),
                  "--autoscale-journal", journal, "--autoscale-launch-cmd", shlex.join(serve_argv("{port}"))]
    out = {"phase": "autoscale", "card": label, "router": " ".join(router_cmd[3:-2]), "launch_cmd": "serve "
           + " ".join(serve_argv("{port}")[4:]), "hot_signal": f"job queue depth (--autoscale-up-queue "
           f"{AUTOSCALE_UP_QUEUE})", "shared": "router, 2 backends and the client on one card and 8 cores"}
    procs, reports = {}, {}
    uris = image_uris(8)
    statuses, stop = [], threading.Event()
    refused = []  # (s into the drill, status, x-backend, body) of each non-200 answer

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=300)
        i, t_start = 0, time.monotonic()
        while not stop.is_set():
            body = urllib.parse.urlencode({"file": uris[i % len(uris)], "layer": WARM_LAYER}).encode()
            try:
                status, backend, _, data, _ = _fleet_post(conn, body)
                statuses.append(status)
                if status != 200:
                    refused.append((time.monotonic() - t_start, status, backend,
                                    data[:300].decode("utf-8", "replace")))
            except (OSError, http.client.HTTPException):
                if stop.is_set():
                    break
                statuses.append(0)  # no answer: counted against the drill
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=300)
            i += 1
        conn.close()

    def ready_block():
        return _request(rport, "/readyz")[1]

    def members():
        return _request(rport, "/v1/config")[1]["members"]

    try:
        t0 = time.perf_counter()
        log = open(os.path.join(work, "router.log"), "w")
        procs["router"] = subprocess.Popen(router_cmd, cwd=host, env=env, stdout=log, stderr=subprocess.STDOUT)
        p0 = _free_port()
        b0 = f"127.0.0.1:{p0}"
        reports[b0] = os.path.join(work, f"b{p0}.json")
        procs["b0"] = subprocess.Popen(serve_argv(p0), cwd=host, env=env, stdout=subprocess.DEVNULL,
                                       stderr=subprocess.DEVNULL)
        _await_ready(p0, procs["b0"], reports[b0])
        while members().get(b0, {}).get("state") != "healthy":
            assert time.perf_counter() - t0 < 300 and procs["router"].poll() is None, members()
            time.sleep(0.1)
        out["b0_boot_s"] = time.perf_counter() - t0
        th = threading.Thread(target=client, daemon=True)
        th.start()

        # 1. hot: b0's job queue
        _arm(p0, arm=f"device.dispatch_delay_ms=p1:{AUTOSCALE_JOB_DELAY_MS}")
        t_hot = time.monotonic()
        jobs0 = []
        for i in range(AUTOSCALE_JOBS):
            status, doc, _ = _request(p0, "/v1/jobs", "POST", {"type": "deconv", "layer": WARM_LAYER,
                                                               "file": uris[i % len(uris)], "top_k": str(i + 1)})
            assert status == 202, (status, doc)
            jobs0.append(doc["id"])
        launched = _await_record(journal, "launched", procs, 60)
        b1 = launched["backend"]
        reports[b1] = os.path.join(work, f"b{b1.rsplit(':', 1)[1]}.json")
        _arm(p0, disarm="all")
        warm = _await_record(journal, "warm", procs, 240, backend=b1)
        p1 = int(b1.rsplit(":", 1)[1])
        assert all(_await_job(p0, j)["state"] == "done" for j in jobs0)

        # 2. cold, the reap held by b1's running job
        end = launched["clock"] + AUTOSCALE_COOLDOWN_DOWN_S + AUTOSCALE_HOLD_S
        hold_ms = max(500, int((end - time.monotonic()) * 1e3 / AUTOSCALE_HOLD_OCTAVES))
        _arm(p1, arm=f"device.dispatch_delay_ms=p1:{hold_ms}")
        status, doc, _ = _request(p1, "/v1/jobs", "POST", {"type": "dream", "file": uris[0], "steps": "2",
                                                           "octaves": str(AUTOSCALE_HOLD_OCTAVES)})
        assert status == 202, (status, doc)
        hold_job = doc["id"]
        t_job = time.monotonic()
        announced = _await_record(journal, "drain_announced", procs, 120, backend=b1)
        running_at_announce = _job_doc(p1, hold_job)["state"]
        gated = _request(p1, "/v1/jobs")[1]["counts"]
        done = _await_job(p1, hold_job)
        t_done = time.monotonic()
        _arm(p1, disarm="all")  # the delay held the job; the client's requests on b1 run at speed again
        reaped = _await_record(journal, "reaped", procs, 120, backend=b1)
        assert done["state"] == "done" and running_at_announce == "running", (done["state"], running_at_announce)
        assert announced["clock"] < t_done < reaped["clock"], (announced["clock"], t_done, reaped["clock"])
        deadline = time.perf_counter() + 60
        while not os.path.exists(reports[b1]):
            assert time.perf_counter() < deadline, _log_tail(reports[b1])
            time.sleep(0.1)
        time.sleep(1.0)  # traffic on the survivor alone
        stop.set()
        th.join(300)
        metrics = _metric_lines(rport)
        ready = ready_block()
        fleet_size = metrics.get("autoscaler_fleet_size")
        assert fleet_size == 1 and set(statuses) == {200}, (fleet_size, collections.Counter(statuses), refused,
                                                            _journal(journal)[-6:])
        assert metrics.get("autoscaler_reaped_total") == 1, metrics
        records = _journal(journal)
        out.update({
            "hot": {"jobs": AUTOSCALE_JOBS, "delay_ms": AUTOSCALE_JOB_DELAY_MS,
                    "launch_after_s": launched["clock"] - t_hot},
            "b1": b1, "boot_to_warm_s": warm["boot_to_warm_s"],
            "autoscaler_boot_to_warm_seconds": {
                "sum": metrics.get(f'autoscaler_boot_to_warm_seconds_sum{{backend="{b1}"}}'),
                "count": metrics.get(f'autoscaler_boot_to_warm_seconds_count{{backend="{b1}"}}')},
            "held_reap": {"job": hold_job, "octaves": AUTOSCALE_HOLD_OCTAVES, "delay_ms": hold_ms,
                          "job_state_at_announce": running_at_announce, "jobs_counts_at_announce": gated,
                          "announced_after_job_s": announced["clock"] - t_job,
                          "held_s": reaped["clock"] - announced["clock"], "job_done_to_reap_s": reaped["clock"] - t_done},
            "answers": len(statuses), "non_200": sum(s != 200 for s in statuses), "fleet_size_after": fleet_size,
            "decisions": {k: v for k, v in metrics.items() if k.startswith("autoscaler_decisions_total")},
            "ready_autoscale": ready.get("autoscale"),
            "journal": records,
        })
        procs["b0"].send_signal(signal.SIGTERM)
        out["b0_exit_code"] = procs["b0"].wait(120)
        procs["router"].send_signal(signal.SIGTERM)
        out["router_exit_code"] = procs["router"].wait(60)
        assert out["b0_exit_code"] == 0 and out["router_exit_code"] == 0, out
    finally:
        stop.set()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        _kill_reported(work)
    docs = {}
    for name, path in reports.items():
        with open(path) as f:
            docs[name] = json.load(f)
    b1_doc = docs[b1]
    out["b1_boot"] = {"outcomes": b1_doc["outcomes"], "nvcc_processes": len(b1_doc["nvcc"]),
                      "split_s": {"import": b1_doc["import_s"], "init": b1_doc["init_s"],
                                  "resolve": b1_doc.get("resolve_s", 0.0), "ready": b1_doc["ready_s"]}}
    out["launches"] = {name: {k: v for k, v in d["launches"].items() if v} for name, d in docs.items()}
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    assert b1_doc["outcomes"] == {k: "hit" for k in b1_doc["keys"]} and b1_doc["nvcc"] == [], out["b1_boot"]
    names = sorted(docs[b0]["launches"])
    counts = {k: int(sum(d["launches"].get(k, 0) for d in docs.values())) for k in names}
    assert counts["pool_argmax"] > 0 and counts["unpool_argmax"] > 0, out["launches"]
    return {"counts": counts}


# --- phase 20 ------------------------------------------------------------------------

TRAIN_DIR = os.path.join(ROOT, "build", "train_smoke")
TRAIN_MODEL, TRAIN_DAG, TRAIN_LAYER, TRAIN_DEVICE = "vgg16", "resnet50", "block5_conv1", "cuda"
TRAIN_BATCH, TRAIN_STEPS, TRAIN_RESUMED_STEPS, TRAIN_SAVE_EVERY = 8, 10, 12, 5
TRAIN_TIMED_STEPS = 10  # per setting, after 2 warm-up steps
TRAIN_DAG_STEPS = 3
TRAIN_CHECK_BATCH = 2  # the card-vs-CPU step
TRAIN_LOSS_REL = 1e-5  # the card's loss against the CPU's, relative
TRAIN_GRAD_REL = 1e-4  # each gradient leaf, of its largest magnitude
TRAIN_PARAM_REL = 1e-2  # a param after a step, of its leaf's largest change, away from the gradient bar
TRAIN_SUMMARY_KEYS = ["batch", "checkpoint", "eval_accuracy", "eval_accuracy_initial", "eval_loss",
                      "eval_loss_initial", "final_loss", "mesh", "model", "resumed_from", "steps"]


def _train_cli(argv: list, env: dict) -> tuple[dict, float, list]:
    """One ``python -m deconv_api_tpu_torch train`` process: its summary
    line, its wall seconds and its progress lines."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deconv_api_tpu_torch", "train", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"train {argv}: rc {proc.returncode}\n{proc.stdout[-800:]}\n{proc.stderr[-1500:]}")
    return json.loads(lines[-1]), wall, [l for l in proc.stderr.splitlines() if l.startswith("step ")]


@contextlib.contextmanager
def _cudnn(torch, deterministic: bool):
    """cuDNN's deterministic algorithms on or off, autotuning off (the
    ``train`` command's settings when on)."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def _nondeterministic_ops(torch, step_fn, state, x, y) -> list:
    """The ops of one step that ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` names (a probe on a state of its own)."""
    import warnings

    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step_fn(state, x, y)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    return sorted({str(w.message).split("\n")[0][:200] for w in caught if "determinis" in str(w.message)})


def train_resume(torch, counted) -> dict:
    """(a) ``train --model vgg16 --steps 10 --batch 8 --save-every 5`` and
    then ``--steps 12 --resume`` as processes; the resumed checkpoint
    against an uninterrupted 12-step ``train_synthetic`` in this process
    under the command's cuDNN settings, bit for bit.  If they differ, the
    phase fails and its line names the leaves and the ops that
    ``torch.use_deterministic_algorithms`` names in one step."""
    from deconv_api_tpu_torch.models.weights import flat_leaves
    from deconv_api_tpu_torch.serving.models import build_bundle
    from deconv_api_tpu_torch.train import loop, step
    from deconv_api_tpu_torch.utils import checkpoint

    ckpt = os.path.join(TRAIN_DIR, "ckpt")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p)}
    common = ["--model", TRAIN_MODEL, "--device", TRAIN_DEVICE, "--batch", str(TRAIN_BATCH), "--save", ckpt,
              "--save-every", str(TRAIN_SAVE_EVERY)]
    first, first_wall, first_progress = _train_cli([*common, "--steps", str(TRAIN_STEPS)], env)
    resumed, resumed_wall, resumed_progress = _train_cli([*common, "--steps", str(TRAIN_RESUMED_STEPS), "--resume"],
                                                         env)
    out = {"cli_wall_s": {"train": first_wall, "resume": resumed_wall}, "summary": first, "resumed_summary": resumed,
           "progress_lines": [len(first_progress), len(resumed_progress)],
           "checkpoint_mb": {name: sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e6
                             for name, d in (("params", ckpt), ("train_state", ckpt + ".state"))}}
    bundle = build_bundle(TRAIN_MODEL, TRAIN_DEVICE)
    spec, init = bundle.spec, bundle.params
    with _cudnn(torch, True):
        straight, _ = counted(f"train {TRAIN_MODEL} {TRAIN_RESUMED_STEPS} steps (train_synthetic, in this process)",
                              lambda: loop.train_synthetic(spec, init, steps=TRAIN_RESUMED_STEPS, batch=TRAIN_BATCH,
                                                           device=TRAIN_DEVICE))
    restored = checkpoint.restore_params(ckpt, straight["params"])
    names = list(flat_leaves(restored))
    differ = {name: float((a - b).abs().max()) for name, a, b in
              zip(names, step.leaves(restored), step.leaves(straight["params"])) if not torch.equal(a, b)}
    out.update(straight_final_loss=straight["final_loss"], resume_bit_equal=not differ, leaves_that_differ=differ,
               leaves=len(names))
    if differ:  # name the ops that may explain it; the phase fails all the same
        with _cudnn(torch, True):
            init_fn, step_fn = step.make_train_step(spec, TRAIN_DEVICE, 1e-4)
            dev = torch.device(TRAIN_DEVICE)
            x, y = loop._synthetic_batch(loop._step_generator(0, 0, dev), TRAIN_BATCH, spec.input_shape,
                                         spec.layers[-1].filters)
            out["nondeterministic_ops"] = _nondeterministic_ops(torch, step_fn, init_fn(init), x, y)
    out["ok"] = (sorted(first) == TRAIN_SUMMARY_KEYS == sorted(resumed)
                 and all(math.isfinite(s[k]) for s in (first, resumed) for k in ("final_loss", "eval_loss"))
                 and (first["steps"], first["resumed_from"], resumed["steps"], resumed["resumed_from"])
                 == (TRAIN_STEPS, 0, TRAIN_RESUMED_STEPS, TRAIN_STEPS)
                 and out["progress_lines"] == [TRAIN_STEPS, TRAIN_RESUMED_STEPS - TRAIN_STEPS]
                 and out["resume_bit_equal"] and resumed["final_loss"] == straight["final_loss"])
    return out


class _Pinned:
    """The discrete choices of a VGG forward (each ReLU's gradient, each
    max-pool's argmax), recorded on one device and replayed on another.

    A unit whose input lies within rounding of 0 passes its gradient on one
    device and blocks it on the other; a pool window whose two largest
    inputs lie within rounding of each other sends its cotangent to
    another cell.  Either moves a weight's gradient by a whole term.
    Replaying the CPU's choices on the card leaves the kernels' rounding to
    be held.  ``rules`` goes to ``spec_forward``; ``pools()`` puts
    ``pool`` in the place of ``models/apply.py``'s ``maxpool``.  Recording,
    each is the plain op (``ops.activations.relu``: gradient 1 above 0,
    0.5 at 0, 0 below; ``F.max_pool2d``); replaying, a ReLU is ``x * gate``
    and a pool gathers its recorded argmax, cycling for remat's second
    forward, and ``apart`` counts the units and windows whose own choice
    differs."""

    def __init__(self, torch, recorded: "_Pinned | None" = None):
        from deconv_api_tpu_torch.models.blocks import INFERENCE_RULES, Rules

        self.torch, self.recorded = torch, recorded
        self.gates, self.argmax, self.turns = [], [], [0, 0]
        self.apart = {"relu": {}, "pool": {}}
        self.rules = Rules(relu=self.relu, relu6=INFERENCE_RULES.relu6)

    def _replay(self, kind: int, mine, theirs: list, x):
        i = self.turns[kind]
        self.turns[kind] += 1
        want = theirs[i % len(theirs)].to(x.device)
        if i < len(theirs):
            differ = int((mine != want.to(mine.dtype)).sum())
            if differ:
                self.apart["relu" if kind == 0 else "pool"][i] = differ
        return want

    def relu(self, x):
        from deconv_api_tpu_torch.ops.activations import relu

        gate = (x.detach() > 0).to(x.dtype) + 0.5 * (x.detach() == 0).to(x.dtype)
        if self.recorded is None:
            self.gates.append(gate.cpu())
            return relu(x)
        return x * self._replay(0, gate, self.recorded.gates, x).to(x.dtype)

    def pool(self, x, window, stride, padding):
        import torch.nn.functional as F

        assert padding == "VALID", padding
        xn = x.permute(0, 3, 1, 2)
        if self.recorded is None:
            out, idx = F.max_pool2d(xn, window, stride, return_indices=True)
            self.argmax.append(idx.cpu())
            return out.permute(0, 2, 3, 1)
        idx = self._replay(1, F.max_pool2d(xn.detach(), window, stride, return_indices=True)[1],
                           self.recorded.argmax, x)
        return xn.flatten(2).gather(2, idx.flatten(2)).view(idx.shape).permute(0, 2, 3, 1)

    @contextlib.contextmanager
    def pools(self):
        from deconv_api_tpu_torch.models import apply

        prev, apply.maxpool = apply.maxpool, self.pool
        try:
            yield
        finally:
            apply.maxpool = prev


def train_card_vs_cpu(torch, counted) -> dict:
    """(b) One VGG16 step at batch 2, float32 (TF32 off), on the card and on
    the CPU from the same numpy batch and params.

    The gradients: the card's forward replays the CPU's ReLU gates and
    pool argmaxes (``_Pinned``); the loss is held within TRAIN_LOSS_REL and
    every gradient leaf within TRAIN_GRAD_REL of its largest magnitude; the
    units and windows whose own choice differs are counted.  The step:
    ``make_train_step``'s ``step_fn`` with remat on, as the CLI runs it,
    on each device.  On the ModelSpec itself (the card's own choices) the
    loss is held within TRAIN_LOSS_REL and every param within 2 lr of the
    CPU's (Adam's first step is about lr sign(g), and a flipped choice can
    flip a gradient's sign), give or take float32's rounding of the param.
    With the CPU's choices replayed, every param whose CPU gradient lies
    above the gradient bar is held within TRAIN_PARAM_REL of its leaf's
    largest change, the others within 2 lr as above."""
    import numpy as np
    import torch.nn.functional as F

    from deconv_api_tpu_torch.models.apply import spec_forward
    from deconv_api_tpu_torch.models.weights import tree_map
    from deconv_api_tpu_torch.serving.models import build_bundle
    from deconv_api_tpu_torch.train import step

    bundle = build_bundle(TRAIN_MODEL, TRAIN_DEVICE)
    spec = bundle.spec
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((TRAIN_CHECK_BATCH, *spec.input_shape)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, spec.layers[-1].filters, TRAIN_CHECK_BATCH))
    host = tree_map(lambda t: t.cpu(), bundle.params)
    names = [f"{k}/{leaf}" for k, v in host.items() for leaf in v]
    relu_layers = [l.name for l in spec.layers if l.activation == "relu"]
    pool_layers = [l.name for l in spec.layers if l.kind == "pool"]
    lr = 1e-4
    card_dev, cpu_dev = torch.device(TRAIN_DEVICE), torch.device("cpu")

    def grads(dev, pinned):
        params = tree_map(lambda t: t.to(dev, torch.float32, copy=True).requires_grad_(True), host)
        with pinned.pools():
            logits, _ = spec_forward(spec, logits=True)(params, x.to(dev), rules=pinned.rules)
        loss = F.cross_entropy(logits, y.to(dev))
        return loss.item(), [g.cpu() for g in torch.autograd.grad(loss, step.leaves(params))]

    def one_step(dev, model, pinned=None):
        init_fn, step_fn = step.make_train_step(model, dev, lr, remat=True)
        with pinned.pools() if pinned else contextlib.nullcontext():
            state, loss = step_fn(init_fn(host), x.to(dev), y.to(dev))
        return loss.item(), [p.detach().cpu() for p in step.leaves(state.params)]

    t0 = time.perf_counter()
    cpu_choices = _Pinned(torch)
    cpu_loss, cpu_grads = grads(cpu_dev, cpu_choices)
    cpu_step = one_step(cpu_dev, spec)
    cpu_s = time.perf_counter() - t0

    def card():
        pinned, in_step = _Pinned(torch, cpu_choices), _Pinned(torch, cpu_choices)
        loss, g = grads(card_dev, pinned)
        model = lambda p, im: spec_forward(spec, logits=True)(p, im, rules=in_step.rules)[0]  # noqa: E731
        return loss, g, pinned.apart, one_step(card_dev, spec), one_step(card_dev, model, in_step)

    with _cudnn(torch, True):
        (loss, card_grads, apart, card_step, forced_step), _ = counted(
            f"train {TRAIN_MODEL} card-vs-CPU step (the card's half)", card)
    grad_rel = {n: float((g - h).abs().max() / h.abs().max().clamp_min(1e-30))
                for n, g, h in zip(names, card_grads, cpu_grads)}
    before = [t.to(torch.float32) for t in step.leaves(host)]

    def in_lr(err, q):  # lr units, float32's rounding of the params (1e-6 of their size) taken out
        return float((err - 1e-6 * (q.abs() + lr)).max()) / lr

    step_lr = {n: in_lr((p - q).abs(), q) for n, p, q in zip(names, card_step[1], cpu_step[1])}
    forced = {}
    for n, p, q, g, p0 in zip(names, forced_step[1], cpu_step[1], cpu_grads, before):
        err, noise = (p - q).abs(), g.abs() <= TRAIN_GRAD_REL * g.abs().max()
        change = float((q - p0).abs().max())
        forced[n] = {"of_change": float(err[~noise].max()) / change if (~noise).any() else 0.0,
                     "noise_lr": in_lr(err[noise], q[noise]) if noise.any() else 0.0}
    out = {"batch": TRAIN_CHECK_BATCH, "tf32": torch.backends.cudnn.allow_tf32, "cpu_s": cpu_s,
           "loss": [loss, cpu_loss], "loss_rel": abs(loss - cpu_loss) / abs(cpu_loss),
           "grad_rel_worst": sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3],
           "relu_gates_apart": {relu_layers[i]: k for i, k in apart["relu"].items()},
           "relu_gates": sum(g.numel() for g in cpu_choices.gates),
           "pool_windows_apart": {pool_layers[i]: k for i, k in apart["pool"].items()},
           "pool_windows": sum(i.numel() for i in cpu_choices.argmax),
           "step": {"loss": [card_step[0], cpu_step[0]], "loss_rel": abs(card_step[0] - cpu_step[0]) / abs(cpu_step[0]),
                    "params_worst_lr": max(step_lr.items(), key=lambda kv: kv[1])},
           "step_cpu_choices": {"loss_rel": abs(forced_step[0] - cpu_step[0]) / abs(cpu_step[0]),
                              "params_worst_of_change": max((v["of_change"], n) for n, v in forced.items()),
                              "params_worst_noise_lr": max((v["noise_lr"], n) for n, v in forced.items())}}
    out["ok"] = (out["loss_rel"] <= TRAIN_LOSS_REL and all(v <= TRAIN_GRAD_REL for v in grad_rel.values())
                 and out["step"]["loss_rel"] <= TRAIN_LOSS_REL and all(v <= 2 for v in step_lr.values())
                 and out["step_cpu_choices"]["loss_rel"] <= TRAIN_LOSS_REL
                 and all(v["of_change"] <= TRAIN_PARAM_REL and v["noise_lr"] <= 2 for v in forced.values()))
    return out


def _step_p50(torch, model, params, shape, classes: int, *, remat: bool = True, deterministic: bool = True,
              profiled: bool = False) -> dict:
    """p50 ms of TRAIN_TIMED_STEPS steps (host clock, each ended by a
    synchronize) after 2 warm-up steps, images/s, and the peak of
    ``max_memory_allocated`` over the timed steps beside what was allocated
    before them (the TrainState, the batches and the bundle's init params)."""
    from deconv_api_tpu_torch.train import loop, step

    dev = torch.device(TRAIN_DEVICE)
    init_fn, step_fn = step.make_train_step(model, dev, 1e-4, remat=remat)
    state = init_fn(params)
    batches = [loop._synthetic_batch(loop._step_generator(1, i, dev), TRAIN_BATCH, shape, classes) for i in range(2)]
    with _cudnn(torch, deterministic):
        for x, y in batches:
            state, _ = step_fn(state, x, y)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_TIMED_STEPS):
            x, y = batches[i % 2]
            t0 = time.perf_counter()
            state, loss = step_fn(state, x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        profile = device_breakdown(torch, lambda: step_fn(state, *batches[0]), top=8) if profiled else None
    p50 = statistics.median(times)
    out = {"p50_ms": p50, "images_per_s": TRAIN_BATCH / p50 * 1e3, "min_ms": min(times), "max_ms": max(times),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "allocated_before_gb": base / 1e9,
           "finite": all(math.isfinite(l) for l in losses), "state": state}
    if profile is not None:
        out["profile"] = profile
    return out


def train_times(torch, counted) -> dict:
    """(e) VGG16's step at batch 8: remat on and off, cuDNN deterministic
    on and off, in turns (on/on, off/on, on/off, on/on, the last with one
    profiled step); the AdamW update alone (CUDA events); the held-out
    evaluation of 128 images; a TrainState's checkpoint written and
    restored."""
    from deconv_api_tpu_torch.serving.models import build_bundle
    from deconv_api_tpu_torch.train import loop, step
    from deconv_api_tpu_torch.utils import checkpoint

    bundle = build_bundle(TRAIN_MODEL, TRAIN_DEVICE)
    spec, init, shape = bundle.spec, bundle.params, bundle.spec.input_shape
    classes = spec.layers[-1].filters
    runs = {}

    def turns():
        for name, kw in (("remat_det", {}), ("no_remat_det", {"remat": False}),
                         ("remat_nondet", {"deterministic": False}), ("remat_det_again", {"profiled": True})):
            gc.collect()
            torch.cuda.empty_cache()
            runs[name] = _step_p50(torch, spec, init, shape, classes, **kw)
            if name != "remat_det_again":
                runs[name].pop("state")
        return runs

    counted(f"train {TRAIN_MODEL} timed steps (remat and cuDNN settings in turns)", turns)
    state = runs["remat_det_again"].pop("state")
    dev = torch.device(TRAIN_DEVICE)
    images, labels = loop._synthetic_batch(torch.Generator(device=dev).manual_seed(loop._EVAL_SEED), 128, shape,
                                           classes)
    eval_fn = step.make_eval_step(spec)
    eval_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, acc = eval_fn(state.params, images, labels)
        float(loss)
        eval_s.append(time.perf_counter() - t0)
    grads = [torch.zeros_like(p) for p in step.leaves(state.params)]
    adamw_ms = time_ms(lambda: step.adamw(state.params, grads, state.opt_state, 1e-4), reps=5, warmup=1)
    path = os.path.join(TRAIN_DIR, "timed.state")
    t0 = time.perf_counter()
    checkpoint.save_train_state(path, state, model=TRAIN_MODEL)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpoint.restore_train_state(path, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(step.leaves(back.params), step.leaves(state.params)))
    out = {"steps": runs, "adamw_ms": adamw_ms, "eval_s": eval_s, "eval_images": 128,
           "train_state_bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
           "train_state_write_s": write_s, "train_state_restore_s": restore_s, "restored_equal": same}
    out["ok"] = same and all(r["finite"] for r in runs.values())
    return out


def train_dag(torch, counted) -> dict:
    """(c) ResNet50 at 224x224, batch 8: three steps with BatchNorm's
    leaves trained as weights, finite, those leaves moved."""
    from deconv_api_tpu_torch.serving.models import build_bundle
    from deconv_api_tpu_torch.train import loop, step

    bundle = build_bundle(TRAIN_DAG, TRAIN_DEVICE)
    init_fn, step_fn = step.make_train_step(lambda p, x: bundle.forward_fn(p, x, logits=True)[0], TRAIN_DEVICE, 1e-4)
    state = init_fn(bundle.params)
    def first_bn(tree):  # the first conv + BatchNorm node, in the tree's order
        return tree if "gamma" in tree else next(n for n in map(first_bn, filter(lambda v: isinstance(v, dict),
                                                                                  tree.values())) if n)

    node = first_bn(state.params)
    bn = {k: node[k].detach().clone() for k in ("gamma", "beta", "mean", "var")}
    dev = torch.device(TRAIN_DEVICE)
    shape = (bundle.image_size, bundle.image_size, 3)
    classes = bundle.params["predictions"]["w"].shape[1]

    def steps():
        nonlocal state
        losses, times = [], []
        for i in range(TRAIN_DAG_STEPS):
            x, y = loop._synthetic_batch(loop._step_generator(2, i, dev), TRAIN_BATCH, shape, classes)
            t0 = time.perf_counter()
            state, loss = step_fn(state, x, y)
            losses.append(loss.item())
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    with _cudnn(torch, True):
        (losses, times), _ = counted(f"train {TRAIN_DAG} steps", steps)
    moved = {k: not torch.equal(v, node[k]) for k, v in bn.items()}
    out = {"losses": losses, "step_ms": times, "bn_leaves_moved": moved}
    out["ok"] = all(math.isfinite(l) for l in losses) and all(moved.values())
    return out


def train_serve(torch, counted) -> dict:
    """(d) ``serve --weights <ckpt>`` beside the same server on its init:
    one ``POST /`` byte-equal to the server's in-process grid of the same
    image, unlike the init server's answer; the served params equal to
    the checkpoint's, bit for bit."""
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.serving import codec
    from deconv_api_tpu_torch.train import step
    from deconv_api_tpu_torch.utils import checkpoint

    ckpt = os.path.join(TRAIN_DIR, "ckpt")
    argv = ["serve", "--port", "0", "--device", TRAIN_DEVICE, "--model", TRAIN_MODEL, *ONE_BUCKET_FLAGS]
    uri = image_uris(1)[0]
    servers = []
    try:
        t0 = time.perf_counter()
        servers.append(build_server([*argv, "--weights", ckpt]))
        boot_s = time.perf_counter() - t0
        servers.append(build_server(argv))
        for server in servers:
            threading.Thread(target=server.serve_forever, daemon=True).start()
        (svc, port), (_, init_port) = ((s.service, s.server_address[1]) for s in servers)

        def post(p):
            status, body, _ = _request(p, "/", "POST", {"file": uri, "layer": TRAIN_LAYER})
            if status != 200:
                raise AssertionError(f"train serve POST /: {status} {body}")
            return body

        body, counts = counted("train serve --weights <checkpoint> POST /", lambda: post(port))
        grid = svc.visualize_batch(TRAIN_LAYER, svc.decode_preprocess(uri, svc.bundle)[None])["grid"][0]
        init_body = post(init_port)
        restored = checkpoint.restore_params(ckpt, svc.bundle.params)
        same = all(torch.equal(a, b) for a, b in zip(step.leaves(restored), step.leaves(svc.bundle.params)))
    finally:
        for server in servers:
            _stop(server)
    out = {"boot_s_with_checkpoint": boot_s, "served_equals_inprocess": body == codec.encode_data_url(grid),
           "differs_from_init": body != init_body,
           "psnr_vs_init_db": _psnr(_decode_jpeg_url(body), _decode_jpeg_url(init_body)),
           "served_params_equal_checkpoint": same,
           "launches": {k: counts[k] for k in ("pool_argmax", "unpool_argmax", "replays")}}
    out["ok"] = (out["served_equals_inprocess"] and out["differs_from_init"] and same
                 and counts["pool_argmax"] > 0 and counts["unpool_argmax"] > 0)
    return out


def phase_train(torch, label: str) -> dict:
    """Training on the card (``train/``, ``utils/checkpoint.py``): (a) the
    CLI's run and resume against an uninterrupted run, (b) one step against
    the CPU's, (c) ResNet50 with BatchNorm trained, (d) the checkpoint
    served, (e) the step's times and memory.  No hand-written kernel lies
    on a training step: each training window's launches must stay 0."""
    import shutil

    from deconv_api_tpu_torch import ops

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    by_path = {}

    def counted(name, fn):
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        got = {**ops.launch_counts(), **ops.graph_counts}
        by_path[name] = {k: got[k] for k in ops.launch_counts()}
        return result, got

    out = {"phase": "train", "card": label}
    wall = {}
    try:
        for part, run in (("resume", lambda: train_resume(torch, counted)),
                          ("card_vs_cpu", lambda: train_card_vs_cpu(torch, counted)),
                          ("dag", lambda: train_dag(torch, counted)),
                          ("serve", lambda: train_serve(torch, counted)),
                          ("times", lambda: train_times(torch, counted))):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out[part] = run()
            wall[part] = time.perf_counter() - t0
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    training = {path: c for path, c in by_path.items() if not path.startswith("train serve")}
    out["launches"] = by_path
    out["training_launches"] = sum(sum(c.values()) for c in training.values())
    out["wall_s"] = wall
    emit(out)
    failed = [part for part in wall if not out[part]["ok"]]
    if failed or out["training_launches"]:
        raise AssertionError(f"train: {failed} failed, {out['training_launches']} kernel launches on training "
                             "steps (see the phase's line)")
    return {"counts": by_path}


def _request_raw(port: int, form: dict):
    """``_keep_alive_post`` on a connection of its own."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        return _keep_alive_post(conn, form)
    finally:
        conn.close()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deconv_api_tpu_torch
    except ImportError:
        deconv_api_tpu_torch = None
    if deconv_api_tpu_torch is None or not os.path.abspath(deconv_api_tpu_torch.__file__).startswith(ROOT + os.sep):
        print("chip_smoke: run it from the root of a deconv_api_tpu checkout", file=sys.stderr)
        return 2

    wall = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        wall[name] = time.perf_counter() - t0
        return result

    env = timed("environment", phase_environment, torch)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch)
    ctx = timed("main_path", phase_main_path, torch)
    v1 = timed("v1_deconv", phase_v1_deconv, torch, ctx["uris"])
    timed("throughput", phase_throughput, torch, ctx, env["nvidia_smi"])
    timed("throughput_v1", phase_throughput_v1, torch, v1["bundle"], torch.from_numpy(ctx["xs"]).cuda(),
          env["nvidia_smi"])
    dag = timed("dag", phase_dag, torch, ctx["uris"], env["nvidia_smi"])
    dream = timed("dream", phase_dream, torch, ctx["uris"], env["nvidia_smi"])
    timed("capture", phase_capture, torch, ctx["bundle"], dag, dream, ctx["xs"], env["nvidia_smi"])
    multi = timed("multi_model", phase_multi_model, torch, ctx["uris"], env["nvidia_smi"])
    load = timed("load", phase_load, torch, env["nvidia_smi"])
    cache = timed("cache", phase_cache, torch, env["nvidia_smi"])
    quality = timed("quality", phase_quality, torch, env["nvidia_smi"])
    jobs = timed("jobs", phase_jobs, torch, env["nvidia_smi"])
    settings = timed("settings", phase_settings, torch, env["nvidia_smi"])
    fleet = timed("fleet", phase_fleet, torch, env["nvidia_smi"])
    weights = timed("weights", phase_weights, torch, env["nvidia_smi"])
    warm_boot = timed("warm_boot", phase_warm_boot, torch, env["nvidia_smi"])
    autoscaled = timed("autoscale", phase_autoscale, torch, env["nvidia_smi"])
    trained = timed("train", phase_train, torch, env["nvidia_smi"])
    emit({"phase": "wall_s", **wall})
    by_path = {"POST /": ctx["counts"], "POST /v1/deconv": v1["counts"],
               "resnet50 POST / and /v1/deconv": dag["counts"], "vgg19 POST /": dag["vgg19_counts"],
               "vgg19 POST / (fused_unpool auto)": dag["vgg19_auto_counts"], **dream["counts_by_path"],
               "multi_model POST / and /v1/dream": multi["counts"],
               "multi_model vgg16 POST / (graphs captured after its page-out)": multi["vgg16_counts"],
               "load POST /": load["counts"], "load POST / (server defaults: cache on)": load["defaults_counts"],
               "cache POST / (misses, hits at 0, one coalesced row, two recomputes)": cache["counts"],
               "quality POST / (full, bf16, int8, calibrated int8, the QoS turn)": quality["counts"],
               **jobs["counts"],
               **settings["counts"],
               "fleet POST / (three serve processes behind the router)": fleet["counts"],
               **weights["counts"],
               "warm_boot POST / (cold, warm and rebuilt boots on one kernel store)": warm_boot["counts"],
               "autoscale POST / and deconv jobs (the launched backend and b0 behind the router)":
                   autoscaled["counts"],
               **trained["counts"]}
    kernels = [
        {"name": name, "route": "cuda", **row,
         "launches": sum(c[name] for c in by_path.values()),
         "launches_by_path": {path: c[name] for path, c in by_path.items()}}
        for name, row in rows.items()
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
