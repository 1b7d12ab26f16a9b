"""``python -m deconv_api_tpu_torch serve --port P [--model vgg16|vgg19|
resnet50|inception_v3|mobilenet_v1|mobilenet_v2|vgg_tiny] [--device
cuda|cpu] [--max-batch 8] [--lowc-kpack off|auto|forced|<chan>]
[--fused-unpool off|auto|forced] [--top-k 8] [--stitch-k 4]
[--visualize-mode all|max] [--dtype float32|bfloat16] [--backward-dtype
bfloat16|float32|''] [--jobs-dir DIR] [--jobs-workers 2]
[--jobs-queue-depth 64] [--drain-grace-s 0] [--serve-models all|M1,M2]
[--weight-dtype f32|bf16|int8] [--fault SITE=SPEC] [--cache-bytes N]
[--no-singleflight] [--slo NAME=MS:PCT[:ROUTE],...] [--tsdb off|on]
[--qos] [--tenants JSON|PATH] [--calibration-dir DIR] ...``: serve the
reference's ``POST /``, the JSON API ``POST /v1/deconv`` and DeepDream's
``POST /v1/dream`` (``file``, optional ``layers``, ``steps``, ``octaves``,
``lr``; dreams have a dispatcher of their own, up to 4 a batch), for
``--model`` and every model of ``--serve-models`` (a request names its
model with ``model=`` or ``x-model``, and its precision tier with
``quality=`` or ``x-quality``: full, bf16 or int8), with ``--jobs-dir``
the durable async jobs ``POST /v1/jobs``, ``GET /v1/jobs``, ``GET
/v1/jobs/{id}[/result|/events]`` and ``DELETE /v1/jobs/{id}``, and the
control routes ``/healthz``, ``/readyz``, ``/metrics``, ``/v1/config``,
``/v1/models`` and ``/v1/debug/requests``.  Every field of
``config.ServerConfig`` the port honours is read from its ``DECONV_<FIELD>``
variable and most have a flag, spelled as the JAX package's CLI spells it
(``--slo`` for ``slos``, ``--no-singleflight``, ``--tenants`` implying
``--qos``), else after the field; a flag given wins over the variable.

A served process drains on SIGTERM or SIGINT: ``/readyz`` answers 503
and running jobs park, the drain is announced to the ``--fleet-routers``,
the listener stays up ``--drain-grace-s`` seconds, then the server stops
and the process exits 0; a second signal during the drain exits 130.  With
``--fleet-routers``/``--fleet-token`` the server registers with those
routers once its listener answers (``--fleet-advertise HOST:PORT``, the
address they should dial, ``--fleet-capacity``); ``--peer-fill`` honours
the routers' peer cache-fill hints and serves its own cache to its peers.

``--aot-dir DIR`` (``--aot-bytes N``) is the warm boot of
``serving/aot.py``: the boot takes the four kernel libraries from the
store in DIR, building and storing each one it lacks, before ``/ready``.

``python -m deconv_api_tpu_torch fleet-router [--backends H:P,H:P]
[--fleet-token T] [--port 8100] [--autoscale off|advisory|enforce] ...``
runs the cache-affine router of ``serving/fleet.py`` in front of such
servers, with the JAX package's ``fleet-router`` flags; ``autoscaler
--router HOST:PORT [--mode advisory|enforce] ...`` runs the controller of
``serving/autoscale.py`` beside a router, as a process of its own.
Neither loads torch.

``--weights PATH`` serves pretrained weights (``weights_path``): a Keras
``.h5`` (on a host with h5py) or ``.npz`` file for ``--model``, a
directory of ``<model>.h5`` / ``<model>.npz`` files, one per served model,
or a checkpoint directory that ``train`` wrote, for ``--model``.
``--profile-dir DIR`` traces the first ``DECONV_PROFILE_BATCHES`` (4)
device batches after warmup with ``torch.profiler``, and ``POST
/v1/profile`` (``batches=N``) arms N more.

``python -m deconv_api_tpu_torch calibrate --out DIR [--model vgg16]
[--images DIR] [--n-images 16] [--weights PATH] [--device cuda|cpu]``
writes the model's int8 calibration artifact (``<DIR>/<model>.calib.json``)
that a ``--calibration-dir DIR`` server loads (the JAX package's
``tools/calibrate.py``), from the weights the server runs.

The JAX package's offline commands, with its flags and output lines:
``visualize --image PATH --layer L [--output deconv.png] [--mode all|max]
[--top-k 8] [--sweep]`` saves the 2x2 grid of the layer's projections (with
``--sweep`` one per layer from L down) and prints one JSON line; ``dream
--image PATH [--layers A,B] [--output dream.png] [--steps 10] [--octaves
10] [--lr 0.01]`` saves the dreamed image; both take ``--model``,
``--weights`` and ``--platform cuda|cpu`` (default the card).  ``train
[--steps 10] [--batch 8] [--lr 1e-4] [--mesh ""] [--save DIR] [--seed 0]
[--save-every 0] [--resume]`` fine-tunes the model on learnable synthetic
data (``train/loop.py``; one device: a ``--mesh`` of several is refused
until the parallel slice), saves a checkpoint to ``--save`` that
``serve --weights DIR`` loads, and prints the JAX CLI's summary line.  ``models``
prints one JSON line per registry model.  ``doctor [--checks
backend,rtt,build,selftest] [--platform cpu]`` runs the diagnostics of
``utils/doctor.py``, each in a child process."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import sys

if __name__ == "__main__" and sys.argv[1:2] in (["fleet-router"], ["autoscaler"]):
    # the router and the autoscaler need no model stack: dispatched
    # before torch loads
    if sys.argv[1] == "fleet-router":
        from deconv_api_tpu_torch.serving.fleet import main as _sidecar_main
    else:
        from deconv_api_tpu_torch.serving.autoscale import main as _sidecar_main

    sys.exit(_sidecar_main(sys.argv[2:]))

import numpy as np

from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.engine import quant
from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.models.weights import load_model_weights, tree_map
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService, Program
from deconv_api_tpu_torch.serving.models import REGISTRY, build_bundle, registry_info
from deconv_api_tpu_torch.utils import slog


def _kpack_policy(value: str) -> str:
    try:
        resolve_kpack_chan(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return value


_TYPES = {"int": int, "float": float, "str": str}  # ServerConfig's annotations are strings
_FIELD_FLAGS = {
    "request_timeout_s": "seconds a POST / or /v1/deconv request may wait for its batch",
    "sweep_timeout_s": "the same for a sweep=true request",
    "dream_timeout_s": "the same for a /v1/dream request",
    "dream_max_batch": "images per dream batch",
    "dream_window_ms": "the dream dispatcher's straggler window",
    "conn_idle_timeout_s": "seconds an idle or slow-header connection is kept (0 = forever)",
    "body_read_timeout_s": "seconds a request body may take to arrive, else 408 (0 = forever)",
    "max_connections": "concurrent connections; excess ones get 503 and are closed",
    "shed_factor": "shed (503 overloaded) when the queue's drain estimate exceeds this times "
                   "the request timeout (0 disables)",
    "pipeline_depth": "dispatched but unfetched batches a dispatcher may hold (1 = serial)",
    "codec_workers": "decode/encode worker threads (0 = auto)",
    "codec_queue_depth": "queued-or-running codec jobs before callers wait",
    "codec_inline_bytes": "bodies of at most this many bytes decode on the event loop",
    "input_ring_depth": "reusable staging buffers per batch shape",
    "trace_ring": "flight-recorder ring size per class (0 disables tracing)",
    "trace_slow_ms": "latency threshold for the slow-trace ring (ms)",
    "trace_sample": "head-sample rate for the recent-trace ring (0..1)",
    "fault_injection": "enable the fault-injection registry",
    "fault_seed": "seed for the fault registry's deterministic RNG",
    "breaker_threshold": "consecutive batch failures that open the device circuit breaker (0 disables)",
    "breaker_cooldown_s": "seconds the breaker stays open before a half-open probe",
    "cache_bytes": "response-cache byte budget (0 disables the cache)",
    "cache_ttl_s": "positive cache-entry TTL in seconds (0 = until evicted)",
    "cache_negative_ttl_s": "seconds a deterministic 4xx stays cached (0 disables negative caching)",
    "cache_shards": "response-cache LRU shards",
    "l2_dir": "durable L2 response-cache directory (empty disables the disk tier)",
    "l2_bytes": "L2 byte budget (0 = unbounded)",
    "tsdb_interval_s": "metric-history scrape interval in seconds",
    "incidents_dir": "directory for incident bundles (empty = none recorded)",
    "incidents_retention_s": "seconds incident bundles are kept",
    "qos_weights": "DRR quantum weights per class, 'class=weight,...' (default interactive=8,standard=4,bulk=1)",
    "qos_hit_cost_ms": "device-ms a response-cache hit debits from its tenant's bucket",
    # the server settings
    "image_size": "pixels every request resizes to (0 = each model's own size)",
    "top_k": "/v1/deconv's filters when the request names no top_k",
    "stitch_k": "filters POST / projects into its 2x2 grid",
    "visualize_mode": "the projection's mode when the request names none: all|max",
    "bug_compat": "reproduce the reference's projection quirks",
    "strict_compat": "answer 422 no_active_filters when fewer than stitch_k filters fired",
    "dtype": "the forward's dtype: float32|bfloat16",
    "backward_dtype": "the projection's dtype: bfloat16|float32|'' (no cast)",
    "fused_unpool": "the fused unpool + conv backward tail (K3): off|auto|forced",
    "warmup_all_buckets": "capture every batch bucket at boot (else the first)",
    "warmup_sweep": "capture the sweep program at boot",
    "warmup_dream": "capture the default dream at boot",
    "drain_grace_s": "seconds /readyz answers 503 before the dispatchers stop on shutdown",
    # the durable job tier
    "jobs_dir": "journal and spill directory of the async job tier (empty: no /v1/jobs routes)",
    "jobs_workers": "concurrent job runners",
    "jobs_queue_depth": "queued-or-running jobs before a submit gets 429",
    "jobs_retention_s": "seconds finished jobs and their results are kept",
    "jobs_max_attempts": "runner crashes a job resumes from before it fails",
    # the fleet tier's backend half
    "peer_fill_timeout_s": "seconds a peer cache fill may take before the miss computes",
    "fleet_routers": "router addresses 'host:port,...' this server registers with, and announces its drain to",
    "fleet_token": "shared fleet secret presented on registration announcements (x-fleet-token)",
    "fleet_advertise": "the host:port this server registers as (default <hostname>:<port>)",
    "fleet_capacity": "capacity this member advertises to the routers' ring (0 = auto: 1)",
    "profile_dir": "torch.profiler trace directory: the first DECONV_PROFILE_BATCHES batches after warmup, "
                   "and POST /v1/profile (empty disables)",
    # the warm boot
    "aot_dir": "store of the built kernel libraries: the boot loads them from it, building and storing "
               "each one it lacks (empty: built into the checkout at first use)",
    "aot_bytes": "the store's byte budget; the oldest entries are swept above it (0 = unbounded)",
}


def _add_common(p: argparse.ArgumentParser, model_default=None) -> None:
    """``--model``, ``--weights`` and ``--platform`` of the offline
    commands (the JAX CLI's ``_add_common``)."""
    p.add_argument("--model", default=model_default, help="registry model name (default vgg16)")
    p.add_argument("--weights", default=None, metavar="PATH",
                   help="Keras .h5 (needs h5py) or .npz weights, or a directory of <model>.h5/.npz")
    p.add_argument("--platform", "--device", dest="device", default="cuda", choices=("cuda", "cpu"),
                   help="where it runs (default the card)")


def _parser() -> argparse.ArgumentParser:
    """The subcommands: ``serve``, ``calibrate``, ``visualize``, ``dream``,
    ``train``, ``models`` and ``doctor``.  Every flag of
    ``serve`` that names a ``ServerConfig`` field defaults to None: a flag
    given wins over the field's ``DECONV_<FIELD>`` variable, which wins
    over the default (``ServerConfig.from_env``)."""
    ap = argparse.ArgumentParser(prog="python -m deconv_api_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve POST /, POST /v1/deconv, POST /v1/dream and the job routes on HTTP")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--model", default=None, choices=sorted(REGISTRY), help="the default model (default vgg16)")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    s.add_argument("--max-batch", type=int, default=None, help="images per deconv batch (default 8)")
    s.add_argument(
        "--lowc-kpack", type=_kpack_policy, default=None,
        help="packed low-channel backward tail: off|auto|forced|<chan> (default off)",
    )
    s.add_argument(
        "--serve-models", default=None, metavar="all|M1,M2",
        help="registry models served per-request via model=/x-model "
        "('all', a comma list, or unset for single-model)",
    )
    s.add_argument(
        "--pinned-models", default=None, metavar="M1,M2",
        help="models paged in + warmed at boot, never evicted (default: just --model)",
    )
    s.add_argument(
        "--hbm-budget-bytes", type=int, default=None,
        help="device byte budget for resident model weights (LRU page-out above it; 0 = unlimited)",
    )
    s.add_argument("--weights", dest="weights_path", default=None, metavar="PATH",
                   help="pretrained weights: a Keras .h5 (needs h5py) or .npz file for --model, or a "
                   "directory of <model>.h5/.npz files (default: He-normal init)")
    s.add_argument(
        "--weight-dtype", default=None, metavar="f32|bf16|int8",
        help="stored weight precision on the device (quantized tiers trade "
        "PSNR-bounded fidelity for resident models)",
    )
    # the other fields, each named after its ServerConfig field (the JAX
    # CLI's names where it has one)
    for field in dataclasses.fields(ServerConfig):
        if field.name in _FIELD_FLAGS:
            flag = "--" + field.name.replace("_", "-")
            if field.type == "bool":
                s.add_argument(flag, action=argparse.BooleanOptionalAction, default=None,
                               help=f"{_FIELD_FLAGS[field.name]} (default {field.default})")
            else:
                s.add_argument(flag, type=_TYPES[field.type], default=None,
                               help=f"{_FIELD_FLAGS[field.name]} (default {field.default!r})")
    s.add_argument("--peer-fill", action="store_true",
                   help="honour the routers' x-peer-fill hint on cache misses and serve GET "
                   "/v1/internal/cache/{digest} to ring peers (trusted meshes only; default off)")
    s.add_argument("--no-singleflight", action="store_true",
                   help="do not coalesce concurrent identical requests onto one computation")
    s.add_argument("--slo", default=None, metavar="NAME=MS:PCT[:ROUTE],...",
                   help="latency SLO objects: burn-rate gauges on /metrics, an slo block on /readyz "
                   "(default none)")
    s.add_argument("--tsdb", default=None, choices=("off", "on"),
                   help="embedded metric history and GET /v1/metrics/history (default off)")
    s.add_argument("--alerts", default=None, metavar="JSON|PATH",
                   help="alert rules, inline JSON or a JSON file (implies --tsdb on; default none)")
    s.add_argument("--qos", action="store_true",
                   help="enable multi-tenant QoS: tenant identity, priority classes, device-time budgets, "
                   "DRR fair queues (default off)")
    s.add_argument("--tenants", default=None, metavar="JSON|PATH",
                   help="tenant policy spec, inline JSON or a JSON file (implies --qos)")
    s.add_argument("--qos-default-class", default=None, metavar="interactive|standard|bulk",
                   help="priority class for tenants with no explicit class (default standard)")
    s.add_argument("--quality-default", default=None, metavar="full|bf16|int8",
                   help="precision tier for requests that name none via quality=/x-quality (default full)")
    s.add_argument("--quality-by-class", default=None, metavar="CLASS=TIER,...",
                   help="per-QoS-class default tiers (default 'bulk=int8'; empty disables class defaults)")
    s.add_argument("--calibration-dir", default=None, metavar="DIR",
                   help="per-model int8 calibration artifacts (absent models use dynamic ranges)")
    s.add_argument(
        "--fault", action="append", default=None, metavar="SITE=SPEC",
        help="arm a fault-injection site at startup (repeatable; implies "
        "fault injection enabled — see serving/faults.py for sites/specs)",
    )
    # parsed by serving/fleet.py's and serving/autoscale.py's own mains
    # (main() dispatches to them first)
    sub.add_parser("fleet-router", add_help=False,
                   help="the cache-affine consistent-hash router over N serve processes (no torch)")
    sub.add_parser("autoscaler", add_help=False,
                   help="the autoscale controller beside a router, over its federation plane (no torch)")
    c = sub.add_parser("calibrate", help="write a model's int8 calibration artifact for --calibration-dir")
    c.add_argument("--model", default="vgg16", help="registry model name (default vgg16)")
    c.add_argument("--out", required=True, metavar="DIR", help="calibration dir the server reads (--calibration-dir)")
    c.add_argument("--images", default="", metavar="DIR",
                   help="directory of jpeg/png calibration captures (default: seeded synthetic noise)")
    c.add_argument("--n-images", type=int, default=16,
                   help="synthetic image count when --images is unset (default 16)")
    c.add_argument("--weights", default="", metavar="PATH",
                   help="optional .h5/.npz weights (ranges should describe the weights the server runs)")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    v = sub.add_parser("visualize", help="deconv visualization of one image")
    v.add_argument("--image", required=True)
    v.add_argument("--layer", required=True)
    v.add_argument("--output", default="deconv.png")
    v.add_argument("--mode", default="all", choices=("all", "max"))
    v.add_argument("--top-k", type=int, default=8, dest="top_k")
    v.add_argument("--sweep", action="store_true", help="project every layer from --layer down (one output per layer)")
    _add_common(v)
    d = sub.add_parser("dream", help="multi-octave DeepDream on one image")
    d.add_argument("--image", required=True)
    d.add_argument("--layers", default="", help="comma-separated activations")
    d.add_argument("--output", default="dream.png")
    d.add_argument("--steps", type=int, default=10)
    d.add_argument("--octaves", type=int, default=10)
    d.add_argument("--lr", type=float, default=0.01)
    _add_common(d)
    t = sub.add_parser("train", help="synthetic fine-tune on the card, save a checkpoint that serve --weights loads")
    t.add_argument("--steps", type=int, default=10)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--mesh", default="", help="dp[,tp] mesh shape: one device only (1 or 1,1) until the parallel slice")
    t.add_argument("--save", default="", help="checkpoint output dir")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--save-every", type=int, default=0,
                   help="checkpoint the full TrainState to <save>.state every N steps")
    t.add_argument("--resume", action="store_true", help="restore <save>.state and continue from its recorded step")
    _add_common(t)
    sub.add_parser("models", help="list registered models")
    doc = sub.add_parser("doctor", help="environment diagnostics (backend, RTT, kernel build, selftest)")
    doc.add_argument("--checks", default="", help="comma list (default all): backend,rtt,build,selftest")
    doc.add_argument("--platform", default="", choices=("", "cuda", "cpu"),
                     help="run the probes on this device (default the card)")
    return ap


# serve's other flags that name their field
_FIELD_ARGS = ("model", "max_batch", "lowc_kpack", "serve_models", "pinned_models", "hbm_budget_bytes",
               "weights_path",
               "weight_dtype", "tsdb", "alerts", "tenants", "qos_default_class", "quality_default",
               "quality_by_class", "calibration_dir", *_FIELD_FLAGS)


def server_config(args) -> ServerConfig:
    """``serve``'s configuration: the defaults, the ``DECONV_*`` variables,
    then the flags given."""
    overrides = {name: getattr(args, name) for name in _FIELD_ARGS if getattr(args, name) is not None}
    if args.slo is not None:
        overrides["slos"] = args.slo
    if args.fault:
        overrides["faults"] = ",".join(args.fault)
    if args.no_singleflight:
        overrides["singleflight"] = False
    if args.peer_fill:
        overrides["fleet_peer_fill"] = True
    if args.qos or args.tenants is not None:
        overrides["qos"] = True
    return ServerConfig.from_env(**overrides)


def build_server(argv=None) -> DeconvHTTPServer:
    """Parse a ``serve`` command line, build the default model on its
    device, start the dispatchers (and the job runners), warm every pinned
    model's programs up and bind the HTTP server (not yet serving)."""
    args = _parser().parse_args(argv)
    if args.cmd != "serve":
        raise SystemExit(f"build_server serves; got the {args.cmd!r} command")
    cfg = server_config(args)
    service = DeconvService(cfg=cfg, device=args.device)
    service.start()
    try:
        service.warmup()
        server = DeconvHTTPServer(service, args.host, args.port)
    except BaseException:
        service.close()
        raise
    served = ",".join(sorted(service.weights.served))
    print(f"serving {served} (default {cfg.model}, lowc_kpack={cfg.lowc_kpack}, "
          f"weight_dtype={cfg.weight_dtype}) on "
          f"http://{args.host}:{server.server_address[1]}",
          file=sys.stderr, flush=True)
    return server


def _calibration_images(images_dir: str, size: int, preprocess) -> list:
    """The jpeg/png files of ``images_dir`` in name order, loaded as the JAX
    package's ``tools/calibrate.py`` loads them, so that the same captures
    give the same ranges: PIL's RGB decode, PIL's default ``resize`` to
    ``size`` x ``size``, then ``preprocess`` on that RGB array (which the
    preprocess reads as BGR: the reference tool's channel order, ROADMAP
    Queue C).  An unreadable file is skipped with a line on stderr."""
    from PIL import Image

    out = []
    for fn in sorted(os.listdir(images_dir)):
        if not fn.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        try:
            with Image.open(os.path.join(images_dir, fn)) as f:
                img = f.convert("RGB")
        except (OSError, ValueError) as e:
            print(f"skipping {fn}: {type(e).__name__}: {e}", file=sys.stderr)
            continue
        out.append(preprocess(np.asarray(img.resize((size, size)), np.float32)))
    return out


def _synthetic_images(n: int, size: int, preprocess) -> list:
    """``n`` seeded noise images: the same set, so the same artifact, on
    every run and host."""
    return [preprocess(np.random.default_rng(i).integers(0, 256, (size, size, 3)).astype(np.float32))
            for i in range(n)]


def calibrate(args) -> int:
    """``calibrate``: per-layer int8 input ranges of ``--model`` (its
    registry weights) over ``--images`` (else ``--n-images`` seeded noise
    images), written as ``<out>/<model>.calib.json``
    (``engine/quant.py:collect_ranges`` and ``save_calibration``), the
    artifact a ``--calibration-dir`` server binds its int8 keys to.  Runs
    on ``--device``; prints one JSON line."""
    if args.model not in REGISTRY:
        print(f"unknown model {args.model!r}; available: {sorted(REGISTRY)}", file=sys.stderr)
        return 2
    bundle = build_bundle(args.model, args.device)
    if bundle.spec is None:
        print(f"model {args.model!r} is a DAG backbone: quality=int8 runs as bf16 there and needs no "
              "calibration", file=sys.stderr)
        return 2
    if args.weights:
        bundle.params = load_model_weights(args.model, bundle.spec, args.weights, bundle.params)
    size = bundle.image_size
    if args.images:
        images = _calibration_images(args.images, size, bundle.preprocess)
        source = f"images:{os.path.abspath(args.images)}"
        if not images:
            print(f"no decodable images in {args.images}", file=sys.stderr)
            return 2
    else:
        images = _synthetic_images(args.n_images, size, bundle.preprocess)
        source = f"synthetic:{args.n_images}"
    ranges = quant.collect_ranges(bundle.spec, bundle.params, images)
    path, digest = quant.save_calibration(args.out, args.model, ranges, image_size=size, n_images=len(images),
                                          source=source)
    print(json.dumps({"which": "calibrate", "model": args.model, "path": path, "digest": digest,
                      "layers": len(ranges), "n_images": len(images), "source": source}))
    return 0


@contextlib.contextmanager
def _offline_service(args):
    """The service an offline command runs on: the default configuration
    and ``DECONV_*`` variables, with ``--model`` and ``--weights``, on
    ``--platform``, closed at the end.  It runs cuDNN's deterministic
    algorithms, so that a command gives the same image on every run (a
    float32 dream's input gradient otherwise differs between runs in its
    last bits, and its PNG by a level here and there)."""
    import torch

    overrides = {}
    if args.model:
        overrides["model"] = args.model
    if args.weights:
        overrides["weights_path"] = args.weights
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        svc = DeconvService(cfg=ServerConfig.from_env(**overrides), device=args.device)
        try:
            yield svc
        finally:
            svc.close()
    finally:
        torch.backends.cudnn.deterministic = prev


def _read_image(path: str, size: int) -> np.ndarray:
    """PIL's RGB decode resized to ``size`` x ``size``, as BGR (the
    serving decode's channel order) float32."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(img)[:, :, ::-1].astype(np.float32)


def visualize(args) -> int:
    """``visualize``: the 2x2 grid of ``--layer``'s top projections of one
    image, saved as ``--output`` (with ``--sweep`` one grid per layer that
    fired, from the layer down, as ``<stem>_<layer><ext>``); one JSON
    line."""
    from PIL import Image

    with _offline_service(args) as svc:
        try:
            svc.bundle.check_layer(args.layer)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2
        x = svc.bundle.preprocess(_read_image(args.image, svc.cfg.image_size))
        result = svc.run_program(Program(args.layer, args.mode, args.top_k, "grid", args.sweep), x[None])
    if args.sweep:
        stem, ext = os.path.splitext(args.output)
        outputs = {}
        # in name order, as the JAX CLI lists them (its result tree comes
        # back with sorted keys)
        for name, entry in sorted(result.items()):
            if int(entry["valid"][0].sum()) == 0:
                continue
            path = f"{stem}_{name}{ext or '.png'}"
            Image.fromarray(entry["grid"][0][:, :, ::-1]).save(path)
            outputs[name] = path
        if not outputs:
            print("no filters fired for any layer", file=sys.stderr)
            return 1
        print(json.dumps({"outputs": outputs, "layer": args.layer}))
        return 0
    entry = result[args.layer]
    n_valid = int(entry["valid"][0].sum())
    if n_valid == 0:
        print("no filters fired for this layer/image", file=sys.stderr)
        return 1
    Image.fromarray(entry["grid"][0][:, :, ::-1]).save(args.output)
    # the 2x2 grid shows at most 4 tiles: exactly those are reported
    print(json.dumps({"output": args.output, "layer": args.layer,
                      "filters": [int(i) for i in entry["indices"][0][: min(n_valid, 4)]]}))
    return 0


def dream(args) -> int:
    """``dream``: one image dreamed through ``--layers`` (default the
    model's dream layers) by the engine, saved as ``--output``; one JSON
    line with the final loss."""
    from PIL import Image

    from deconv_api_tpu_torch.engine.deepdream import deepdream

    with _offline_service(args) as svc:
        bundle = svc.bundle
        layers = tuple(s for s in args.layers.split(",") if s) if args.layers else bundle.dream_layers
        x = bundle.preprocess(_read_image(args.image, svc.cfg.image_size))
        # the f32 tree on the bundle's device (managed, it lives on the host)
        params = tree_map(lambda t: t.to(bundle.device), bundle.params)
        out, loss = deepdream(bundle.dream_forward(layers), params, x, layers=layers,
                              steps_per_octave=args.steps, num_octaves=args.octaves, lr=args.lr,
                              min_size=bundle.min_dream_size, device=bundle.device)
        img = bundle.unpreprocess(out.cpu().numpy())
    Image.fromarray(img[:, :, ::-1]).save(args.output)
    print(json.dumps({"output": args.output, "layers": list(layers), "loss": float(loss)}))
    return 0


def train(args) -> int:
    """``train``: ``train/loop.py:train_synthetic`` on ``--model`` (its
    registry init, or ``--weights``), on the service's own float32 copy of
    the params, under cuDNN's deterministic algorithms (so that a resumed
    run repeats an uninterrupted one bit for bit); the JAX CLI's summary
    line, without the params, and a progress line a step on stderr."""
    import torch

    from deconv_api_tpu_torch.train.loop import train_synthetic

    mesh_shape = tuple(int(x) for x in args.mesh.split(",") if x)
    common = dict(
        steps=args.steps, batch=args.batch, lr=args.lr, mesh_shape=mesh_shape, save_dir=args.save,
        seed=args.seed, save_every=args.save_every, resume=args.resume, device=args.device,
        progress=lambda i, loss: print(f"step {i}: loss {loss:.4f}", file=sys.stderr, flush=True),
    )
    prev_benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        with _offline_service(args) as svc:
            bundle = svc.bundle
            if bundle.spec is not None:
                result = train_synthetic(bundle.spec, bundle.params, **common)
            else:
                # a DAG family: the class count from a forward on the meta
                # device (shapes only), the input size from the bundle
                size = bundle.image_size
                meta = tree_map(lambda t: t.to("meta"), bundle.params)
                out, _ = bundle.forward_fn(meta, torch.empty((1, size, size, 3), device="meta"), logits=True)
                result = train_synthetic(None, bundle.params, forward_fn=bundle.forward_fn, model_name=bundle.name,
                                         num_classes=int(out.shape[-1]), input_shape=(size, size, 3), **common)
    finally:
        torch.backends.cudnn.benchmark = prev_benchmark
    result.pop("params")  # not printable
    print(json.dumps(result))
    return 0


def doctor(args) -> int:
    """``doctor``: the diagnostics of ``utils/doctor.py``."""
    from deconv_api_tpu_torch.utils.doctor import CHECKS, run_doctor

    names = [c for c in args.checks.split(",") if c] if args.checks else None
    unknown = set(names or ()) - set(CHECKS)
    if unknown:
        print(f"unknown checks: {sorted(unknown)}; have {sorted(CHECKS)}", file=sys.stderr)
        return 2
    return run_doctor(names, device=args.platform or None)


class _Stop(BaseException):
    """SIGTERM or SIGINT: leaves ``serve_forever`` for the drain."""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["fleet-router"]:
        from deconv_api_tpu_torch.serving.fleet import main as fleet_main

        return fleet_main(argv[1:])
    if argv[:1] == ["autoscaler"]:
        from deconv_api_tpu_torch.serving.autoscale import main as autoscale_main

        return autoscale_main(argv[1:])
    args = _parser().parse_args(argv)
    if args.cmd == "models":
        for info in registry_info():
            print(json.dumps(info))
        return 0
    commands = {"calibrate": calibrate, "visualize": visualize, "dream": dream, "train": train, "doctor": doctor}
    if args.cmd in commands:
        return commands[args.cmd](args)
    slog.configure()  # the server entry point owns the logging setup (embedders don't)
    server = build_server(argv)
    service = server.service
    signals = []

    def on_signal(signum, _frame) -> None:
        if signals:
            # a second signal during the drain: the drain is wedged or
            # unwanted, and this handler swallowed the default exit
            os._exit(130)
        signals.append(signum)
        raise _Stop

    previous = {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        # the routers admit this backend at their next probe of /readyz
        service.on_loop(service.announce_to_routers("register"))
        server.serve_forever()
    except _Stop:
        pass
    finally:
        # the drain, with the listener up: /readyz answers 503 and running
        # jobs park, the routers hear of it, drain_grace_s passes, the
        # dispatchers stop; then the listener closes
        service.close()
        server.server_close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
