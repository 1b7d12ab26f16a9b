"""``python -m deconv_api_tpu_torch serve --port P [--model vgg16|vgg19|
resnet50|inception_v3|mobilenet_v1|mobilenet_v2|vgg_tiny] [--device
cuda|cpu] [--max-batch 8] [--lowc-kpack off|auto|forced|<chan>]
[--serve-models all|M1,M2] [--pinned-models M1,M2] [--hbm-budget-bytes N]
[--weight-dtype f32|bf16|int8] [--pipeline-depth 2] [--request-timeout-s 60]
[--fault SITE=SPEC] [--trace-ring 256] [--cache-bytes N] [--no-singleflight]
[--l2-dir DIR] [--slo NAME=MS:PCT[:ROUTE],...] [--tsdb off|on] [--alerts
JSON|PATH] [--qos] [--tenants JSON|PATH] [--quality-default full|bf16|int8]
[--quality-by-class CLASS=TIER,...] [--calibration-dir DIR] ...``: serve
the reference's ``POST /``, the
JSON API ``POST /v1/deconv`` and DeepDream's ``POST /v1/dream`` (``file``,
optional ``layers``, ``steps``, ``octaves``, ``lr``; dreams have a
dispatcher of their own, up to 4 a batch), for ``--model`` and every model
of ``--serve-models`` (a request names its model with ``model=`` or
``x-model``, and its precision tier with ``quality=`` or
``x-quality``: full, bf16 or int8), and the control routes ``/healthz``, ``/readyz``,
``/metrics``, ``/v1/config``, ``/v1/models`` and ``/v1/debug/requests``.
The request pipeline's fields of ``config.ServerConfig`` (timeouts,
connection limits, shedding, pipeline depth, codec pool, tracing, faults
and the breaker) and the response cache's, the SLOs', the metric
history's, the alerts', the QoS policy's and the quality tiers' each
have a flag, spelled as the JAX package's CLI spells it (``--slo`` for
``slos``, ``--no-singleflight``, ``--tenants`` implying ``--qos``), else
after the field."""

from __future__ import annotations

import argparse
import dataclasses
import sys

from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
from deconv_api_tpu_torch.serving.models import REGISTRY
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
}


def build_server(argv=None) -> DeconvHTTPServer:
    """Parse the command line, build the default model on its device,
    start the dispatchers, warm every pinned model's programs up and bind
    the HTTP server (not yet serving)."""
    ap = argparse.ArgumentParser(prog="python -m deconv_api_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve POST /, POST /v1/deconv and POST /v1/dream on HTTP")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--model", default="vgg16", choices=sorted(REGISTRY))
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    s.add_argument("--max-batch", type=int, default=8, help="images per deconv batch (default 8)")
    s.add_argument(
        "--lowc-kpack", type=_kpack_policy, default="off",
        help="packed low-channel backward tail: off|auto|forced|<chan> (default off)",
    )
    s.add_argument(
        "--serve-models", default="", metavar="all|M1,M2",
        help="registry models served per-request via model=/x-model "
        "('all', a comma list, or unset for single-model)",
    )
    s.add_argument(
        "--pinned-models", default="", metavar="M1,M2",
        help="models paged in + warmed at boot, never evicted (default: just --model)",
    )
    s.add_argument(
        "--hbm-budget-bytes", type=int, default=0,
        help="device byte budget for resident model weights (LRU page-out above it; 0 = unlimited)",
    )
    s.add_argument(
        "--weight-dtype", default="f32", metavar="f32|bf16|int8",
        help="stored weight precision on the device (quantized tiers trade "
        "PSNR-bounded fidelity for resident models)",
    )
    # the request pipeline's and the cache's fields, each named after its
    # ServerConfig field (the JAX CLI's names where it has one)
    for field in dataclasses.fields(ServerConfig):
        if field.name in _FIELD_FLAGS:
            flag = "--" + field.name.replace("_", "-")
            if field.type == "bool":
                s.add_argument(flag, action="store_true", help=_FIELD_FLAGS[field.name])
            else:
                s.add_argument(flag, type=_TYPES[field.type], default=field.default,
                               help=f"{_FIELD_FLAGS[field.name]} (default {field.default})")
    s.add_argument("--no-singleflight", action="store_true",
                   help="do not coalesce concurrent identical requests onto one computation")
    s.add_argument("--slo", default="", metavar="NAME=MS:PCT[:ROUTE],...",
                   help="latency SLO objects: burn-rate gauges on /metrics, an slo block on /readyz "
                   "(default none)")
    s.add_argument("--tsdb", default="off", choices=("off", "on"),
                   help="embedded metric history and GET /v1/metrics/history (default off)")
    s.add_argument("--alerts", default="", metavar="JSON|PATH",
                   help="alert rules, inline JSON or a JSON file (implies --tsdb on; default none)")
    s.add_argument("--qos", action="store_true",
                   help="enable multi-tenant QoS: tenant identity, priority classes, device-time budgets, "
                   "DRR fair queues (default off)")
    s.add_argument("--tenants", default="", metavar="JSON|PATH",
                   help="tenant policy spec, inline JSON or a JSON file (implies --qos)")
    s.add_argument("--qos-default-class", default="standard", metavar="interactive|standard|bulk",
                   help="priority class for tenants with no explicit class")
    s.add_argument("--quality-default", default="full", metavar="full|bf16|int8",
                   help="precision tier for requests that name none via quality=/x-quality (default full)")
    s.add_argument("--quality-by-class", default="bulk=int8", metavar="CLASS=TIER,...",
                   help="per-QoS-class default tiers (default 'bulk=int8'; empty disables class defaults)")
    s.add_argument("--calibration-dir", default="", metavar="DIR",
                   help="per-model int8 calibration artifacts (absent models use dynamic ranges)")
    s.add_argument(
        "--fault", action="append", default=None, metavar="SITE=SPEC",
        help="arm a fault-injection site at startup (repeatable; implies "
        "fault injection enabled — see serving/faults.py for sites/specs)",
    )
    args = ap.parse_args(argv)

    cfg = ServerConfig(
        model=args.model, max_batch=args.max_batch, lowc_kpack=args.lowc_kpack,
        serve_models=args.serve_models, pinned_models=args.pinned_models,
        hbm_budget_bytes=args.hbm_budget_bytes, weight_dtype=args.weight_dtype,
        faults=",".join(args.fault or ()), singleflight=not args.no_singleflight, slos=args.slo,
        tsdb=args.tsdb, alerts=args.alerts, qos=args.qos or bool(args.tenants), tenants=args.tenants,
        qos_default_class=args.qos_default_class, quality_default=args.quality_default,
        quality_by_class=args.quality_by_class, calibration_dir=args.calibration_dir,
        **{name: getattr(args, name) for name in _FIELD_FLAGS},
    )
    service = DeconvService(cfg=cfg, device=args.device)
    service.start()
    try:
        service.warmup()
        server = DeconvHTTPServer(service, args.host, args.port)
    except BaseException:
        service.close()
        raise
    served = ",".join(sorted(service.weights.served))
    print(f"serving {served} (default {args.model}, lowc_kpack={args.lowc_kpack}, "
          f"weight_dtype={args.weight_dtype}) on "
          f"http://{args.host}:{server.server_address[1]}",
          file=sys.stderr, flush=True)
    return server


def main(argv=None) -> int:
    slog.configure()  # the server entry point owns the logging setup (embedders don't)
    server = build_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
