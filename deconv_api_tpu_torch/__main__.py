"""``python -m deconv_api_tpu_torch serve --port P [--model vgg16|vgg19|
resnet50|inception_v3|mobilenet_v1|mobilenet_v2|vgg_tiny] [--device
cuda|cpu] [--max-batch 8] [--lowc-kpack off|auto|forced|<chan>]``: serve the
reference's ``POST /``, the JSON API ``POST /v1/deconv`` and DeepDream's
``POST /v1/dream`` (``file``, optional ``layers``, ``steps``, ``octaves``,
``lr``; dreams have a dispatcher of their own, up to 4 a batch)."""

from __future__ import annotations

import argparse
import sys

from deconv_api_tpu_torch.engine.deconv import resolve_kpack_chan
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
from deconv_api_tpu_torch.serving.models import REGISTRY, build_bundle


def _kpack_policy(value: str) -> str:
    try:
        resolve_kpack_chan(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return value


def build_server(argv=None) -> DeconvHTTPServer:
    """Parse the command line, build the model on its device, start the
    dispatcher, warm the program up and bind the HTTP server (not yet
    serving)."""
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
    args = ap.parse_args(argv)

    service = DeconvService(
        build_bundle(args.model, args.device), max_batch=args.max_batch,
        lowc_kpack=args.lowc_kpack,
    )
    service.start()
    try:
        service.warmup()
        server = DeconvHTTPServer(service, args.host, args.port)
    except BaseException:
        service.close()
        raise
    print(f"serving {args.model} (lowc_kpack={args.lowc_kpack}) on "
          f"http://{args.host}:{server.server_address[1]}",
          file=sys.stderr, flush=True)
    return server


def main(argv=None) -> int:
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
