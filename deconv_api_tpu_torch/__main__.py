"""``python -m deconv_api_tpu_torch serve --port P [--model vgg16]
[--device cuda|cpu] [--max-batch 8]``: serve the reference's ``POST /``."""

from __future__ import annotations

import argparse
import sys

from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
from deconv_api_tpu_torch.serving.models import REGISTRY, build_bundle


def build_server(argv=None) -> DeconvHTTPServer:
    """Parse the command line, build the model on its device, start the
    dispatcher, warm the program up and bind the HTTP server (not yet
    serving)."""
    ap = argparse.ArgumentParser(prog="python -m deconv_api_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve POST / on HTTP")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--model", default="vgg16", choices=sorted(REGISTRY))
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    s.add_argument("--max-batch", type=int, default=8)
    args = ap.parse_args(argv)

    service = DeconvService(build_bundle(args.model, args.device), max_batch=args.max_batch)
    service.start()
    try:
        service.warmup()
        server = DeconvHTTPServer(service, args.host, args.port)
    except BaseException:
        service.close()
        raise
    print(f"serving {args.model} on http://{args.host}:{server.server_address[1]}",
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
