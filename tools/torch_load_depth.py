#!/usr/bin/env python3
"""``pipeline_depth`` 1 against 2 on one NVIDIA GPU: ten turns (1, 2, 2, 1,
1, 2, 2, 1, 1, 2) of ``chip_smoke.py``'s load (BASELINE config 5: 256
keep-alive clients, VGG16 ``POST /`` at block5_conv1, 2048 requests a
turn) against two servers of one VGG16 bundle, after a 256-request warm-up
of each.  Every answer is checked as the ``load`` phase checks it.  Prints
one JSON line a turn.  Run from the root of a checkout on the card:
``python3 tools/torch_load_depth.py``."""

import json
import logging
import os
import sys
import urllib.parse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = (1, 2, 2, 1, 1, 2, 2, 1, 1, 2)


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as c
    from deconv_api_tpu_torch.__main__ import build_server
    from deconv_api_tpu_torch.serving import codec
    from deconv_api_tpu_torch.serving.app import Program
    from deconv_api_tpu_torch.serving.batcher import buckets

    logging.getLogger("deconv").setLevel(logging.ERROR)
    c.phase_environment(torch)
    servers = {2: build_server(["serve", "--port", "0", "--model", "vgg16", "--device", "cuda"])}
    servers[1] = c._second_server(torch, servers[2].service.bundle, pipeline_depth=1)
    try:
        uris = c.image_uris(c.LOAD_IMAGES)
        bodies = [urllib.parse.urlencode({"file": u, "layer": c.LOAD_LAYER}).encode() for u in uris]
        svc = servers[2].service
        xs = np.stack([svc.decode_preprocess(u) for u in uris])
        urls = [sorted({codec.encode_data_url(g) for b in buckets(svc.max_batch)
                        for g in svc.run_program(Program(c.LOAD_LAYER), np.repeat(xs[i : i + 1], b, 0))[c.LOAD_LAYER]["grid"]})
                for i in range(len(uris))]
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        refs = os.path.join(ROOT, "build", "load_refs.json")
        with open(refs, "w") as f:
            json.dump(urls, f)
        for depth in (2, 1):
            c._drive_load(torch, servers[depth], bodies, refs, 256)
        for turn, depth in enumerate(TURNS):
            r = c._drive_load(torch, servers[depth], bodies, refs, c.LOAD_REQUESTS, first=turn)
            c.emit({"turn": turn, "pipeline_depth": depth, **{k: r[k] for k in (
                "images_per_s", "p50_ms", "p99_ms", "device_busy_share", "server_cpu_cores", "statuses",
                "n_failures", "batch_size_histogram")}})
    finally:
        for server in servers.values():
            c._stop(server)
    return 0


if __name__ == "__main__":
    sys.exit(main())
