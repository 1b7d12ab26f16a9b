"""InceptionV3 (Keras topology) as a forward function + nested params
(counterpart of ``deconv_api_tpu/models/inception_v3.py``).

Activation names match Keras (``mixed0`` .. ``mixed10``).  The input is
299x299x3; the VALID-padded stem needs at least 75 px.  Branches
concatenate along the channels in the reference's order.
"""

from __future__ import annotations

import torch

from deconv_api_tpu_torch.models import blocks as B


def inception_v3_init(gen: torch.Generator, num_classes: int = 1000, device="cpu") -> dict:
    """He-normal weights drawn from ``gen`` in the reference's tree layout."""

    def cb(cin, cout, kernel):
        return B.conv_bn_init(gen, cin, cout, kernel, device)

    p: dict = {
        "stem1": cb(3, 32, (3, 3)),
        "stem2": cb(32, 32, (3, 3)),
        "stem3": cb(32, 64, (3, 3)),
        "stem4": cb(64, 80, (1, 1)),
        "stem5": cb(80, 192, (3, 3)),
    }

    def block_a(name, cin, pool_proj):
        p[name] = {
            "b1": cb(cin, 64, (1, 1)),
            "b5_1": cb(cin, 48, (1, 1)),
            "b5_2": cb(48, 64, (5, 5)),
            "b3_1": cb(cin, 64, (1, 1)),
            "b3_2": cb(64, 96, (3, 3)),
            "b3_3": cb(96, 96, (3, 3)),
            "pool": cb(cin, pool_proj, (1, 1)),
        }
        return 64 + 64 + 96 + pool_proj

    c = block_a("mixed0", 192, 32)
    c = block_a("mixed1", c, 64)
    c = block_a("mixed2", c, 64)
    # mixed3: grid reduction 35 -> 17
    p["mixed3"] = {
        "b3": cb(c, 384, (3, 3)),
        "b3d_1": cb(c, 64, (1, 1)),
        "b3d_2": cb(64, 96, (3, 3)),
        "b3d_3": cb(96, 96, (3, 3)),
    }
    c = 384 + 96 + c  # + the max-pool passthrough

    def block_b(name, cin, mid):
        p[name] = {
            "b1": cb(cin, 192, (1, 1)),
            "b7_1": cb(cin, mid, (1, 1)),
            "b7_2": cb(mid, mid, (1, 7)),
            "b7_3": cb(mid, 192, (7, 1)),
            "b7d_1": cb(cin, mid, (1, 1)),
            "b7d_2": cb(mid, mid, (7, 1)),
            "b7d_3": cb(mid, mid, (1, 7)),
            "b7d_4": cb(mid, mid, (7, 1)),
            "b7d_5": cb(mid, 192, (1, 7)),
            "pool": cb(cin, 192, (1, 1)),
        }
        return 192 * 4

    c = block_b("mixed4", c, 128)
    c = block_b("mixed5", c, 160)
    c = block_b("mixed6", c, 160)
    c = block_b("mixed7", c, 192)
    # mixed8: grid reduction 17 -> 8
    p["mixed8"] = {
        "b3_1": cb(c, 192, (1, 1)),
        "b3_2": cb(192, 320, (3, 3)),
        "b7_1": cb(c, 192, (1, 1)),
        "b7_2": cb(192, 192, (1, 7)),
        "b7_3": cb(192, 192, (7, 1)),
        "b7_4": cb(192, 192, (3, 3)),
    }
    c = 320 + 192 + c

    def block_c(name, cin):
        p[name] = {
            "b1": cb(cin, 320, (1, 1)),
            "b3_1": cb(cin, 384, (1, 1)),
            "b3_2a": cb(384, 384, (1, 3)),
            "b3_2b": cb(384, 384, (3, 1)),
            "b3d_1": cb(cin, 448, (1, 1)),
            "b3d_2": cb(448, 384, (3, 3)),
            "b3d_3a": cb(384, 384, (1, 3)),
            "b3d_3b": cb(384, 384, (3, 1)),
            "pool": cb(cin, 192, (1, 1)),
        }
        return 320 + 768 + 768 + 192

    c = block_c("mixed9", c)
    c = block_c("mixed10", c)
    p["predictions"] = B.dense_init(gen, c, num_classes, device)
    return p


def inception_v3_forward(
    params: dict, x: torch.Tensor, *, rules: B.Rules = B.INFERENCE_RULES, logits: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    p = params
    acts: dict[str, torch.Tensor] = {}

    def cb(q, y, **kw):
        return B.conv_bn(q, y, rules, **kw)

    def cat(*ys):
        return torch.cat(ys, dim=-1)

    y = cb(p["stem1"], x, strides=(2, 2), padding="VALID")
    y = cb(p["stem2"], y, padding="VALID")
    y = cb(p["stem3"], y)
    y = B.maxpool(y, 3, 2, "VALID")
    y = cb(p["stem4"], y, padding="VALID")
    y = cb(p["stem5"], y, padding="VALID")
    y = B.maxpool(y, 3, 2, "VALID")

    for name in ("mixed0", "mixed1", "mixed2"):
        q = p[name]
        b1 = cb(q["b1"], y)
        b5 = cb(q["b5_2"], cb(q["b5_1"], y))
        b3 = cb(q["b3_3"], cb(q["b3_2"], cb(q["b3_1"], y)))
        pool = cb(q["pool"], B.avgpool(y))
        y = acts[name] = cat(b1, b5, b3, pool)

    q = p["mixed3"]
    b3 = cb(q["b3"], y, strides=(2, 2), padding="VALID")
    b3d = cb(q["b3d_3"], cb(q["b3d_2"], cb(q["b3d_1"], y)), strides=(2, 2), padding="VALID")
    y = acts["mixed3"] = cat(b3, b3d, B.maxpool(y, 3, 2, "VALID"))

    for name in ("mixed4", "mixed5", "mixed6", "mixed7"):
        q = p[name]
        b1 = cb(q["b1"], y)
        b7 = cb(q["b7_3"], cb(q["b7_2"], cb(q["b7_1"], y)))
        b7d = cb(q["b7d_1"], y)
        for k in ("b7d_2", "b7d_3", "b7d_4", "b7d_5"):
            b7d = cb(q[k], b7d)
        pool = cb(q["pool"], B.avgpool(y))
        y = acts[name] = cat(b1, b7, b7d, pool)

    q = p["mixed8"]
    b3 = cb(q["b3_2"], cb(q["b3_1"], y), strides=(2, 2), padding="VALID")
    b7 = cb(q["b7_3"], cb(q["b7_2"], cb(q["b7_1"], y)))
    b7 = cb(q["b7_4"], b7, strides=(2, 2), padding="VALID")
    y = acts["mixed8"] = cat(b3, b7, B.maxpool(y, 3, 2, "VALID"))

    for name in ("mixed9", "mixed10"):
        q = p[name]
        b1 = cb(q["b1"], y)
        b3 = cb(q["b3_1"], y)
        b3 = cat(cb(q["b3_2a"], b3), cb(q["b3_2b"], b3))
        b3d = cb(q["b3d_2"], cb(q["b3d_1"], y))
        b3d = cat(cb(q["b3d_3a"], b3d), cb(q["b3d_3b"], b3d))
        pool = cb(q["pool"], B.avgpool(y))
        y = acts[name] = cat(b1, b3, b3d, pool)

    return B.classifier(params, y, acts, "avg_pool", logits=logits)


DECONV_LAYERS = tuple(f"mixed{i}" for i in range(11))
# the default DeepDream targets (/v1/dream without 'layers')
DREAM_LAYERS = ("mixed3", "mixed4", "mixed5")
