"""MobileNetV2 (Keras topology, alpha=1.0) as a forward function + nested
params (counterpart of ``deconv_api_tpu/models/mobilenet_v2.py``).

Inverted residual blocks with linear bottlenecks: expand 1x1 (+BN+ReLU6),
depthwise 3x3 (+BN+ReLU6), project 1x1 (+BN, no activation), and a residual
add where the stride is 1 and the channels match.  Names follow
``keras.applications.MobileNetV2``.
"""

from __future__ import annotations

import torch

from deconv_api_tpu_torch.models import blocks as B

# (block, expansion, out channels, depthwise stride); block 0
# ("expanded_conv") has no expansion
_BLOCKS = (
    (1, 6, 24, 2),
    (2, 6, 24, 1),
    (3, 6, 32, 2),
    (4, 6, 32, 1),
    (5, 6, 32, 1),
    (6, 6, 64, 2),
    (7, 6, 64, 1),
    (8, 6, 64, 1),
    (9, 6, 64, 1),
    (10, 6, 96, 1),
    (11, 6, 96, 1),
    (12, 6, 96, 1),
    (13, 6, 160, 2),
    (14, 6, 160, 1),
    (15, 6, 160, 1),
    (16, 6, 320, 1),
)

_BN_EPS = 1e-3
_STRIDE2_PAD = ((0, 1), (0, 1))


def mobilenet_v2_init(gen: torch.Generator, num_classes: int = 1000, device="cpu") -> dict:
    params: dict = {"Conv1": B.conv_bn_init(gen, 3, 32, (3, 3), device)}
    params["expanded_conv"] = {
        "depthwise": B.depthwise_bn_init(gen, 32, device=device),
        "project": B.conv_bn_init(gen, 32, 16, (1, 1), device),
    }
    cin = 16
    for i, t, cout, _stride in _BLOCKS:
        mid = cin * t
        params[f"block_{i}"] = {
            "expand": B.conv_bn_init(gen, cin, mid, (1, 1), device),
            "depthwise": B.depthwise_bn_init(gen, mid, device=device),
            "project": B.conv_bn_init(gen, mid, cout, (1, 1), device),
        }
        cin = cout
    params["Conv_1"] = B.conv_bn_init(gen, cin, 1280, (1, 1), device)
    params["predictions"] = B.dense_init(gen, 1280, num_classes, device)
    return params


def _inverted_residual(p: dict, x, rules: B.Rules, stride: int, acts: dict, name: str):
    y = x
    if "expand" in p:
        y = B.conv_bn(p["expand"], y, rules, relu=False, eps=_BN_EPS)
        y = acts[f"{name}_expand_relu"] = rules.relu6(y)
    y = B.depthwise_conv_bn(
        p["depthwise"], y, rules, strides=(stride, stride),
        padding=_STRIDE2_PAD if stride == 2 else "SAME", eps=_BN_EPS,
    )
    acts[f"{name}_depthwise_relu"] = y
    y = acts[f"{name}_project_BN"] = B.conv_bn(p["project"], y, rules, relu=False, eps=_BN_EPS)
    if stride == 1 and x.shape[-1] == y.shape[-1]:
        y = acts[f"{name}_add"] = x + y
    return y


def mobilenet_v2_forward(
    params: dict, x: torch.Tensor, *, rules: B.Rules = B.INFERENCE_RULES, logits: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    acts: dict[str, torch.Tensor] = {}
    y = B.conv_bn(params["Conv1"], x, rules, strides=(2, 2), padding=_STRIDE2_PAD, relu=False, eps=_BN_EPS)
    y = acts["Conv1_relu"] = rules.relu6(y)
    y = _inverted_residual(params["expanded_conv"], y, rules, 1, acts, "expanded_conv")
    for i, _t, _cout, stride in _BLOCKS:
        y = _inverted_residual(params[f"block_{i}"], y, rules, stride, acts, f"block_{i}")
    y = B.conv_bn(params["Conv_1"], y, rules, relu=False, eps=_BN_EPS)
    y = acts["out_relu"] = rules.relu6(y)
    return B.classifier(params, y, acts, "global_average_pooling2d", logits=logits)


DECONV_LAYERS = tuple(
    [f"block_{i}_expand_relu" for i, _t, _c, _s in _BLOCKS] + ["out_relu", "Conv1_relu"]
)
# the default DeepDream targets (/v1/dream without 'layers')
DREAM_LAYERS = ("block_6_expand_relu", "block_13_expand_relu")
