"""MobileNetV1 (Keras topology, alpha=1.0) as a forward function + nested
params (counterpart of ``deconv_api_tpu/models/mobilenet_v1.py``).

Depthwise-separable convs and ReLU6; names follow
``keras.applications.MobileNet`` (conv1, conv_dw_1 ... conv_pw_13).
Stride-2 convs pad ((0, 1), (0, 1)) explicitly, as Keras' ZeroPadding2D
does, not by XLA's SAME rule.
"""

from __future__ import annotations

import torch

from deconv_api_tpu_torch.models import blocks as B

# (block, pointwise out channels, depthwise stride)
_BLOCKS = (
    (1, 64, 1),
    (2, 128, 2),
    (3, 128, 1),
    (4, 256, 2),
    (5, 256, 1),
    (6, 512, 2),
    (7, 512, 1),
    (8, 512, 1),
    (9, 512, 1),
    (10, 512, 1),
    (11, 512, 1),
    (12, 1024, 2),
    (13, 1024, 1),
)

_BN_EPS = 1e-3  # Keras' default; MobileNet leaves it unset
_STRIDE2_PAD = ((0, 1), (0, 1))


def mobilenet_v1_init(gen: torch.Generator, num_classes: int = 1000, device="cpu") -> dict:
    params: dict = {"conv1": B.conv_bn_init(gen, 3, 32, (3, 3), device)}
    cin = 32
    for i, cout, _stride in _BLOCKS:
        params[f"conv_dw_{i}"] = B.depthwise_bn_init(gen, cin, device=device)
        params[f"conv_pw_{i}"] = B.conv_bn_init(gen, cin, cout, (1, 1), device)
        cin = cout
    params["predictions"] = B.dense_init(gen, 1024, num_classes, device)
    return params


def mobilenet_v1_forward(
    params: dict, x: torch.Tensor, *, rules: B.Rules = B.INFERENCE_RULES, logits: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    acts: dict[str, torch.Tensor] = {}
    y = B.conv_bn(params["conv1"], x, rules, strides=(2, 2), padding=_STRIDE2_PAD, relu=False, eps=_BN_EPS)
    y = acts["conv1_relu"] = rules.relu6(y)
    for i, _cout, stride in _BLOCKS:
        y = B.depthwise_conv_bn(
            params[f"conv_dw_{i}"], y, rules, strides=(stride, stride),
            padding=_STRIDE2_PAD if stride == 2 else "SAME", eps=_BN_EPS,
        )
        acts[f"conv_dw_{i}_relu"] = y
        y = B.conv_bn(params[f"conv_pw_{i}"], y, rules, relu=False, eps=_BN_EPS)
        y = acts[f"conv_pw_{i}_relu"] = rules.relu6(y)
    return B.classifier(params, y, acts, "global_average_pooling2d", logits=logits)


DECONV_LAYERS = tuple([f"conv_pw_{i}_relu" for i, _c, _s in _BLOCKS] + ["conv1_relu"])
# the default DeepDream targets (/v1/dream without 'layers')
DREAM_LAYERS = ("conv_pw_7_relu", "conv_pw_11_relu")
