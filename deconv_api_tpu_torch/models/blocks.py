"""Building blocks of the DAG models (ResNet50, InceptionV3, MobileNets).

Counterpart of ``deconv_api_tpu/models/blocks.py``.  These models do not fit
the sequential ``ModelSpec``, so they are nested params dicts plus plain
forward functions ``forward(params, x, *, rules) -> (out, acts)``.  Built
with ``DECONV_RULES``, whose ReLU and ReLU6 apply the deconvnet rule in
their backward, ``torch.autograd.grad`` of the forward is the deconvnet
projection (``engine/autodeconv.py``).  Activations stay NHWC, kernels
HWIO, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from deconv_api_tpu_torch import ops
from deconv_api_tpu_torch.ops.activations import deconv_relu, deconv_relu6, relu, relu6
from deconv_api_tpu_torch.ops.conv import pad_nchw, spatial_pads


@dataclasses.dataclass(frozen=True)
class Rules:
    """The activations a forward runs with: plain ones for inference, the
    deconvnet ones for projection.  No defaults, so a variant has to pair
    both explicitly."""

    relu: Callable[[torch.Tensor], torch.Tensor]
    relu6: Callable[[torch.Tensor], torch.Tensor]


INFERENCE_RULES = Rules(relu=relu, relu6=relu6)
DECONV_RULES = Rules(relu=deconv_relu, relu6=deconv_relu6)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def maxpool(x: torch.Tensor, window=3, stride=2, padding="VALID") -> torch.Tensor:
    """Max-pool with XLA's padding (cells outside the input are -inf), for
    overlapping windows (3x3/2 in both model families).  Its gradient sends
    each cotangent to its window's first maximum in row-major order, as
    XLA's select-and-scatter with a ``ge`` select does; where windows
    overlap, a cell adds up the cotangents of every window it wins."""
    k, s = _pair(window), _pair(stride)
    xn, pad = pad_nchw(
        x.permute(0, 3, 1, 2), spatial_pads(x.shape[1:3], k, s, padding), float("-inf")
    )
    return F.max_pool2d(xn, k, s, padding=pad).permute(0, 2, 3, 1)


def avgpool(x: torch.Tensor, window: int = 3, stride: int = 1, padding="SAME") -> torch.Tensor:
    """Average pool that divides by the number of cells inside the input
    (``count_include_pad=False``), as the reference's reduce-window pair
    does.  It runs on a contiguous NCHW copy: on the card, the gradient of
    ``F.avg_pool2d`` over a ``channels_last`` input with padding came out
    wrong (torch 2.11.0+cu128, H100: off by the gradient's own magnitude
    against the CPU), the NCHW one right."""
    k, s = _pair(window), _pair(stride)
    pads = spatial_pads(x.shape[1:3], k, s, padding)
    (t, b), (l, r) = pads
    xn = x.permute(0, 3, 1, 2).contiguous()
    if t == b and l == r:
        y = F.avg_pool2d(xn, k, s, padding=(t, l), count_include_pad=False)
    else:
        total = F.avg_pool2d(pad_nchw(xn, pads)[0], k, s, divisor_override=1)
        ones = torch.ones_like(xn[:1, :1])
        y = total / F.avg_pool2d(pad_nchw(ones, pads)[0], k, s, divisor_override=1)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def _he_normal(gen: torch.Generator, shape, fan_in: int, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device) * math.sqrt(2.0 / fan_in)
    return w.to(device)


def _bn_init(c: int, device) -> dict:
    return {
        "gamma": torch.ones((c,), device=device),
        "beta": torch.zeros((c,), device=device),
        "mean": torch.zeros((c,), device=device),
        "var": torch.ones((c,), device=device),
    }


def conv_bn_init(gen: torch.Generator, cin: int, cout: int, kernel, device="cpu") -> dict:
    """Conv (no bias) + inference BatchNorm params: He-normal HWIO kernel
    drawn from ``gen``, identity BN statistics."""
    kh, kw = kernel
    return {"w": _he_normal(gen, (kh, kw, cin, cout), kh * kw * cin, device), **_bn_init(cout, device)}


def depthwise_bn_init(gen: torch.Generator, c: int, kernel=(3, 3), device="cpu") -> dict:
    """Depthwise conv (depth multiplier 1, no bias) + inference BN params;
    the kernel is HWIO with I=1, the ``groups=C`` layout."""
    kh, kw = kernel
    return {"w": _he_normal(gen, (kh, kw, 1, c), kh * kw, device), **_bn_init(c, device)}


def dense_init(gen: torch.Generator, din: int, dout: int, device="cpu") -> dict:
    return {"w": _he_normal(gen, (din, dout), din, device), "b": torch.zeros((dout,), device=device)}


def bn_affine(p: dict, y: torch.Tensor, eps: float) -> torch.Tensor:
    """Inference BatchNorm as the per-channel affine it folds to, applied
    after the conv."""
    inv = torch.rsqrt(p["var"] + eps)
    scale = (p["gamma"] * inv).to(y.dtype)
    shift = (p["beta"] - p["mean"] * p["gamma"] * inv).to(y.dtype)
    return y * scale + shift


def conv_bn(
    p: dict, x: torch.Tensor, rules: Rules, *, strides=(1, 1), padding="SAME",
    relu: bool = True, eps: float = 1e-3,
) -> torch.Tensor:
    """conv -> BN (inference) -> ReLU."""
    y = ops.conv2d(x, p["w"].to(x.dtype), None, strides=strides, padding=padding)
    y = bn_affine(p, y, eps)
    return rules.relu(y) if relu else y


def depthwise_conv_bn(
    p: dict, x: torch.Tensor, rules: Rules, *, strides=(1, 1), padding="SAME", eps: float = 1e-3,
) -> torch.Tensor:
    """depthwise conv -> BN (inference) -> ReLU6, the first half of a
    MobileNet separable block."""
    y = ops.conv2d(
        x, p["w"].to(x.dtype), None, strides=strides, padding=padding, groups=int(x.shape[-1])
    )
    return rules.relu6(bn_affine(p, y, eps))


def classifier(params: dict, y: torch.Tensor, acts: dict, pooled_name: str, *, logits: bool = False):
    """Global average pool, the dense head and softmax, recording both
    named outputs: the tail every DAG family shares.  With ``logits`` the
    softmax is skipped and ``acts["predictions"]`` holds the logits (the
    training loss's input)."""
    y = global_avg_pool(y)
    acts[pooled_name] = y
    y = ops.dense(y, params["predictions"]["w"].to(y.dtype), params["predictions"]["b"].to(y.dtype))
    if not logits:
        y = torch.softmax(y, dim=-1)
    acts["predictions"] = y
    return y, acts
