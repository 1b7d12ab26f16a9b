"""Named activations, and the deconvnet "backward ReLU" as autograd
Functions (counterpart of ``deconv_api_tpu/ops/activations.py``).

The sequential engine applies the same named activation to the signal going
down.  The DAG engine (``engine/autodeconv.py``) instead runs
``torch.autograd.grad`` over a model's forward built with ``deconv_relu`` /
``deconv_relu6``: their backward applies ReLU (ReLU6) to the incoming
gradient itself instead of masking it by the forward input's sign, so the
gradient of the whole forward is the Zeiler–Fergus projection.
"""

from __future__ import annotations

import torch


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6): MobileNet's activation (Keras ``ReLU(6.)``)."""
    return torch.clamp(x, 0.0, 6.0)


_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": relu6,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    try:
        fn = _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; expected one of {sorted(_ACTIVATIONS)}"
        ) from None
    return fn(x)


class _DeconvReLU(torch.autograd.Function):
    """ReLU forward; backward ``relu(g)``.  ``generate_vmap_rule`` lets a
    batched backward (``is_grads_batched=True``) run through it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.relu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass  # the backward reads nothing of the forward

    @staticmethod
    def backward(ctx, g):
        return torch.relu(g)


class _DeconvReLU6(torch.autograd.Function):
    """ReLU6 forward; backward ``relu6(g)``: the deconvnet rule with the
    cap, as the reference applies the layer's own activation going down."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return relu6(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return relu6(g)


def deconv_relu(x: torch.Tensor) -> torch.Tensor:
    return _DeconvReLU.apply(x)


def deconv_relu6(x: torch.Tensor) -> torch.Tensor:
    return _DeconvReLU6.apply(x)
