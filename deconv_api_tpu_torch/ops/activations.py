"""Named activations, and the deconvnet "backward ReLU" as autograd
Functions (counterpart of ``deconv_api_tpu/ops/activations.py``).

The sequential engine applies the same named activation to the signal going
down.  The DAG engine (``engine/autodeconv.py``) instead runs
``torch.autograd.grad`` over a model's forward built with ``deconv_relu`` /
``deconv_relu6``: their backward applies ReLU (ReLU6) to the incoming
gradient itself instead of masking it by the forward input's sign, so the
gradient of the whole forward is the Zeiler–Fergus projection.  ``relu``
and ``relu6`` are the true-gradient forms DeepDream differentiates.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim constant, made once per dtype and device (no fill launch a
    call).  Never first made inside a CUDA graph capture: the tensor would
    live in the graph's memory pool and hold no value until a replay, and
    eager code reusing it would read garbage.  The warm-up runs before every
    capture (``engine/capture.py``) make each one the body uses."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"_const({value}, {dtype}) first used inside a CUDA graph capture; "
            "run the body eagerly before capturing it"
        )
    return torch.full((), value, dtype=dtype, device=device)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the reference's true gradient: ``torch.maximum``
    splits a tie, so the gradient at 0 is 0.5 as ``jnp.maximum``'s is
    (``torch.relu``'s is 0)."""
    return torch.maximum(x, _const(0.0, x.dtype, x.device))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6): MobileNet's activation (Keras ``ReLU(6.)``), with
    the reference's gradient of 0.5 at both ties (``torch.clamp``'s is 1)."""
    return torch.minimum(relu(x), _const(6.0, x.dtype, x.device))


# Activations the int8 execution tier may apply on the int32 accumulator
# before the dequant multiply: with the bias folded in at the combined
# input*kernel scale, relu commutes with the (positive) scale and linear is
# the identity.  relu6's cap and softmax do not commute with a scale; their
# layers dequantize first.
INT8_SAFE_ACTIVATIONS = ("linear", "relu")


def int8_safe_activation(name: str) -> bool:
    """Whether the named activation may run on the int32 accumulator."""
    return name in INT8_SAFE_ACTIVATIONS


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
    cap, as the reference applies the layer's own activation going down.
    One ``torch.clamp`` each way: this backward reads no tie, so it needs
    none of ``relu6``'s tie-splitting (two launches)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.clamp(x, 0.0, 6.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, 0.0, 6.0)


def deconv_relu(x: torch.Tensor) -> torch.Tensor:
    return _DeconvReLU.apply(x)


def deconv_relu6(x: torch.Tensor) -> torch.Tensor:
    return _DeconvReLU6.apply(x)
