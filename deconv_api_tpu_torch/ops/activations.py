"""Named activations.  The deconvnet backward pass applies the same named
activation to the signal going down (counterpart of
``deconv_api_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
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
