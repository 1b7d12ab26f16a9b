"""A sequential ModelSpec in the DAG calling convention (counterpart of
``deconv_api_tpu/models/apply.py:spec_forward``).

``spec_forward(spec)`` is ``forward_fn(params, x, *, rules) -> (out,
acts)``, the interface of the DAG models, so the autodiff engine
(``engine/autodeconv.py``) and later DeepDream drive a sequential model the
same way.  Pools are plain max-pools here: their gradient is the switch
unpool.  ``forward`` is the classifier forward of the training step
(``train/step.py``); with ``logits=True`` both skip the last dense layer's
softmax.
"""

from __future__ import annotations

import torch

from deconv_api_tpu_torch import ops
from deconv_api_tpu_torch.models.blocks import INFERENCE_RULES, Rules, maxpool
from deconv_api_tpu_torch.models.spec import ModelSpec


def spec_forward(spec: ModelSpec, *, logits: bool = False):
    """``forward_fn`` of ``spec``; with ``logits`` the last dense layer's
    softmax is skipped (the cross-entropy's input)."""
    last = spec.layers[-1]

    def forward_fn(params, x: torch.Tensor, *, rules: Rules = INFERENCE_RULES):
        acts: dict[str, torch.Tensor] = {}
        for l in spec.layers:
            if l.kind in ("conv", "dense"):
                w = params[l.name]["w"].to(x.dtype)
                b = params[l.name]["b"].to(x.dtype)
                if l.kind == "conv":
                    x = ops.conv2d(x, w, b, strides=l.strides, padding=l.padding)
                else:
                    x = ops.dense(x, w, b)
                if logits and l is last and l.activation == "softmax":
                    pass  # left as logits
                elif l.activation == "relu":
                    x = rules.relu(x)
                else:
                    x = ops.apply_activation(x, l.activation)
            elif l.kind == "pool":
                x = maxpool(x, l.pool_size, l.pool_size, "VALID")
            elif l.kind == "flatten":
                x = ops.flatten(x)
            acts[l.name] = x
        return x, acts

    return forward_fn


def forward(spec: ModelSpec, params, x: torch.Tensor, *, logits: bool = False) -> torch.Tensor:
    """The classifier forward (``deconv_api_tpu/models/apply.py:forward``):
    ``spec_forward``'s output, so the two cannot drift."""
    out, _ = spec_forward(spec, logits=logits)(params, x)
    return out
