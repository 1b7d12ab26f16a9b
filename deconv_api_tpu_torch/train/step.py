"""The training step on ``torch.autograd`` (the counterpart of
``deconv_api_tpu/train/step.py``).

Classification fine-tuning of any registry model: softmax cross-entropy
over integer labels, averaged over the batch, and optax's ``adamw(lr)``
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0, weight decay 1e-4 on every leaf)
written out in optax's order of operations (``adamw``).  ``torch.optim.
AdamW`` is not used: its default weight decay is 0.01, and it rounds the
decay and the step in another order.

The model argument is either a sequential ``ModelSpec`` (its classifier
forward, ``models/apply.py:forward`` with ``logits=True``) or any callable
``apply_fn(params, images) -> logits``: the DAG families pass an adapter
over their ``forward_fn(..., logits=True)``.  DAG BatchNorm enters the
graph in inference form (the running statistics folded into a per-channel
affine, ``models/blocks.py:bn_affine``); under fine-tuning every BN leaf
(scale, offset and the folded statistics) updates as an ordinary weight,
so that the trained checkpoint serves through the same statistics-free
forward.  Every leaf of the params tree therefore takes a gradient.

With ``remat`` the whole loss runs under ``torch.utils.checkpoint``, as the
JAX step runs ``jax.checkpoint(loss_fn)``: the forward's activations are
dropped and recomputed once for the backward.  The step takes no mesh:
data and tensor parallelism over several cards come with the port's
parallel slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.models.apply import forward
from deconv_api_tpu_torch.models.spec import ModelSpec
from deconv_api_tpu_torch.models.weights import flat_leaves, tree_map

# optax.adamw's defaults (optax 0.2), the JAX step's optimizer; its eps_root
# is 0, so the square root takes the corrected second moment as it is
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and both moments, in
    the params' tree."""

    count: int
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    params: dict
    opt_state: AdamWState
    step: int


def leaves(tree: dict) -> list[torch.Tensor]:
    """The tree's leaves in its key order."""
    return list(flat_leaves(tree).values())


def _as_apply_fn(model) -> Callable:
    """ModelSpec -> its classifier forward; callables pass through."""
    if isinstance(model, ModelSpec):
        return lambda p, x: forward(model, p, x, logits=True)
    if callable(model):
        return model
    raise TypeError(
        f"model must be a ModelSpec or apply_fn(params, images) -> logits, "
        f"got {type(model).__name__}"
    )


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, in float32 as XLA computes it."""
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count), dtype=np.float32))


@torch.no_grad()
def adamw(params: dict, grads: list[torch.Tensor], opt: AdamWState, lr: float) -> AdamWState:
    """One optax ``adamw(lr)`` update of ``params`` in place (optax's
    ``scale_by_adam``, ``add_decayed_weights``, ``scale_by_learning_rate``
    and ``apply_updates``, in that order); returns the new moments and
    count."""
    count = opt.count + 1
    bc1, bc2 = _bias_correction(B1, count), _bias_correction(B2, count)
    for p, g, m, v in zip(leaves(params), grads, leaves(opt.mu), leaves(opt.nu)):
        m.copy_((1 - B1) * g + B1 * m)
        v.copy_((1 - B2) * (g * g) + B2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        u = u + WEIGHT_DECAY * p
        p.add_(u * -lr)
    return opt._replace(count=count)


def make_train_step(model, device=None, lr: float = 1e-4, *, remat: bool = True):
    """``(init_fn, step_fn)`` on ``device`` (the card unless it is given
    ``"cpu"``).

    ``init_fn(params) -> TrainState`` copies the params to the device as
    float32 leaves that take gradients, with zero moments, count and step.
    ``step_fn(state, images, labels) -> (state, loss)`` runs one step on
    NHWC float32 ``images`` and integer ``labels`` on that device.  It
    updates the state's tensors in place and returns the state with its
    step advanced (the JAX step donates its state); ``loss`` is a device
    scalar."""
    dev = resolve_device(device)
    apply_fn = _as_apply_fn(model)

    def loss_fn(params, images, labels):
        return F.cross_entropy(apply_fn(params, images), labels)

    def init_fn(params: dict) -> TrainState:
        own = tree_map(lambda t: t.detach().to(dev, torch.float32, copy=True).requires_grad_(True), params)
        zeros = lambda: tree_map(lambda t: torch.zeros_like(t, requires_grad=False), own)  # noqa: E731
        return TrainState(own, AdamWState(0, zeros(), zeros()), 0)

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        ws = leaves(state.params)
        for w in ws:
            w.requires_grad_(True)
        if remat:
            loss = torch.utils.checkpoint.checkpoint(loss_fn, state.params, images, labels, use_reentrant=False)
        else:
            loss = loss_fn(state.params, images, labels)
        grads = torch.autograd.grad(loss, ws)
        opt = adamw(state.params, grads, state.opt_state, lr)
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    return init_fn, step_fn


def make_eval_step(model):
    """``eval_fn(params, images, labels) -> (mean loss, accuracy)``, device
    scalars on the inputs' device; ``model`` as in ``make_train_step``."""
    apply_fn = _as_apply_fn(model)

    @torch.no_grad()
    def eval_fn(params, images, labels):
        logits = apply_fn(params, images)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
        return loss, acc

    return eval_fn
