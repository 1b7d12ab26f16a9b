"""Deconvnet projection by autodiff, for DAG models (counterpart of
``deconv_api_tpu/engine/autodeconv.py``).

Run a model's forward under ``DECONV_RULES``: the deconvnet ReLU and ReLU6
Functions apply their activation to the gradient on the way down, a conv's
gradient is its flipped (for a strided conv, transposed) kernel with no
bias, and a max-pool's gradient goes to each window's argmax.  The
gradient of a seeded activation with respect to the input is then the
Zeiler–Fergus projection, for any topology the forward expresses: residual
adds, concatenated branches, strided and depthwise convs.

Where the reference ``vmap``s over images and over the K projections of
each, the port runs one forward at batch B with the input requiring grad,
then one batched backward (``is_grads_batched=True``) whose K·B gradient
rows are the K seeds of every image, and returns them image-major as the
sequential engine does.  A sweep asks for each swept layer's gradient in
turn over the one retained graph; only that layer is an output, which is
what the reference's zero cotangents for the other layers amount to.
"""

from __future__ import annotations

import torch

from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.engine.capture import BatchProgram
from deconv_api_tpu_torch.engine.deconv import _seed_fmaps, _select_top, resolve_kpack_chan
from deconv_api_tpu_torch.models.blocks import DECONV_RULES
from deconv_api_tpu_torch.ops.cuda_deconv import resolve_fused_unpool


def backproject(
    act: torch.Tensor, x: torch.Tensor, top_idx: torch.Tensor, mode: str, retain_graph: bool
) -> torch.Tensor:
    """The channels ``top_idx`` (B, K) of ``act`` (B, *S, C) projected back
    to ``x``: (B, K, *x.shape[1:]), in one batched backward."""
    sel = act.detach()
    b, k = top_idx.shape
    seeds = _seed_fmaps(sel, top_idx, mode)  # (B·K, *S, C), image-major
    seeds = seeds.reshape(b, k, *sel.shape[1:]).transpose(0, 1)  # (K, B, ...)
    (grads,) = torch.autograd.grad(
        act, x, grad_outputs=seeds, is_grads_batched=True, retain_graph=retain_graph
    )
    return grads.transpose(0, 1).detach()


def project(act: torch.Tensor, x: torch.Tensor, top_k: int, mode: str, retain_graph: bool) -> dict:
    """Select the top-K channels of ``act`` (B, *S, C) per image and project
    each back to ``x``: ``{images (B, K, *x.shape[1:]), indices, sums,
    valid}``."""
    top_idx, top_sums, valid = _select_top(act.detach(), top_k)
    return {
        "images": backproject(act, x, top_idx, mode, retain_graph),
        "indices": top_idx,
        "sums": top_sums,
        "valid": valid,
    }


def autodeconv_visualizer(
    forward_fn,
    layer: str,
    top_k: int = 8,
    mode: str = "all",
    sweep_layers: tuple[str, ...] | None = None,
    device=None,
    *,
    lowc_kpack: str = "off",
    fused_unpool: str = "off",
):
    """A ``BatchProgram``, ``fn(params, images)`` for images (B, H, W, 3) ->
    ``{name: {"images": (B, K, H, W, 3), "indices": (B, K), "sums": (B, K),
    "valid": (B, K)}}``: for ``layer``, or for every layer of
    ``sweep_layers`` (deepest first) from one forward.

    ``forward_fn(params, x, *, rules) -> (out, acts)`` is a DAG model's
    forward (``models/resnet50.py`` and the like, or
    ``models/apply.py:spec_forward``).  Selection is the sequential
    engine's: positive channel sums, top-K, 'all'/'max' seeds.
    ``lowc_kpack`` and ``fused_unpool`` are validated and inert: the
    gradient walk has no per-K chain to pack and no pool -> ReLU -> conv
    triple to fuse.  ``device`` is where it runs (``cuda`` unless
    ``"cpu"``); the params must already be there.  ``fn`` moves the images
    there as a leaf that requires grad; ``fn.body(params, x)``, what a
    capture records, takes such a leaf, and its one batched
    ``autograd.grad`` (each of a sweep's over the retained graph) is
    captured with it.  The program needs autograd: call it outside
    ``torch.inference_mode``."""
    resolve_kpack_chan(lowc_kpack, top_k)
    resolve_fused_unpool(fused_unpool)
    if mode not in ("all", "max"):
        raise ValueError(f"illegal visualize mode {mode!r}; expected 'all' or 'max'")
    names = tuple(sweep_layers) if sweep_layers else (layer,)

    def body(params, x):
        with torch.enable_grad():
            _, acts = forward_fn(params, x, rules=DECONV_RULES)
            missing = [n for n in names if n not in acts]
            if missing:
                raise KeyError(f"model has no activation(s) {missing!r}; known: {sorted(acts)}")
            return {
                name: project(acts[name], x, top_k, mode, retain_graph=i < len(names) - 1)
                for i, name in enumerate(names)
            }

    return BatchProgram(body, resolve_device(device), grad_input=True)
