"""The deconvnet visualizer, single layer, batched (counterpart of
``deconv_api_tpu/engine/deconv.py``).

Forward through the layer stack recording an int8 switch at every pool,
rank the requested layer's channels by positive sum, keep the top K, and
project each back to pixels through backward ReLU, switch unpool and the
flipped-kernel conv.

Where the reference ``vmap``s over images and then over the K projections,
the port runs one explicit batch: B images forward, then B·K projection
rows, image-major (row ``b*K + k``).  The switches keep batch B and each is
shared by the K rows of its image (``rep = K`` in the pool ops).

Out of this slice: the kpack packed tail, the NCHW tail, the layer sweeps,
int8 quant and the bf16 forward prefix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deconv_api_tpu_torch import ops
from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.models.spec import Entry, ModelSpec, entry_chain
from deconv_api_tpu_torch.ops.cuda_deconv import resolve_fused_unpool

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _up_step(e: Entry, params, x, switches):
    l = e.layer
    if e.is_companion_act:
        return ops.apply_activation(x, l.activation)
    if l.kind == "input":
        return x
    if l.kind == "conv":
        w = params[l.name]["w"].to(x.dtype)
        b = params[l.name]["b"].to(x.dtype)
        y = ops.conv2d(x, w, b, strides=l.strides, padding=l.padding)
        # Keras conv layers carry a fused activation; the companion entry
        # applies it again (idempotent for relu), as the reference does
        return ops.apply_activation(y, l.activation)
    if l.kind == "pool":
        pooled, idx = ops.maxpool_with_argmax(x, l.pool_size)
        switches[e.name] = (idx, tuple(x.shape[1:3]))
        return pooled
    if l.kind == "flatten":
        return ops.flatten(x)
    if l.kind == "dense":
        w = params[l.name]["w"].to(x.dtype)
        b = params[l.name]["b"].to(x.dtype)
        return ops.apply_activation(ops.dense(x, w, b), l.activation)
    raise AssertionError(l.kind)


def _forward_chain(entries, params, images, switches):
    x, ups = images, []
    for e in entries:
        x = _up_step(e, params, x, switches)
        ups.append(x)
    return ups


def _fusable_conv(l) -> bool:
    """The odd-SAME-stride-1 rule: the only conv whose backward projection
    is the plain flipped conv the fused kernel computes."""
    kh, kw = l.kernel_size
    return (
        l.kind == "conv"
        and tuple(l.strides) == (1, 1)
        and l.padding == "SAME"
        and kh % 2 == 1
        and kw % 2 == 1
    )


def _down_step(e: Entry, params, x, switches, prev_shape, bug_compat: bool):
    l = e.layer
    if e.is_companion_act:
        # deconvnet backward ReLU: the same activation on the way down
        return ops.apply_activation(x, l.activation)
    if l.kind == "input":
        return x
    if l.kind == "conv":
        w = params[l.name]["w"].to(x.dtype)
        y = ops.conv2d_input_backward(
            x, w, strides=l.strides, padding=l.padding, input_hw=prev_shape[1:3]
        )
        if bug_compat:
            # the reference's config clone keeps the fused activation in
            # the backward conv model too
            y = ops.apply_activation(y, l.activation)
        return y
    if l.kind == "pool":
        idx, out_hw = switches[e.name]
        return ops.unpool_with_argmax(x, idx, l.pool_size, out_hw)
    if l.kind == "flatten":
        return ops.unflatten(x, prev_shape[1:])
    if l.kind == "dense":
        # W^T, zero bias, no fused activation
        return ops.dense_input_backward(x, params[l.name]["w"].to(x.dtype))
    raise AssertionError(l.kind)


def _down_chain(entries, params, ups, switches, x, start, bug_compat, fused_unpool):
    """Walk the backward chain from entry ``start`` down to the input, with
    two peepholes: pool -> backward ReLU (or linear) -> certified conv as
    one fused unpool+conv op, and pool -> backward ReLU as one unpool with
    the ReLU folded in."""
    j = start
    while j >= 0:
        e = entries[j]
        is_pool = not e.is_companion_act and e.layer.kind == "pool"
        if (
            fused_unpool != "off"
            and is_pool
            and j - 2 >= 0
            and entries[j - 1].is_companion_act
            and entries[j - 1].layer.activation in ("relu", "linear")
            and not entries[j - 2].is_companion_act
            and _fusable_conv(entries[j - 2].layer)
        ):
            sw_idx, out_hw = switches[e.name]
            conv_l = entries[j - 2].layer
            x = ops.fused_unpool_backward(
                x, sw_idx, params[conv_l.name]["w"].to(x.dtype),
                e.layer.pool_size, out_hw,
                fuse_relu=entries[j - 1].layer.activation == "relu",
                mode=fused_unpool,
            )
            if bug_compat:
                # the bug-compat re-activation stays outside the fused op
                x = ops.apply_activation(x, conv_l.activation)
            j -= 3
            continue
        if (
            is_pool
            and j - 1 >= 0
            and entries[j - 1].is_companion_act
            and entries[j - 1].layer.activation == "relu"
        ):
            sw_idx, out_hw = switches[e.name]
            x = ops.unpool_with_argmax(
                x, sw_idx, e.layer.pool_size, out_hw, fuse_relu=True
            )
            j -= 2
            continue
        prev_shape = ups[j - 1].shape if j > 0 else ups[0].shape
        x = _down_step(e, params, x, switches, prev_shape, bug_compat)
        j -= 1
    return x


def _select_top(output: torch.Tensor, top_k: int):
    """Per image, positive channel sums ranked descending; non-positive
    ranks stay in place and surface as ``valid=False``.  Dead channels tie
    at -inf; a stable descending sort keeps the lower index first, as
    ``lax.top_k`` does.  Sums accumulate in fp32."""
    k = min(top_k, output.shape[-1])
    sums = output.float()
    if output.dim() > 2:
        sums = sums.sum(dim=tuple(range(1, output.dim() - 1)))
    masked = torch.where(sums > 0, sums, torch.full_like(sums, float("-inf")))
    top_sums, top_idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_sums, top_idx = top_sums[:, :k], top_idx[:, :k]
    return top_idx, top_sums.to(output.dtype), top_sums > 0


def _seed_fmaps(output: torch.Tensor, top_idx: torch.Tensor, mode: str):
    """(B, *S, C) output, (B, K) channels -> (B·K, *S, C) seeds: each the
    selected channel's map, mode-masked, re-embedded at its channel."""
    b, k = top_idx.shape
    n_chan = output.shape[-1]
    spatial = output.shape[1:-1]
    chan = F.one_hot(top_idx, n_chan).to(output.dtype)  # (B, K, C)
    chan = chan.reshape(b, k, *([1] * len(spatial)), n_chan)
    rows = torch.arange(b, device=output.device)[:, None]
    fmap = torch.movedim(output, -1, 1)[rows, top_idx]  # (B, K, *S)
    if mode == "max":
        # keep only positions equal to the map's global max (ties all kept)
        peak = fmap.reshape(b, k, -1).amax(-1).reshape(b, k, *([1] * len(spatial)))
        fmap = fmap * (fmap == peak).to(fmap.dtype)
    return (fmap[..., None] * chan).reshape(b * k, *spatial, n_chan)


def get_visualizer(
    spec: ModelSpec,
    layer_name: str,
    top_k: int = 8,
    mode: str = "all",
    bug_compat: bool = True,
    backward_dtype: str | None = None,
    fused_unpool: str = "auto",
    device=None,
):
    """``fn(params, images)`` for images (B, H, W, C) ->
    ``{layer_name: {"images": (B, K, H, W, C), "indices": (B, K),
    "sums": (B, K), "valid": (B, K)}}``.

    ``backward_dtype`` (e.g. ``"bfloat16"``) runs only the projection chain
    in that dtype; selection and switches stay exact.  ``fused_unpool``
    (off|auto|forced) fuses each certified pool -> ReLU -> conv step of the
    backward walk into one op (``ops/cuda_deconv.py``).  ``device`` is
    where it runs: ``cuda`` unless ``"cpu"`` is passed (raises without a
    card); the params must already be there, the images are moved."""
    if mode not in ("all", "max"):
        raise ValueError(f"illegal visualize mode {mode!r}; expected 'all' or 'max'")
    if backward_dtype and backward_dtype not in _DTYPES:
        raise ValueError(
            f"illegal backward_dtype {backward_dtype!r}; expected one of {sorted(_DTYPES)}"
        )
    fused_unpool = resolve_fused_unpool(fused_unpool)
    entries = entry_chain(spec.truncated(layer_name))
    i = next(j for j, e in enumerate(entries) if e.name == layer_name)
    if entries[i].layer.kind == "input":
        raise ValueError(
            f"layer {layer_name!r} has no projectable output (it is the input layer)"
        )
    bwd_dtype = _DTYPES[backward_dtype] if backward_dtype else None
    dev = resolve_device(device)

    @torch.no_grad()
    def fn(params, images):
        images = torch.as_tensor(images).to(dev)
        switches: dict = {}
        ups = _forward_chain(entries, params, images, switches)
        output = ups[i]
        top_idx, top_sums, valid = _select_top(output, top_k)
        x = _seed_fmaps(output, top_idx, mode)
        if bwd_dtype is not None:
            x = x.to(bwd_dtype)
        x = _down_chain(entries, params, ups, switches, x, i, bug_compat, fused_unpool)
        b, k = top_idx.shape
        images_out = x.to(output.dtype).reshape(b, k, *x.shape[1:])
        return {
            layer_name: {
                "images": images_out,
                "indices": top_idx,
                "sums": top_sums,
                "valid": valid,
            }
        }

    return fn
