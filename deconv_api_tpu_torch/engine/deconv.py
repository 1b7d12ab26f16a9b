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

The kpack packed tail (``kpack_chan > 0``): below the boundary
``_pack_boundary`` finds, the K projections of an image ride its channels
instead (B rows of K·C channels, switch ``rep`` 1) through grouped convs,
grouped unpools and the grouped fused kernel, and unpack at the input.  The
layer sweep (``sweep=True``) shares one forward and projects every
projectable layer from the requested one down, each on its own, as the
reference's default separate-per-layer path does.

The int8 execution tier (``quant``, ``quality=int8``): every conv and
dense entry of the forward walk runs int8 x int8 -> int32 with per-row
input scales (``_up_step_q8``); selection and the backward keep their
dtypes.  Out of this slice: the merged sweep (``_sweep_merged``, measured
negative and off by default in the reference), the NCHW tail and the bf16
forward prefix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deconv_api_tpu_torch import ops
from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.engine.capture import BatchProgram
from deconv_api_tpu_torch.models.spec import Entry, ModelSpec, entry_chain
from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT, resolve_fused_unpool

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


def _up_step_q8(e: Entry, params, x, amax):
    """One int8 forward step of a conv or dense entry (the JAX package's
    ``_up_step_q8``).  ``amax`` is each row's input range: a calibrated
    constant (a Python float) or the rows' own max-abs as a (B,) tensor
    (dynamic).  The input quantizes to symmetric int8 at ``sx = amax / 127``
    per row, the kernel at ``sw = max|w| / 127``; the contraction, the bias
    fold, relu and the dequantize are ``ops.conv2d_q8_step`` /
    ``ops.dense_q8_step`` (``ops/q8.py``: K5 on the card)."""
    l = e.layer
    x = x.float()
    if not isinstance(amax, torch.Tensor):  # a calibrated constant, for every row
        amax = torch.full((x.shape[0],), amax, dtype=torch.float32, device=x.device)
    sx = ops.q8_scale(amax)
    wq, sw = ops.quantize_weight_q8(params[l.name]["w"].float())
    b = params[l.name]["b"].float()
    if l.kind == "conv":
        return ops.conv2d_q8_step(x, sx, wq, sw, b, l.activation, strides=l.strides, padding=l.padding)
    return ops.dense_q8_step(x, sx, wq, sw, b, l.activation)


def _forward_chain(entries, params, images, switches, quant=None):
    """The forward walk: every entry's output, in order.  ``quant`` runs
    each conv and dense entry through ``_up_step_q8``: ``"dynamic"`` takes
    each row's own input max-abs as its range, a tuple of (entry name,
    amax) pairs the calibrated constants (an entry missing from it falls
    back to dynamic), None the float walk."""
    calibrated = dict(quant) if isinstance(quant, tuple) else {}
    x, ups = images, []
    for e in entries:
        if quant is not None and not e.is_companion_act and e.layer.kind in ("conv", "dense"):
            amax = calibrated.get(e.name)
            if amax is None:
                amax = ops.row_amax(x.float())
            x = _up_step_q8(e, params, x, amax)
        else:
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


def _down_step(e: Entry, params, x, switches, prev_shape, bug_compat: bool, groups: int = 1):
    """One backward step; with ``groups > 1`` the signal carries that many
    projections packed into its channels (only certified kinds appear
    there: relu/linear activations, fusable convs, pools, the input)."""
    l = e.layer
    if e.is_companion_act:
        # deconvnet backward ReLU: the same activation on the way down
        return ops.apply_activation(x, l.activation)
    if l.kind == "input":
        return x
    if l.kind == "conv":
        w = params[l.name]["w"].to(x.dtype)
        if groups > 1:
            y = ops.conv2d_input_backward_grouped(x, w, groups)
        else:
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
        return ops.unpool_with_argmax(x, idx, l.pool_size, out_hw, groups=groups)
    if l.kind == "flatten":
        return ops.unflatten(x, prev_shape[1:])
    if l.kind == "dense":
        # W^T, zero bias, no fused activation
        return ops.dense_input_backward(x, params[l.name]["w"].to(x.dtype))
    raise AssertionError(l.kind)


def _down_chain(
    entries, params, ups, switches, x, start, stop_after, bug_compat, fused_unpool,
    groups: int = 1,
):
    """Walk the backward chain from entry ``start`` down to ``stop_after``
    (exclusive; -1 walks to pixels), with two peepholes: pool -> backward
    ReLU (or linear) -> certified conv as one fused unpool+conv op, and
    pool -> backward ReLU as one unpool with the ReLU folded in.  Both
    pass ``groups`` through (the packed tail)."""
    j = start
    while j > stop_after:
        e = entries[j]
        is_pool = not e.is_companion_act and e.layer.kind == "pool"
        if (
            fused_unpool != "off"
            and is_pool
            and j - 2 > stop_after
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
                groups=groups, mode=fused_unpool,
            )
            if bug_compat:
                # the bug-compat re-activation stays outside the fused op
                x = ops.apply_activation(x, conv_l.activation)
            j -= 3
            continue
        if (
            is_pool
            and j - 1 > stop_after
            and entries[j - 1].is_companion_act
            and entries[j - 1].layer.activation == "relu"
        ):
            sw_idx, out_hw = switches[e.name]
            x = ops.unpool_with_argmax(
                x, sw_idx, e.layer.pool_size, out_hw, fuse_relu=True, groups=groups
            )
            j -= 2
            continue
        prev_shape = ups[j - 1].shape if j > 0 else ups[0].shape
        x = _down_step(e, params, x, switches, prev_shape, bug_compat, groups)
        j -= 1
    return x


def _pack_boundary(entries, ups, i: int, max_chan: int) -> int:
    """Largest entry index ``jb < i`` such that every entry in ``[0, jb]``
    is safe to run with the K projections packed into the channels and
    the signal entering ``jb`` has at most ``max_chan`` channels; -1 when
    no packed tail applies.  Safe: relu/linear activations (softmax would
    mix the packed projections), pools, the input, and fusable convs."""
    safe = []
    for e in entries:
        l = e.layer
        act_ok = l.activation in ("relu", "linear")
        if e.is_companion_act:
            safe.append(act_ok)
        elif l.kind in ("input", "pool"):
            safe.append(True)
        elif l.kind == "conv":
            safe.append(act_ok and _fusable_conv(l))
        else:  # dense / flatten
            safe.append(False)
    for j in range(i - 1, -1, -1):
        if all(safe[: j + 1]) and ups[j].shape[-1] <= max_chan:
            return j
    return -1


# lowc_kpack policy thresholds: ``auto`` packs the C <= 64 tail (VGG
# block1), ``forced`` the whole certified C <= 128 tail (block2 too)
KPACK_AUTO_CHAN = 64
KPACK_FORCED_CHAN = 128


def resolve_kpack_chan(policy, top_k: int = 8) -> int:
    """The ``lowc_kpack`` policy (off|auto|forced|<chan>) as a kpack
    channel threshold.  ``off`` (also '', '0', 'false', 'no') is 0;
    ``auto`` is 64, or 0 when ``top_k == 1`` (nothing to pack);
    ``forced`` is 128; an integer or digit string is itself."""
    if isinstance(policy, bool):  # bool is an int subclass
        raise ValueError(f"illegal lowc_kpack policy {policy!r}")
    if isinstance(policy, int):
        return policy
    p = str(policy).strip().lower()
    if p in ("", "0", "off", "false", "no"):
        return 0
    if p == "auto":
        return KPACK_AUTO_CHAN if top_k > 1 else 0
    if p == "forced":
        return KPACK_FORCED_CHAN
    if p.isdigit():
        return int(p)
    raise ValueError(
        f"illegal lowc_kpack policy {policy!r}; expected "
        "'off', 'auto', 'forced' or a channel threshold"
    )


def pack_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B·K, H, W, C) image-major -> (B, H, W, K·C): projection k of image
    b moves to channels ``[k*C, (k+1)*C)`` of row b."""
    bk, h, w, c = x.shape
    return x.reshape(bk // k, k, h, w, c).permute(0, 2, 3, 1, 4).reshape(bk // k, h, w, k * c)


def unpack_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, K·C) -> (B·K, H, W, C): ``pack_k``'s exact inverse."""
    b, h, w, kc = x.shape
    return x.reshape(b, h, w, k, kc // k).permute(0, 3, 1, 2, 4).reshape(b * k, h, w, kc // k)


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


def _visualize_entry(
    entries, params, ups, switches, i, top_k, mode, bug_compat, bwd_dtype,
    kpack_chan, fused_unpool,
):
    """Top-K selection at entry ``i`` and the B·K projections to pixels;
    with a pack boundary ``jb`` the walk below it runs packed."""
    output = ups[i]
    top_idx, top_sums, valid = _select_top(output, top_k)
    x = _seed_fmaps(output, top_idx, mode)
    if bwd_dtype is not None:
        x = x.to(bwd_dtype)
    b, k = top_idx.shape
    jb = _pack_boundary(entries, ups, i, kpack_chan) if kpack_chan > 0 else -1
    walk = (entries, params, ups, switches)
    if jb >= 0:
        x = _down_chain(*walk, x, i, jb, bug_compat, fused_unpool)
        x = _down_chain(*walk, pack_k(x, k), jb, -1, bug_compat, fused_unpool, groups=k)
        x = unpack_k(x, k)
    else:
        x = _down_chain(*walk, x, i, -1, bug_compat, fused_unpool)
    return {
        "images": x.to(output.dtype).reshape(b, k, *x.shape[1:]),
        "indices": top_idx,
        "sums": top_sums,
        "valid": valid,
    }


def get_visualizer(
    spec: ModelSpec,
    layer_name: str,
    top_k: int = 8,
    mode: str = "all",
    bug_compat: bool = True,
    backward_dtype: str | None = None,
    fused_unpool: str = FUSED_DEFAULT,
    device=None,
    *,
    sweep: bool = False,
    kpack_chan: int = 0,
    quant=None,
):
    """A ``BatchProgram``, ``fn(params, images)`` for images (B, H, W, C) ->
    ``{layer: {"images": (B, K, H, W, C), "indices": (B, K),
    "sums": (B, K), "valid": (B, K)}}``, for ``layer_name`` alone or, with
    ``sweep=True``, for every projectable layer from it down, deepest
    first (the input dropped).

    ``backward_dtype`` (e.g. ``"bfloat16"``) runs only the projection chain
    in that dtype; selection and switches stay exact.  ``fused_unpool``
    (off|auto|forced) fuses each certified pool -> ReLU -> conv step of the
    backward walk into one op (``ops/cuda_deconv.py``).  ``kpack_chan``
    (``resolve_kpack_chan`` of the ``lowc_kpack`` policy; 0 is off) packs
    the K projections into the channels below the boundary where the
    signal has at most that many.  ``quant`` runs the forward walk in int8
    (``_forward_chain``): None (off), ``"dynamic"`` or a tuple of (entry,
    amax) calibrated ranges (``engine/quant.py``); selection stays fp32 and
    the backward keeps ``backward_dtype``.  ``device`` is where it runs: ``cuda``
    unless ``"cpu"`` is passed (raises without a card); the params must
    already be there.  ``fn`` moves the images there; ``fn.body(params,
    x)``, what a capture records, takes a batch already there."""
    if mode not in ("all", "max"):
        raise ValueError(f"illegal visualize mode {mode!r}; expected 'all' or 'max'")
    if backward_dtype and backward_dtype not in _DTYPES:
        raise ValueError(
            f"illegal backward_dtype {backward_dtype!r}; expected one of {sorted(_DTYPES)}"
        )
    if quant is not None and quant != "dynamic" and not isinstance(quant, tuple):
        raise ValueError(
            f"illegal quant spec {quant!r}; expected None, 'dynamic' or a tuple of (entry, amax) pairs"
        )
    fused_unpool = resolve_fused_unpool(fused_unpool)
    entries = entry_chain(spec.truncated(layer_name))
    model_names = {l.name for l in spec.layers}
    # model-layer entries, deepest first, the input dropped
    vis = [j for j, e in enumerate(entries) if e.name in model_names][::-1][:-1]
    if not vis:
        raise ValueError(
            f"layer {layer_name!r} has no projectable output (it is the input layer)"
        )
    if not sweep:
        vis = vis[:1]
    bwd_dtype = _DTYPES[backward_dtype] if backward_dtype else None

    @torch.no_grad()
    def body(params, images):
        switches: dict = {}
        ups = _forward_chain(entries, params, images, switches, quant)
        return {
            entries[i].name: _visualize_entry(
                entries, params, ups, switches, i, top_k, mode, bug_compat,
                bwd_dtype, kpack_chan, fused_unpool,
            )
            for i in vis
        }

    return BatchProgram(body, resolve_device(device))
