"""DeepDream: multi-octave gradient ascent on layer activations (counterpart
of ``deconv_api_tpu/engine/deepdream.py``).

A dream runs the model's forward under ``INFERENCE_RULES`` (true gradients,
not the deconvnet rule), takes the gradient of the mean squared activation
of the chosen layers with respect to the input, and climbs it, from the
smallest rung of an octave ladder up to the image's own size, re-injecting
the detail each downsampling lost.  The input is the only tensor that
requires a gradient: the params stay plain tensors, so no weight gradient
is computed.

Where the reference jits each octave (``_octave_jit``) or the whole
ladder (``_dream_jit``), the port captures, per rung, the pyramid step and
one ascent step (one forward and one ``torch.autograd.grad``) as CUDA
graphs (``engine/capture.py``) and replays the step ``steps`` times.  The
reference's ``mesh`` (data-parallel sharding of the batch) and ``donate``
(XLA buffer donation) have no counterpart here.  The serving layer pads a
batch to a power-of-two bucket, as the reference does, to bound the
programs captured: the per-image normalisation makes each row's result
independent of its batch-mates.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.engine.capture import CapturedProgram, ProgramCache
from deconv_api_tpu_torch.models.blocks import INFERENCE_RULES


def activation_loss(forward_fn, params, x: torch.Tensor, layers: tuple[str, ...]) -> torch.Tensor:
    """Per-image mean squared activation of ``layers``, averaged over the
    layers: (B,) for a (B, H, W, C) batch, the objective the ascent
    maximises."""
    _, acts = forward_fn(params, x, rules=INFERENCE_RULES)
    losses = []
    for name in layers:
        if name not in acts:
            raise KeyError(f"model has no activation {name!r}; known: {sorted(acts)}")
        a = acts[name]
        losses.append(a.square().mean(dim=tuple(range(1, a.ndim))))
    return torch.stack(losses).mean(dim=0)


def _ascent_step(forward_fn, params, x: torch.Tensor, layers: tuple[str, ...], lr) -> torch.Tensor:
    """One ascent step of ``x`` (B, H, W, C), in place; returns the
    per-image losses of x before its update.  The differentiated scalar is
    the sum of the per-image losses and the gradient is normalised per
    image by its mean magnitude, so a batch of B dreams evolves as B solo
    dreams would.  ``lr`` is a float or a 0-dim tensor on x's device (the
    captured step's, so that a new lr needs no new capture)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        per_image = activation_loss(forward_fn, params, xg, layers)
        (g,) = torch.autograd.grad(per_image.sum(), xg)
    with torch.no_grad():
        norm = g.abs().mean(dim=tuple(range(1, g.ndim)), keepdim=True)
        x.copy_(xg.detach() + lr * (g / (norm + 1e-8)))
    return per_image.detach()


def _ascend(forward_fn, params, x: torch.Tensor, layers: tuple[str, ...], steps: int, lr: float):
    """``steps`` eager ascent steps from ``x``: the per-octave runner's
    loop.  Returns the stepped batch (a new tensor) and the losses of the
    last step's input, before its update."""
    x = x.detach().clone()
    losses = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for _ in range(steps):
        losses = _ascent_step(forward_fn, params, x, layers, lr)
    return x, losses


def octave_shapes(
    h: int, w: int, num_octaves: int, octave_scale: float = 1.4, min_size: int = 75
) -> tuple[tuple[int, int], ...]:
    """The octave ladder, smallest first and (h, w) last.  A rung whose
    smaller edge falls under ``min_size`` (the trunk's smallest input) is
    dropped; an image too small for every rung gets the one rung (h, w)."""
    shapes = []
    for i in range(num_octaves):
        s = octave_scale ** (num_octaves - 1 - i)
        oh, ow = int(round(h / s)), int(round(w / s))
        if min(oh, ow) >= min_size:
            shapes.append((oh, ow))
    return tuple(shapes) or ((h, w),)


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC batch to ``hw``, as ``jax.image.resize``:
    half-pixel centres, and an antialiasing (widened) kernel where the image
    shrinks."""
    shrinks = hw[0] < x.shape[1] or hw[1] < x.shape[2]
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", align_corners=False,
        antialias=shrinks,
    )
    return y.permute(0, 2, 3, 1)


def _pyramid_step(x, base, out_hw, prev_hw):
    """One octave jump: ``x`` resized to ``out_hw`` plus the detail ``base``
    loses between ``prev_hw`` and ``out_hw``; the first octave
    (``prev_hw`` None) is ``base`` resized."""
    with torch.no_grad():
        if prev_hw is None:
            return _resize(base, out_hw)
        lost = _resize(base, out_hw) - _resize(_resize(base, prev_hw), out_hw)
        return _resize(x, out_hw) + lost


def make_octave_runner(
    forward_fn, layers: tuple[str, ...], steps: int, lr: float,
    out_hw: tuple[int, int] | None = None, prev_hw: tuple[int, int] | None = None,
):
    """One octave's ascent with (steps, lr) bound.  Without ``out_hw``,
    ``fn(params, x)`` climbs at x's own size; with it, ``fn(params, x,
    base)`` first takes the pyramid step to ``out_hw``.  Returns (x,
    losses (B,)); x and the params must be on one device."""
    layers = tuple(layers)
    if out_hw is None:
        return lambda params, x: _ascend(forward_fn, params, x, layers, steps, lr)
    return lambda params, x, base: _ascend(
        forward_fn, params, _pyramid_step(x, base, out_hw, prev_hw), layers, steps, lr
    )


def dream_programs(
    programs: ProgramCache, forward_fn, params, layers: tuple[str, ...],
    shapes: tuple[tuple[int, int], ...], base_shape: tuple[int, ...], dtype: torch.dtype,
) -> list[tuple[CapturedProgram, CapturedProgram]]:
    """Per rung of the octave ladder ``shapes``, its pyramid step and its
    ascent step as captured programs of ``programs`` (captured at their
    first use) for a batch of ``base_shape`` (B, H, W, C) in ``dtype``: the
    counterpart of the reference's ``_octave_jit`` and ``_dream_jit``.  One
    pyramid program per (out_hw, prev_hw, batch); one step program per
    (rung, batch, layers, forward), whose static inputs are the batch,
    which it updates in place so that its replays chain with no copy, and
    lr as a 0-dim tensor; its output is the per-image losses.  ``steps``
    and ``lr`` stay arguments (``run_dream_programs``), as the reference
    traces them."""
    dev = programs.device
    b, c = base_shape[0], base_shape[-1]
    zeros = functools.partial(torch.zeros, dtype=dtype, device=dev)
    rungs = []
    for i, hw in enumerate(shapes):
        prev = shapes[i - 1] if i else None
        if prev is None:  # the first rung resizes the base alone
            make = lambda hw=hw: (lambda base: _pyramid_step(None, base, hw, None), (zeros(base_shape),))  # noqa: E731
        else:
            make = lambda hw=hw, prev=prev: (  # noqa: E731
                lambda x, base: _pyramid_step(x, base, hw, prev), (zeros((b, *prev, c)), zeros(base_shape)))
        pyramid = programs.get(("pyramid", hw, prev, tuple(base_shape), dtype), make)
        step = programs.get(
            ("step", hw, b, layers, dtype, forward_fn),
            lambda hw=hw: (
                lambda x, lr: _ascent_step(forward_fn, params, x, layers, lr), (zeros((b, *hw, c)), zeros(())),
            ),
        )
        rungs.append((pyramid, step))
    return rungs


def run_dream_rung(rungs, i: int, x, base: torch.Tensor, steps: int, lr: float):
    """Rung ``i`` of a dream through ``dream_programs``' rungs: its pyramid
    step from ``x`` (the previous rung's result, unused at rung 0) and
    ``base``, then ``steps`` replays of its ascent step.  Returns (x,
    losses): the step program's static batch and its losses output (zeros
    for 0 steps), which the next replay of the cache overwrites; call it,
    and read them, inside the cache's ``replaying()``.  A dream job runs
    its octaves one rung a dispatch through this, so its checkpointed walk
    is the whole dream's."""
    pyramid, step = rungs[i]
    step.load(pyramid(base) if i == 0 else pyramid(x, base))
    step.static[1].fill_(lr)
    losses = None
    for _ in range(steps):
        losses = step.replay()
    x = step.static[0]
    if losses is None:
        losses = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    return x, losses


def run_dream_programs(rungs, base: torch.Tensor, steps: int, lr: float):
    """A whole dream of ``base`` (on the programs' device) through
    ``dream_programs``' rungs, one ``run_dream_rung`` after another.
    Returns (x, losses) of the last rung, read as ``run_dream_rung``'s."""
    x = None
    for i in range(len(rungs)):
        x, losses = run_dream_rung(rungs, i, x, base, steps, lr)
    return x, losses


def deepdream_batch(
    forward_fn,
    params,
    images,
    *,
    layers: tuple[str, ...],
    steps_per_octave: int = 10,
    lr: float = 0.01,
    num_octaves: int = 10,
    octave_scale: float = 1.4,
    min_size: int = 75,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Multi-octave DeepDream of a (B, H, W, C) batch of independent images
    (array or tensor): (dreamed batch (B, H, W, C), losses (B,) of the last
    octave's last step), on ``device`` (``cuda`` unless ``"cpu"``; the
    params must already be there) in ``dtype`` (the reference's float32;
    float64 for a reference run, with the params in float64 too).

    It runs through captured programs (``dream_programs``) of a cache of
    this call alone; a server keeps its programs for later dreams of the
    same shape (``ModelBundle.dream_programs``).  On the CPU the same steps
    run through the same static buffers.

    ``forward_fn(params, x, *, rules) -> (out, acts)`` must accept every
    rung's size: a DAG forward as it is, a sequential spec truncated below
    its flatten and dense head (``spec_forward(spec.truncated(deepest))``).
    No hand-written kernel runs here: a max-pool's gradient is autograd's
    own, not the deconvnet switch unpool."""
    dev = resolve_device(device)
    base = torch.as_tensor(images).to(dev, dtype)
    shapes = octave_shapes(*base.shape[1:3], num_octaves, octave_scale, min_size)
    cache = ProgramCache(dev)
    rungs = dream_programs(cache, forward_fn, params, tuple(layers), shapes, tuple(base.shape), dtype)
    with cache.replaying():
        x, losses = run_dream_programs(rungs, base, steps_per_octave, lr)
        return x.clone(), losses.clone()


def deepdream(forward_fn, params, image, *, layers: tuple[str, ...], **kw):
    """``deepdream_batch`` of one (H, W, C) image: (dreamed (H, W, C),
    scalar loss)."""
    out, losses = deepdream_batch(forward_fn, params, torch.as_tensor(image)[None], layers=layers, **kw)
    return out[0], losses[0]
