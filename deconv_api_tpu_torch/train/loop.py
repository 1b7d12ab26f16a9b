"""Synthetic-data fine-tuning: the ``train`` command's engine (the
counterpart of ``deconv_api_tpu/train/loop.py``).

It fine-tunes a model for N steps with the training step
(``train/step.py``) and saves the result as the port's checkpoint
(``utils/checkpoint.py``), which ``serve --weights <dir>`` loads back: the
train -> checkpoint -> serve loop.

The data is learnable, not pure noise: each class carries a fixed colour
bias (a palette drawn from a generator seeded ``0xC1A55``, times 1.5) on top
of unit Gaussian noise, so the held-out evaluation (loss and accuracy,
``train/step.py:make_eval_step``) measures learning: a model that trains
rises above 1/num_classes accuracy on images it never saw.  The batch of
step ``i`` comes from a generator seeded from ``(seed, i)`` alone (the
counterpart of ``jax.random.fold_in``), so a resumed run regenerates step
``i`` without replaying the earlier steps; the held-out set is
``max(batch, 128)`` images from ``seed + 0x5EED``.  Everything is drawn on
the training device by torch's generators: the values are not
``jax.random``'s, which cannot be reproduced without JAX, so the two
packages train on different (equally distributed) images from one seed.
A real data pipeline plugs in by replacing ``_synthetic_batch``.
"""

from __future__ import annotations

import functools
import inspect
import json
import math
import os
from typing import Callable

import numpy as np
import torch

from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.models.weights import tree_map
from deconv_api_tpu_torch.train.step import make_eval_step, make_train_step
from deconv_api_tpu_torch.utils.checkpoint import restore_train_state, save_params, save_train_state

_CLASS_SIGNAL = 1.5  # colour-bias magnitude against unit noise
_PALETTE_SEED = 0xC1A55
_EVAL_SEED = 0x5EED  # added to the run's seed: the held-out stream


@functools.lru_cache(maxsize=8)
def _class_palette(num_classes: int, channels: int, device: torch.device) -> torch.Tensor:
    """The per-class channel bias, the learnable structure: a constant,
    cached so that no step draws it again."""
    gen = torch.Generator(device=device).manual_seed(_PALETTE_SEED)
    return torch.randn((num_classes, channels), generator=gen, device=device)


def _step_generator(seed: int, i: int, device: torch.device) -> torch.Generator:
    """The generator of step ``i``'s batch, seeded from ``(seed, i)`` alone."""
    mixed = np.random.SeedSequence([seed & (2**64 - 1), i]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _synthetic_batch(gen: torch.Generator, batch: int, input_shape, num_classes: int):
    """``(images, labels)`` on ``gen``'s device: NHWC float32 noise plus
    each label's colour bias."""
    dev = gen.device
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)
    noise = torch.randn((batch, *input_shape), generator=gen, device=dev)
    bias = _class_palette(num_classes, int(input_shape[-1]), dev)[labels][:, None, None, :]
    return noise + _CLASS_SIGNAL * bias, labels


def _one_device_mesh(mesh_shape) -> tuple[int, int]:
    """``()``, ``(1,)`` and ``(1, 1)`` as the JAX loop's ``(dp, tp)``;
    anything else is a ValueError."""
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if mesh_shape not in ((), (1,), (1, 1)):
        raise ValueError(
            f"mesh {mesh_shape}: the port trains on one device; dp/tp over several GPUs comes with "
            "its parallel slice (parallel/mesh.py is not ported yet)"
        )
    return (1, 1)


def train_synthetic(
    spec,
    params: dict,
    *,
    forward_fn: Callable | None = None,
    model_name: str = "",
    num_classes: int | None = None,
    input_shape: tuple[int, ...] | None = None,
    steps: int = 10,
    batch: int = 8,
    lr: float = 1e-4,
    mesh_shape: tuple[int, ...] = (),
    save_dir: str = "",
    seed: int = 0,
    save_every: int = 0,
    resume: bool = False,
    progress: Callable[[int, float], None] | None = None,
    device=None,
) -> dict:
    """Fine-tune a model on synthetic data on ``device`` (the card unless
    it is given ``"cpu"``); returns a summary dict, with the final params
    (on the device) under ``"params"``, saved to ``save_dir`` if given.

    The model is either a sequential ``spec`` (name, input shape and class
    count read from it) or, with ``spec=None``, a DAG family's
    ``forward_fn(params, x, logits=True) -> (logits, acts)`` with explicit
    ``model_name``, ``num_classes`` and ``input_shape``.  Training runs on
    its own float32 copy of ``params``.

    ``mesh_shape`` may only name one device: ``()``, ``(1,)`` or ``(1, 1)``.

    ``save_every > 0`` checkpoints the whole TrainState (params, the AdamW
    moments and count, the step) to ``<save_dir>.state`` every that many
    steps, with the run's settings in ``<save_dir>.state.meta.json``;
    ``resume=True`` restores it and continues from the recorded step.  The
    batches are keyed by (seed, step), so a resumed run sees the stream an
    uninterrupted run would: on one device under deterministic kernels the
    resumption is exact.
    """
    if spec is not None:
        model = spec
        model_name = spec.name
        num_classes = spec.layers[-1].filters
        input_shape = tuple(spec.input_shape)
    else:
        if forward_fn is None or num_classes is None or input_shape is None:
            raise ValueError(
                "training needs a sequential ModelSpec classifier, or — for "
                "DAG families — forward_fn with explicit num_classes and "
                "input_shape"
            )
        if "logits" not in inspect.signature(forward_fn).parameters:
            raise ValueError(
                "forward_fn must accept logits=True so the loss sees raw "
                "logits (every registry DAG family does); got "
                f"{getattr(forward_fn, '__name__', forward_fn)!r}"
            )
        model = lambda p, x: forward_fn(p, x, logits=True)[0]  # noqa: E731
        model_name = model_name or getattr(forward_fn, "__name__", "dag_model")
        input_shape = tuple(input_shape)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    mesh_shape = _one_device_mesh(mesh_shape)

    init_fn, step_fn = make_train_step(model, dev, lr)
    state = init_fn(params)
    eval_fn = make_eval_step(model)

    # the held-out set: a seed stream apart from training's, sized apart
    # from the training batch (at small batches a batch-sized set would
    # quantize accuracy into noise)
    eval_images, eval_labels = _synthetic_batch(
        torch.Generator(device=dev).manual_seed(seed + _EVAL_SEED), max(batch, 128), input_shape, num_classes
    )

    def run_eval():
        loss, acc = eval_fn(state.params, eval_images, eval_labels)
        return float(loss), float(acc)

    if (save_every > 0 or resume) and not save_dir:
        raise ValueError(
            "--save-every/--resume need --save: the TrainState checkpoint "
            "lives at <save>.state"
        )
    # a SIBLING of save_dir, not nested in it: the final save_params
    # replaces that directory as a whole, which would delete a nested state
    state_dir = save_dir.rstrip("/") + ".state" if save_dir else ""
    meta_path = state_dir + ".meta.json" if state_dir else ""
    # the run's settings beside the state: resuming under others would
    # blend two runs (old moments under a new lr, another data stream)
    run_meta = {"model": model_name, "seed": seed, "lr": lr, "batch": batch, "mesh": list(mesh_shape)}
    start_step = 0
    if resume:
        if not (state_dir and os.path.isdir(state_dir)):
            raise FileNotFoundError(f"resume requested but no checkpoint at {state_dir!r}")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                saved_meta = json.load(f)
            diffs = {k: (saved_meta.get(k), v) for k, v in run_meta.items() if saved_meta.get(k) != v}
            if diffs:
                raise ValueError(
                    "resume config mismatch (checkpointed vs requested): "
                    f"{diffs} — resumption would silently blend two runs"
                )
        state = restore_train_state(state_dir, state)
        start_step = state.step
        if start_step >= steps:
            raise ValueError(
                f"checkpoint is already at step {start_step} >= --steps "
                f"{steps}; nothing to resume (raise --steps to continue)"
            )

    eval_loss0, eval_acc0 = run_eval()  # the reference point (resumed: mid-run)
    loss = float("nan")
    for i in range(start_step, steps):
        images, labels = _synthetic_batch(_step_generator(seed, i, dev), batch, input_shape, num_classes)
        state, loss_dev = step_fn(state, images, labels)
        loss = float(loss_dev)
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} at step {i}")
        if progress is not None:
            progress(i, loss)
        if state_dir and save_every > 0 and (i + 1) % save_every == 0:
            save_train_state(state_dir, state, model=model_name)
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(run_meta, f)
            os.replace(tmp, meta_path)
    eval_loss, eval_acc = run_eval()

    final_params = tree_map(torch.Tensor.detach, state.params)
    if save_dir:
        save_params(save_dir, final_params, model=model_name, step=state.step)
    return {
        "model": model_name,
        "steps": steps,
        "batch": batch,
        "mesh": list(mesh_shape),
        "final_loss": loss,
        "resumed_from": start_step,
        "eval_loss_initial": eval_loss0,
        "eval_loss": eval_loss,
        "eval_accuracy_initial": eval_acc0,
        "eval_accuracy": eval_acc,
        "checkpoint": save_dir,
        "params": final_params,
    }

