"""Layer-spec IR for sequential CNN classifiers (a copy of the framework-free
part of ``deconv_api_tpu/models/spec.py``; the init is torch's own).

A ``ModelSpec`` is a static, hashable description of a model; the engine
walks it per call, and ``entry_chain`` expands it into the up/down steps of
the deconv chain."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Layer:
    """One model layer. ``kind`` is input|conv|pool|flatten|dense."""

    name: str
    kind: str
    activation: str = "linear"
    filters: int = 0  # conv out-channels / dense units
    kernel_size: tuple[int, int] = (3, 3)
    strides: tuple[int, int] = (1, 1)
    padding: str = "SAME"
    pool_size: tuple[int, int] = (2, 2)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    input_shape: tuple[int, int, int]  # (H, W, C)
    layers: tuple[Layer, ...]

    def __post_init__(self):
        kinds = {"input", "conv", "pool", "flatten", "dense"}
        names = set()
        for l in self.layers:
            if l.kind not in kinds:
                raise ValueError(f"layer {l.name!r}: unknown kind {l.kind!r}")
            if l.name in names:
                raise ValueError(f"duplicate layer name {l.name!r}")
            names.add(l.name)
        if not self.layers or self.layers[0].kind != "input":
            raise ValueError("spec must start with an input layer")

    def layer_names(self) -> list[str]:
        return [l.name for l in self.layers]

    def index(self, layer_name: str) -> int:
        for i, l in enumerate(self.layers):
            if l.name == layer_name:
                return i
        raise KeyError(
            f"model {self.name!r} has no layer {layer_name!r}; "
            f"known layers: {self.layer_names()}"
        )

    def truncated(self, layer_name: str) -> "ModelSpec":
        """Spec cut after ``layer_name``."""
        i = self.index(layer_name)
        return dataclasses.replace(self, layers=self.layers[: i + 1])


@dataclasses.dataclass(frozen=True)
class Entry:
    """One up/down step of the deconv chain.  Conv and dense layers expand
    to two entries, the op and a companion activation."""

    name: str
    layer: Layer
    is_companion_act: bool = False


def entry_chain(spec: ModelSpec) -> tuple[Entry, ...]:
    entries: list[Entry] = []
    for l in spec.layers:
        entries.append(Entry(l.name, l))
        if l.kind in ("conv", "dense"):
            entries.append(Entry(l.name + "_activation", l, True))
    return tuple(entries)


def layer_output_shapes(spec: ModelSpec) -> dict[str, tuple[int, ...]]:
    """Static per-layer output shapes (without batch)."""
    shapes: dict[str, tuple[int, ...]] = {}
    shape: tuple[int, ...] = tuple(spec.input_shape)
    for l in spec.layers:
        if l.kind == "conv":
            h, w, _ = shape
            if l.padding == "SAME":
                oh = math.ceil(h / l.strides[0])
                ow = math.ceil(w / l.strides[1])
            else:
                oh = math.ceil((h - l.kernel_size[0] + 1) / l.strides[0])
                ow = math.ceil((w - l.kernel_size[1] + 1) / l.strides[1])
            shape = (oh, ow, l.filters)
        elif l.kind == "pool":
            h, w, c = shape
            shape = (h // l.pool_size[0], w // l.pool_size[1], c)
        elif l.kind == "flatten":
            shape = (math.prod(shape),)
        elif l.kind == "dense":
            shape = (l.filters,)
        shapes[l.name] = shape
    return shapes


def init_params(
    spec: ModelSpec,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> dict[str, dict[str, torch.Tensor]]:
    """fp32 He-normal init of every conv (HWIO) and dense ((din, dout))
    layer, zero biases.  Draws from ``generator`` on its own device, so one seed
    gives one set of weights; ``jax.random`` cannot be reproduced, so parity
    tests carry the reference's params across instead
    (``models/weights.py:params_from_jax``)."""
    params: dict[str, dict[str, torch.Tensor]] = {}
    shape: tuple[int, ...] = tuple(spec.input_shape)
    shapes = layer_output_shapes(spec)
    for l in spec.layers:
        if l.kind == "conv":
            kh, kw = l.kernel_size
            wshape, fan_in = (kh, kw, shape[-1], l.filters), kh * kw * shape[-1]
        elif l.kind == "dense":
            fan_in = math.prod(shape)
            wshape = (fan_in, l.filters)
        if l.kind in ("conv", "dense"):
            w = torch.randn(wshape, generator=generator, device=generator.device)
            params[l.name] = {
                "w": (w * math.sqrt(2.0 / fan_in)).to(device),
                "b": torch.zeros((l.filters,), device=device),
            }
        shape = shapes[l.name]
    return params
