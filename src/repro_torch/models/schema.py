"""Parameter schema: one declarative source of truth for the shape and
initialization of every weight (port of `repro.models.schema`).

A schema is a flat dict  name -> ParamSpec(shape, axes, init, dtype) . The
logical axis names are kept so that a schema reads as the reference's; the
mesh tools that consume them (`abstract_params`, `shardings`,
`logical_to_spec`) belong to multi-device work (ROADMAP.md §A item A7).

`init_params` draws from an explicit `torch.Generator`. It cannot give JAX's
numbers for the same seed: tests that compare the two packages carry the
reference's weights across (`interop.params_from_numpy`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | embed | scaled:<fanin-dim>
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


Schema = dict  # name -> ParamSpec


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_params(schema: Schema, generator: torch.Generator, device=None, dtype=None) -> dict:
    """Real weights, drawn in sorted-name order from `generator`, which must
    live on `device` (default: the card). `dtype` overrides every spec's."""
    dev = resolve_device(device)
    params = {}
    for n in sorted(schema):
        s = schema[n]
        dt = dtype or torch_dtype(s.dtype)
        if s.init == "zeros":
            params[n] = torch.zeros(s.shape, dtype=dt, device=dev)
        elif s.init == "ones":
            params[n] = torch.ones(s.shape, dtype=dt, device=dev)
        else:
            if s.init.startswith("scaled"):
                fan_in = int(s.init.split(":")[1]) if ":" in s.init else s.shape[-2]
                std = 1.0 / math.sqrt(max(fan_in, 1))
            else:  # normal | embed
                std = 0.02
            w = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=dev)
            params[n] = w.mul_(std).to(dt)
    return params


def param_count(schema: Schema) -> int:
    return sum(math.prod(s.shape) for s in schema.values())


def param_bytes(schema: Schema) -> int:
    return sum(
        math.prod(s.shape) * torch_dtype(s.dtype).itemsize for s in schema.values()
    )
