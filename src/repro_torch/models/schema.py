"""Parameter schema: one declarative source of truth for the shape and
initialization of every weight (port of `repro.models.schema`).

A schema is a flat dict  name -> ParamSpec(shape, axes, init, dtype) .
From it, without materializing weights:
  * abstract_params(schema) — the shapes and dtypes as tensors on the
    `meta` device (no allocation);
  * shardings(schema, rules, mesh) — each weight's partition spec over a
    mesh (`launch.mesh.Mesh`): a tuple with one entry a dimension, a mesh
    axis name, a tuple of names or None (replicated), the reference's
    `NamedSharding(mesh, spec).spec`;
  * init_params(...) / init_params_threefry(...) — real tensors.

Logical axis vocabulary (the reference's, MaxText-style): "layers" (the
stacked-layer dim, never sharded), "embed" (d_model, the FSDP axis),
"vocab", "heads", "kv", "mlp", "experts" (the wide dims, over "model"),
"state" / "conv" / None (small dims, replicated); `dist.sharding` holds
the rules that map them onto mesh axes.

`init_params` draws from an explicit `torch.Generator`, fast on the card but
not JAX's numbers for the same seed: tests that compare the two packages
carry the reference's weights across (`interop.params_from_numpy`).
`init_params_threefry` draws the reference's own `init_params(schema,
PRNGKey(seed))` on the host with the port's threefry (`data/threefry.py`),
as the training launcher does.
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


def abstract_params(schema: Schema) -> dict:
    """{name: tensor on the `meta` device} of each spec's shape and dtype."""
    return {n: torch.empty(s.shape, dtype=torch_dtype(s.dtype), device="meta")
            for n, s in schema.items()}


def logical_to_spec(axes: tuple, rules: dict) -> tuple:
    """The partition spec of a weight whose dims carry the logical `axes`:
    each dim's mesh axis (or tuple of axes) from `rules`, or None. One mesh
    axis shards at most one dim of a tensor: a later dim that maps to an
    axis already used is replicated."""
    mesh_axes = []
    used = set()
    for ax in axes:
        m = rules.get(ax)
        if m is None or m in used:
            mesh_axes.append(None)
        else:
            mesh_axes.append(m)
            used.add(m if isinstance(m, str) else tuple(m))
    return tuple(mesh_axes)


def shardings(schema: Schema, rules: dict, mesh) -> dict:
    """{name: partition spec} of every weight over `mesh`, which is read
    only for its axis sizes (`mesh.shape`). A mesh axis that does not
    divide its dim is dropped (that dim is replicated), as the reference
    prefers replication for oddball dims such as kv = 8 on a 16-way axis."""
    out = {}
    for n, s in schema.items():
        fixed = []
        for dim, m in zip(s.shape, logical_to_spec(s.axes, rules)):
            if m is None:
                fixed.append(None)
                continue
            size = mesh.shape[m] if isinstance(m, str) else math.prod(mesh.shape[a] for a in m)
            fixed.append(m if dim % size == 0 else None)
        out[n] = tuple(fixed)
    return out


def init_params_threefry(schema: Schema, seed: int = 0, device=None, dtype=None) -> dict:
    """The reference's `init_params(schema, jax.random.PRNGKey(seed))`: one
    key a name in sorted-name order from `split(PRNGKey(seed), n)`, normal
    draws scaled by 0.02 (normal, embed) or fan_in^-0.5 (scaled:<fan_in>),
    zeros and ones. The normals come from the port's threefry on the host
    (bit for bit the reference's uniforms; erfinv within a few ulps), so
    this is for the launcher's and the tests' sizes, not a 3B model."""
    from repro_torch.data import threefry

    dev = resolve_device(device)
    names = sorted(schema)
    keys = threefry.split(threefry.PRNGKey(seed), len(names))
    params = {}
    for key, n in zip(keys, names):
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
            w = torch.from_numpy(threefry.normal(key, s.shape)) * std
            params[n] = w.to(dt).to(dev)
    return params


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
