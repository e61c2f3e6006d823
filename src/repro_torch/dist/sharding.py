"""Logical-axis -> mesh-axis sharding rules, and the worlds mesh's
placement (port of `repro.dist.sharding`).

The model schema (`models.schema`) names every weight dim with a logical
axis ("embed", "heads", "mlp", ...); this module maps those names onto mesh
axes for each execution mode and builds the partition specs of params,
optimizer state and input batches. A spec is the port's record of the
reference's `NamedSharding(mesh, spec).spec`: a tuple with one entry a
dimension, a mesh axis name, a tuple of names or None.

The engine's rule set is one line (`worlds_pspec`): a stacked engine tree
splits on its leading [B] axis over the 1-D "worlds" mesh, and nothing
inside a world crosses a device. `world_lanes`, `place_worlds` and
`gather_worlds` carry that out: the reference's `world_shardings` /
`place_worlds` pin a tree to the mesh for `shard_map`, the port copies each
device's slice onto it and gathers the slices back
(`core.engine.placement`'s mesh row).
"""

from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import WORLDS_AXIS, Mesh, data_axes


# ---------------------------------------------------------------------------
# engine world-batch placement (the `strategy="mesh"` rules)
# ---------------------------------------------------------------------------


def worlds_pspec(batched: bool = True) -> tuple:
    """The spec of one engine batch leaf: the leading [B] axis over the
    1-D "worlds" mesh; unbatched (shared) leaves replicate."""
    return (WORLDS_AXIS,) if batched else ()


def world_lanes(num_worlds: int, mesh: Mesh) -> list:
    """Each device's lanes, as [B]-axis indices in contiguous blocks. When
    B does not divide the device count the axis is padded by repeating
    lanes modulo B (the reference's padding lanes): the caller cuts them
    off before any metric reads the batch."""
    ndev = mesh.size
    per = -(-num_worlds // ndev)
    return list((torch.arange(per * ndev) % num_worlds).view(ndev, per))


def _engine_trees():
    # imported on use: `core.engine` imports this module
    from repro_torch.core.engine.state import tree_leaves, tree_map

    return tree_leaves, tree_map


def place_worlds(tree, mesh: Mesh, batched: bool = True) -> list:
    """[one tree a device of `mesh`]: each device's lanes (`world_lanes`)
    of a [B]-stacked engine tree (NamedTuples of tensors: WorldSpec, Bank,
    SimState) copied onto it; an unbatched tree (a Bank every cell shares)
    goes whole to each device. Non-tensor leaves pass as they are."""
    tree_leaves, tree_map = _engine_trees()

    def take(fn):
        return tree_map(lambda x: fn(x) if isinstance(x, torch.Tensor) else x, tree)

    if not batched:
        return [take(lambda x: x.to(dev)) for dev in mesh.devices]
    B = next(int(x.shape[0]) for _, x in tree_leaves(tree) if isinstance(x, torch.Tensor))
    return [take(lambda x: x[idx.to(x.device)].to(dev))
            for dev, idx in zip(mesh.devices, world_lanes(B, mesh))]


def gather_worlds(slices: list, num_worlds: int, device) -> object:
    """The slices of `place_worlds` back into one [B]-stacked tree on
    `device`, the padding lanes cut off."""
    _, tree_map = _engine_trees()

    def cat(*xs):
        if not isinstance(xs[0], torch.Tensor):
            return xs[0]
        return torch.cat([x.to(device) for x in xs])[:num_worlds]

    return tree_map(cat, *slices)


# ---------------------------------------------------------------------------
# the LM stack's rules
# ---------------------------------------------------------------------------


def train_rules(mesh: Mesh) -> dict:
    """FSDP storage over the data axes, tensor parallelism over "model".

    "embed" is the FSDP axis (params sharded over data for storage), the
    wide dims shard over the model axis."""
    data = data_axes(mesh)
    return {
        "embed": data if len(data) > 1 else (data[0] if data else None),
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "experts": "model",
        "layers": None,
        "state": None,
        "conv": None,
    }


def decode_rules(mesh: Mesh) -> dict:
    """Pure tensor parallelism: params replicated over data, sharded over
    "model" on the wide dims (decode batches are too small for FSDP)."""
    return {
        "embed": None,
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "experts": "model",
        "layers": None,
        "state": None,
        "conv": None,
    }


def rules_for(mesh: Mesh, mode: str) -> dict:
    return train_rules(mesh) if mode == "train" else decode_rules(mesh)


def param_shardings(cfg, mesh: Mesh, mode: str = "train") -> dict:
    """{name: spec} matching the arch's parameter schema."""
    from repro_torch.models import schema, stack

    return schema.shardings(stack.build_schema(cfg), rules_for(mesh, mode), mesh)


def opt_shardings(param_sh: dict, mesh: Mesh) -> dict:
    """AdamW state: moments follow the params, the step is replicated."""
    return {"m": param_sh, "v": param_sh, "step": ()}


def batch_shardings(mesh: Mesh, batch_spec: dict) -> dict:
    """Shard every batch leaf (anything with a ``shape``, in nested dicts)
    on its leading (batch) dim over the data axes; replicate a leaf whose
    leading dim the axes' size does not divide (the schema's guard)."""
    data = data_axes(mesh)
    size = math.prod(mesh.shape[a] for a in data) if data else 1
    axis = data if len(data) > 1 else (data[0] if data else None)

    def one(spec):
        if isinstance(spec, dict):
            return {k: one(v) for k, v in spec.items()}
        shape = tuple(spec.shape)
        if axis is None or shape == () or shape[0] % size:
            return ()
        return (axis, *([None] * (len(shape) - 1)))

    return one(batch_spec)
