"""Execution placement (port of `repro.core.engine.placement`).

Every multi-world sweep follows one protocol: stack the `WorldSpec` /
`Bank` trees on a leading [B] axis, place them, run every lane, gather the
final `SimState` batch back. This module owns "place + run":

| strategy | placement | lane execution |
|---|---|---|
| ``map`` | one device | sequential lanes, one after another, each to its own end: the map-lane drain step (`apply._drain_step`) with `drain=True` (the default), the single-event `step._step` with `drain=False`; host-driven, never captured: the slow path on the card |
| ``vmap`` | one device | lockstep lanes, the [B] axis written out: the branchless fused windowed drain (`fused._omni_window`) with `drain=True` (the default), the single-event step (`omni._omni_step`) with `drain=False`; captured into a CUDA graph on the card |
| ``mesh`` | 1-D ``worlds`` mesh over N devices (`launch.mesh.make_worlds_mesh`, counted by the census `launch.mesh.local_devices`) | the batch splits on its leading axis into one slice a device (`dist.sharding.place_worlds`); each slice runs with the strategy ``auto`` picks for one such device (`slice_strategy`): the captured lockstep step on a card, the map lanes on the CPU, every slice's replays issued before any host read (`batch.run_slices`); nothing crosses devices, since worlds are independent; the slices are gathered back on the run's device |
| continuation (``states=``) | the states' device | the same lanes, stepped on from `states` in place (`Simulator.resume`); the mesh re-splits them and copies the result back into the same tensors |
| ``auto`` | resolved by `resolve_strategy` | mesh when more than one device is visible, vmap on one card, map on the CPU |

Grids whose cell count does not divide the mesh's device count get padding
lanes (cells repeated modulo B). They run like any other lane but are cut
off when the slices are gathered, so no telemetry path (`summarize_batch`,
`drain_stats`, `RunResult.rows()`) ever sees them; only the step count
includes their slices' steps, which ran.

The strategies are bitwise-identical per cell on every leaf but `fused`,
the lockstep drain's own counter (the map lanes never fuse): a mesh on the
CPU runs the map lanes and equals the map strategy on every leaf, a mesh
on cards the vmap strategy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.core.engine.batch import lane_bank, run, run_slices
from repro_torch.core.engine.metrics import summarize_batch
from repro_torch.core.engine.state import SimConfig, WorldSpec, init_state_world, tree_leaves
from repro_torch.dist.sharding import gather_worlds, place_worlds
from repro_torch.launch import mesh as launch_mesh

STRATEGIES = ("map", "vmap", "mesh")


def _backend(device) -> str:
    """The reference's backend name of `device`'s type (None means the card)."""
    return "gpu" if torch.device("cuda" if device is None else device).type == "cuda" else "cpu"


def resolve_strategy(strategy: str, *, device_count: int | None = None,
                     backend: str | None = None, device=None) -> str:
    """Resolve ``"auto"`` to a concrete strategy: the reference's decision
    table.

    * ``mesh`` when more than one device is visible (worlds are
      independent, so every extra device is a free lane multiplier);
    * ``vmap`` on one accelerator (``backend`` "gpu" or "tpu");
    * ``map`` on the CPU.

    Explicit strategies pass through unchanged; unknown names raise.
    ``device_count`` / ``backend`` default to the census of `device`'s type
    (`launch.mesh.local_devices`) and its backend ("gpu" for a CUDA device,
    "cpu"); `device=None` means the card."""
    if strategy in STRATEGIES:
        return strategy
    if strategy != "auto":
        raise ValueError(
            f"unknown strategy {strategy!r} (choose from {('auto',) + STRATEGIES})"
        )
    n = len(launch_mesh.local_devices(device)) if device_count is None else device_count
    if n > 1:
        return "mesh"
    b = _backend(device) if backend is None else backend
    return "vmap" if b in ("tpu", "gpu") else "map"


def slice_strategy(device) -> str:
    """The strategy a mesh slice runs with on `device`: what ``auto`` picks
    for one such device (vmap on a card, map on the CPU)."""
    return resolve_strategy("auto", device_count=1, backend=_backend(device))


def mesh_device_count(strategy: str, mesh_devices: int | None = None, device=None) -> int:
    """Devices the resolved strategy places lanes on: 1 off the mesh; on
    the mesh the census of `device`'s type, or `mesh_devices`. Asking for
    more devices than the host has raises with both counts."""
    if strategy != "mesh":
        return 1
    return launch_mesh.make_worlds_mesh(mesh_devices, device).size


def placement_cfg(cfg: SimConfig, strategy: str, device=None) -> SimConfig:
    """The strategy's engine configuration: lockstep lanes for vmap,
    sequential lanes for map (a continued vmap result's config says
    lockstep), and for the mesh the configuration each slice runs on
    `device`'s type (`slice_strategy`)."""
    if strategy == "mesh":
        strategy = slice_strategy(device)
    return dataclasses.replace(cfg, lockstep=strategy == "vmap")


def _run_mesh(cfg: SimConfig, bank, states, bank_batched: bool, mesh_devices, dev):
    """The mesh row: `states` split into one slice a device of the worlds
    mesh, each slice stepped on its device, the slices gathered back on
    `dev` without the padding lanes. Returns (states, steps)."""
    mesh = launch_mesh.make_worlds_mesh(mesh_devices, dev)
    B = int(states.now.shape[0])
    parts = place_worlds(states, mesh)
    banks = [lane_bank(b, int(p.now.shape[0]), bank_batched)
             for b, p in zip(place_worlds(bank, mesh, batched=bank_batched), parts)]
    parts, steps = run_slices(cfg, banks, parts)
    return gather_worlds(parts, B, dev), steps


def simulate_batch(cfg: SimConfig, bank, worlds: WorldSpec | None, *,
                   bank_batched: bool = False, states=None, strategy: str = "auto",
                   mesh_devices: int | None = None, device=None):
    """Run a [B]-stacked batch of worlds on `device` (None means the card):
    in lockstep (vmap), one sequential lane after another (map), or split
    over the worlds mesh's devices (mesh, `mesh_devices` of them; default:
    the census).

    Fresh runs build their states from `worlds`. A continuation passes the
    [B]-batched `states` of an earlier run instead (`worlds` is unused): B
    comes from `states.now`, and the run steps those tensors in place, the
    port's form of the reference's donated buffers: the caller must not
    reuse them as the states they were. Either way the placement's config
    (`placement_cfg`) is the one that runs.

    Returns (the config that ran, final states [B-batched], list of B
    metric dicts, steps: the lockstep steps executed for vmap, the lanes'
    sequential steps summed for map, the slices' summed for mesh)."""
    dev = resolve_device(device)
    strategy = resolve_strategy(strategy, device=dev)
    cfg = placement_cfg(cfg, strategy, dev)
    fresh = states is None
    home = init_state_world(cfg, worlds, dev) if fresh else states
    if strategy == "mesh":
        out, steps = _run_mesh(cfg, bank, home, bank_batched, mesh_devices, dev)
        if not fresh:  # the continuation's own tensors take the result
            for (_, o), (_, x) in zip(tree_leaves(home), tree_leaves(out)):
                o.copy_(x)
            out = home
    else:
        out, steps = run(cfg, lane_bank(bank, int(home.now.shape[0]), bank_batched), home)
    return cfg, out, summarize_batch(cfg, out), steps
