"""Execution placement (port of `repro.core.engine.placement`, the `map`
and `vmap` rows).

| strategy | placement | lane execution |
|---|---|---|
| ``map`` | one device | sequential lanes, one after another, each to its own end: the map-lane drain step (`apply._drain_step`) with `drain=True` (the default), the single-event `step._step` with `drain=False`; host-driven, never captured: the slow path on the card |
| ``vmap`` | one device | lockstep lanes, the [B] axis written out: the branchless fused windowed drain (`fused._omni_window`) with `drain=True` (the default), the single-event step (`omni._omni_step`) with `drain=False`; captured into a CUDA graph on the card |
| ``mesh`` | — | not ported yet (A7): raises `NotImplementedError` |
| continuation (``states=``) | the states' device | the same lanes, stepped on from `states` in place (`Simulator.resume`) |
| ``auto`` | | ``vmap``, as the reference picks on one accelerator |

The strategies are bitwise-identical per cell on every leaf but `fused`,
the lockstep drain's own counter (the map lanes never fuse).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.engine.batch import lane_bank, run
from repro_torch.core.engine.metrics import summarize_batch
from repro_torch.core.engine.state import SimConfig, WorldSpec, init_state_world
from repro_torch.unported import not_ported

STRATEGIES = ("map", "vmap", "mesh")


def resolve_strategy(strategy: str) -> str:
    """``auto`` -> ``vmap``; ``map`` / ``vmap`` pass through; ``mesh``
    raises; unknown names raise."""
    if strategy == "vmap" or strategy == "auto":
        return "vmap"
    if strategy == "map":
        return "map"
    if strategy == "mesh":
        raise not_ported('strategy="mesh" (multi-GPU grids)', "A7")
    raise ValueError(
        f"unknown strategy {strategy!r} (choose from {('auto',) + STRATEGIES})"
    )


def placement_cfg(cfg: SimConfig, strategy: str) -> SimConfig:
    """The strategy's engine configuration: lockstep lanes for vmap,
    sequential lanes for map (a continued vmap result's config says
    lockstep)."""
    return dataclasses.replace(cfg, lockstep=strategy == "vmap")


def simulate_batch(cfg: SimConfig, bank, worlds: WorldSpec | None, *,
                   bank_batched: bool = False, states=None, strategy: str = "auto",
                   device=None):
    """Run a [B]-stacked batch of worlds on `device`: in lockstep (vmap), or
    one sequential lane after another (map).

    Fresh runs build their states from `worlds`. A continuation passes the
    [B]-batched `states` of an earlier run instead (`worlds` is unused): B
    comes from `states.now`, and the run steps those tensors in place, the
    port's form of the reference's donated buffers: the caller must not
    reuse them as the states they were. Either way the placement's config
    (`placement_cfg`) is the one that runs.

    Returns (the config that ran, final states [B-batched], list of B
    metric dicts, steps: the lockstep steps executed for vmap, the lanes'
    sequential steps summed for map)."""
    strategy = resolve_strategy(strategy)
    cfg = placement_cfg(cfg, strategy)
    if states is None:
        states = init_state_world(cfg, worlds, device)
    B = int(states.now.shape[0])
    bank = lane_bank(bank, B, bank_batched)
    states, steps = run(cfg, bank, states)
    return cfg, states, summarize_batch(cfg, states), steps
