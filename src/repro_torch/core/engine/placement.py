"""Execution placement (port of `repro.core.engine.placement`, the `vmap` row).

| strategy | placement | lane execution |
|---|---|---|
| ``vmap`` | one device | lockstep lanes, the [B] axis written out: the branchless fused windowed drain (`fused._omni_window`) with `drain=True` (the default), the single-event step (`omni._omni_step`) with `drain=False`; captured into a CUDA graph on the card |
| ``map`` / ``mesh`` | — | not ported yet (A2, A7): raise `NotImplementedError` |
| continuation (``states=``) | the states' device | the same lanes, stepped on from `states` in place (`Simulator.resume`) |
| ``auto`` | | ``vmap``, the port's one placement (the reference's strategies are bitwise-identical per cell, so the results are the reference's ``map`` results too) |
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.engine.batch import lane_bank, run
from repro_torch.core.engine.metrics import summarize_batch
from repro_torch.core.engine.state import SimConfig, WorldSpec, init_state_world
from repro_torch.unported import not_ported

STRATEGIES = ("map", "vmap", "mesh")


def resolve_strategy(strategy: str) -> str:
    """``auto`` -> ``vmap``; ``map``/``mesh`` raise; unknown names raise."""
    if strategy == "vmap" or strategy == "auto":
        return "vmap"
    if strategy == "map":
        raise not_ported('strategy="map" (sequential lanes)', "A2")
    if strategy == "mesh":
        raise not_ported('strategy="mesh" (multi-GPU grids)', "A7")
    raise ValueError(
        f"unknown strategy {strategy!r} (choose from {('auto',) + STRATEGIES})"
    )


def placement_cfg(cfg: SimConfig, strategy: str) -> SimConfig:
    """The vmap strategy's engine configuration: lockstep lanes."""
    if strategy == "vmap":
        return dataclasses.replace(cfg, lockstep=True)
    return cfg


def simulate_batch(cfg: SimConfig, bank, worlds: WorldSpec | None, *,
                   bank_batched: bool = False, states=None, strategy: str = "auto",
                   device=None):
    """Run a [B]-stacked batch of worlds in lockstep on `device`.

    Fresh runs build their states from `worlds`. A continuation passes the
    [B]-batched `states` of an earlier run instead (`worlds` is unused): B
    comes from `states.now`, and the run steps those tensors in place, the
    port's form of the reference's donated buffers: the caller must not
    reuse them as the states they were. Either way the placement's config
    (`lockstep=True`) is the one that runs.

    Returns (the config that ran, final states [B-batched], list of B
    metric dicts, lockstep steps executed)."""
    strategy = resolve_strategy(strategy)
    cfg = placement_cfg(cfg, strategy)
    if states is None:
        states = init_state_world(cfg, worlds, device)
    B = int(states.now.shape[0])
    bank = lane_bank(bank, B, bank_batched)
    states, steps = run(cfg, bank, states)
    return cfg, states, summarize_batch(cfg, states), steps
