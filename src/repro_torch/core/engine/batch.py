"""Run loop (port of `repro.core.engine.batch.run`, lockstep only).

The reference runs `jax.vmap` over a `lax.while_loop`: every lane steps
until ALL lanes' conditions are false, and a lane whose own condition is
already false keeps its old state (the vmap lane freeze). `run` does the
same on a [B]-batched state: each step computes every lane's next state
and keeps the old one where the lane is done (`min(_times_flat) >=
horizon_us` or `iters >= max_events`), on every leaf, `iters` included.

Frozen lanes are idempotent, so the host reads "all lanes done" only every
`_CHECK_EVERY` steps (one device sync per check) instead of each step; the
up to `_CHECK_EVERY - 1` steps past the end change nothing, and they are
counted in the steps `run` returns.
"""

from __future__ import annotations

import torch

from repro_torch.core.workloads import BANK_ARRAYS, Bank
from repro_torch.core.engine.omni import _omni_step
from repro_torch.core.engine.state import SimConfig, SimState, _times_flat, tree_map
from repro_torch.unported import not_ported

# steps between two host reads of "all lanes done"; safe at any value,
# since a step leaves every frozen lane as it was
_CHECK_EVERY = 32


def lane_bank(bank: Bank, B: int, batched: bool) -> Bank:
    """A bank whose array leaves carry a leading [B] axis: per-cell banks
    as they are, a shared bank expanded (a view, no copy)."""
    if batched:
        return bank
    return bank._replace(
        **{f: getattr(bank, f).expand(B, *getattr(bank, f).shape) for f in BANK_ARRAYS}
    )


def _active(cfg: SimConfig, s: SimState) -> torch.Tensor:
    nxt = _times_flat(s).amin(1)
    return (nxt < cfg.horizon_us) & (s.iters < cfg.max_events)


def _freeze(act: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Lane b keeps `old` unless act[b]. A leaf the step did not touch (the
    same tensor object, e.g. the knobs and the fault leaves) needs no select."""
    if new is old:
        return old
    return torch.where(act.view(-1, *([1] * (old.dim() - 1))), new, old)


def run(cfg: SimConfig, bank: Bank, state: SimState):
    """Step every lane to the horizon (or the event budget).

    `bank` has [B]-leading array leaves (`lane_bank`). Returns (final state,
    lockstep steps executed, idle tail steps included)."""
    if cfg.drain:
        raise not_ported("the windowed drain (drain=True)", "A4")
    if cfg.max_faults:
        raise not_ported("a fault schedule (max_faults > 0)", "A3")
    s = state
    steps = 0
    if not bool(_active(cfg, s).any()):
        return s, steps
    while True:
        for _ in range(_CHECK_EVERY):
            act = _active(cfg, s)
            nxt = _omni_step(cfg, bank, s)
            s = tree_map(lambda new, old: _freeze(act, new, old), nxt, s)
            steps += 1
        if not bool(_active(cfg, s).any()):
            return s, steps
