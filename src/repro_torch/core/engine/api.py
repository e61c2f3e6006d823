"""Public simulation API: `Simulator` + `Grid` + `RunResult` (port of
`repro.core.engine.api`, fault-free lockstep slice).

* **`Grid`** — a validated sweep over the engine axes `preset`, `rtt_ms`,
  `tau_true_us`, `jitter_milli` (default **30**, as the reference),
  `exec_scale_milli`, `seed`, `clock_skew_us`, plus free-form labels and
  optional per-cell Banks; the reference's validation messages. The
  `faults`, `replica_tau` and `repl_lag_us` axes raise `NotImplementedError`.
* **`Simulator`** — runs a Grid's cells as [B] lockstep lanes on one device
  (`device=None` means CUDA; it raises when no card is present). `drain`
  defaults to True, as the reference: each step is the fused windowed
  drain (`fused._omni_window`); `drain=False` steps `omni._omni_step`.
  `strategy="map"/"mesh"` and `resume` raise.
* **`RunResult`** — final states (batched over cells), one metric dict per
  cell, the lockstep step count, wall time; `.rows()`, `.world(i)`,
  `.drain`, `.events`.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.core.netmodel import PAPER_RTT_MS
from repro_torch.core.protocols import PRESETS, ProtocolConfig
from repro_torch.core.workloads import Bank, bank_to, stack_banks
from repro_torch.core.engine.metrics import drain_stats, world_index
from repro_torch.core.engine.placement import resolve_strategy, simulate_batch
from repro_torch.core.engine.state import (
    SimConfig,
    WorldSpec,
    make_world,
    stack_worlds,
    tree_map,
)
from repro_torch.unported import not_ported

_VECTOR_AXES = ("rtt_ms", "tau_true_us", "exec_scale_milli", "replica_tau")
_FAULT_AXES = ("faults", "replica_tau", "repl_lag_us")
_NON_LABEL_AXES = ("tau_true_us", "exec_scale_milli", "faults", "replica_tau")


def _cell_num_ds(cell: dict, default_rtt_ms) -> int:
    if cell.get("tau_true_us") is not None:
        return len(cell["tau_true_us"])
    rtt = cell.get("rtt_ms")
    return len(rtt if rtt is not None else default_rtt_ms)


def _row_labels(cell: dict) -> dict:
    return {k: v for k, v in cell.items() if k not in _NON_LABEL_AXES}


def _bank_shapes(bank: Bank) -> tuple:
    return tuple(
        (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor) else (None, type(x).__name__)
        for x in bank
    )


class Grid:
    """A validated evaluation grid: cells × (optional) per-cell Banks.

    >>> g = Grid.cross(preset=("ssp", "geotp"), seed=(0, 1))
    >>> len(g), g.cells[0], g.cells[3]  # later axes vary fastest
    (4, {'preset': 'ssp', 'seed': 0}, {'preset': 'geotp', 'seed': 1})
    """

    def __init__(self, cells, *, banks=None, default_rtt_ms=None):
        if default_rtt_ms is None:
            default_rtt_ms = PAPER_RTT_MS
        cells = [dict(c) for c in cells]
        if not cells:
            raise ValueError("Grid needs at least one cell")
        self.default_rtt_ms = tuple(default_rtt_ms)
        self.cells = cells
        self.banks = list(banks) if banks is not None else None
        self.num_ds = _cell_num_ds(cells[0], default_rtt_ms)
        for i, c in enumerate(cells):
            preset = c.get("preset")
            if preset is None:
                raise ValueError(f"Grid cell {i}: missing required key 'preset'")
            if isinstance(preset, str):
                if preset not in PRESETS:
                    raise ValueError(
                        f"Grid cell {i}: unknown preset {preset!r} "
                        f"(known: {sorted(PRESETS)})"
                    )
            elif not isinstance(preset, ProtocolConfig):
                raise ValueError(
                    f"Grid cell {i}: preset must be a PRESETS name or a "
                    f"ProtocolConfig, got {type(preset).__name__}"
                )
            nd = _cell_num_ds(c, default_rtt_ms)
            if nd != self.num_ds:
                raise ValueError(
                    f"Grid cell {i}: num_ds={nd} (from "
                    f"{'tau_true_us' if c.get('tau_true_us') is not None else 'rtt_ms'})"
                    f" differs from cell 0's num_ds={self.num_ds} — "
                    "heterogeneous grids must be split into separate sweeps"
                )
            for ax in _FAULT_AXES:
                if c.get(ax) is not None:
                    raise not_ported(f"Grid cell {i}: the {ax!r} axis", "A3")
            skew = c.get("clock_skew_us")
            if skew is not None and (
                not isinstance(skew, int) or isinstance(skew, bool) or skew < 0
            ):
                raise ValueError(
                    f"Grid cell {i}: clock_skew_us must be a non-negative "
                    f"integer (microseconds of worst-case clock offset), "
                    f"got {skew!r}"
                )
        if self.banks is not None:
            if len(self.banks) != len(cells):
                raise ValueError(
                    f"Grid: {len(self.banks)} banks for {len(cells)} cells "
                    "(need exactly one bank per cell)"
                )
            ref = _bank_shapes(self.banks[0])
            for i, b in enumerate(self.banks):
                if _bank_shapes(b) != ref:
                    raise ValueError(
                        f"Grid bank {i}: leaf shapes/dtypes differ from bank 0 "
                        "(all per-cell banks must share one shape so they "
                        "stack into a single batched sweep)"
                    )

    @staticmethod
    def _axis_values(key: str, val) -> list:
        if val is None:
            return [None]
        if isinstance(val, (str, ProtocolConfig)):
            return [val]
        if not isinstance(val, (list, tuple)):
            return [val]
        if key in _VECTOR_AXES:
            if len(val) > 0 and isinstance(val[0], (list, tuple)):
                return list(val)
            return [tuple(val)]
        return list(val)

    @classmethod
    def cross(cls, *, banks=None, default_rtt_ms=None, **axes) -> "Grid":
        """Cross product of every axis (later axes vary fastest)."""
        keys = list(axes)
        lists = [cls._axis_values(k, axes[k]) for k in keys]
        cells = [
            {k: v for k, v in zip(keys, combo) if v is not None}
            for combo in itertools.product(*lists)
        ]
        return cls(cells, banks=banks, default_rtt_ms=default_rtt_ms)

    @classmethod
    def zipped(cls, *, banks=None, default_rtt_ms=None, **axes) -> "Grid":
        """Zip axes elementwise; scalars broadcast to every cell."""
        keys = list(axes)
        lists = [cls._axis_values(k, axes[k]) for k in keys]
        n = max((len(v) for v in lists), default=0)
        for k, v in zip(keys, lists):
            if len(v) not in (1, n):
                raise ValueError(
                    f"Grid.zipped: axis {k!r} has {len(v)} values, expected 1 or {n}"
                )
        lists = [v * n if len(v) == 1 else v for v in lists]
        cells = [
            {k: v[i] for k, v in zip(keys, lists) if v[i] is not None} for i in range(n)
        ]
        return cls(cells, banks=banks, default_rtt_ms=default_rtt_ms)

    def __len__(self) -> int:
        return len(self.cells)

    def __iter__(self):
        return iter(self.cells)

    def world(self, i: int) -> WorldSpec:
        c = self.cells[i]
        rtt = c.get("rtt_ms")
        return make_world(
            c["preset"],
            rtt if rtt is not None else self.default_rtt_ms,
            tau_true_us=c.get("tau_true_us"),
            jitter_milli=c.get("jitter_milli", 30),
            exec_scale_milli=c.get("exec_scale_milli"),
            seed=c.get("seed", 0),
            clock_skew_us=c.get("clock_skew_us", 0),
        )

    def worlds(self) -> WorldSpec:
        """All cells stacked into one WorldSpec with a leading [B] axis."""
        return stack_worlds([self.world(i) for i in range(len(self.cells))])

    def bank_stack(self) -> Bank:
        if self.banks is None:
            raise ValueError("Grid has no per-cell banks")
        return stack_banks(self.banks)


@dataclasses.dataclass
class RunResult:
    """Structured output of `Simulator.run` / `Simulator.run_grid`."""

    cfg: SimConfig
    states: Any  # SimState, leaves [B, ...]
    metrics: list
    cells: list
    strategy: str
    wall_s: float  # wall time of the lockstep run, synchronised
    steps: int  # lockstep steps executed (all lanes together, idle tail included)
    bank: Any = None
    bank_batched: bool = False
    batched: bool = True
    strategy_resolved: str = "vmap"

    def __len__(self) -> int:
        return len(self.metrics)

    @property
    def events(self) -> int:
        return sum(m["events"] for m in self.metrics)

    @property
    def drain(self) -> dict:
        return drain_stats(self.states, horizon_us=self.cfg.horizon_us)

    def world(self, i: int):
        """Final SimState of cell i."""
        if not self.batched:
            if i != 0:
                raise IndexError(f"single-world result has no cell {i}")
            return world_index(self.states, 0)
        return world_index(self.states, i)

    def rows(self) -> list:
        return [{**_row_labels(cell), **m} for cell, m in zip(self.cells, self.metrics)]

    def save(self, tag: str, path=None) -> dict:
        raise not_ported("RunResult.save (the port's bench file)", "A5")


class Simulator:
    """Facade over the lockstep engine, fixed to one set of static shapes.

    `device=None` runs on the card ("cuda") and raises without one; pass
    ``device="cpu"`` to run on the CPU explicitly."""

    def __init__(
        self,
        terminals: int,
        max_ops: int,
        num_ds: int,
        bank_txns: int,
        *,
        proto="geotp",
        horizon_s: float = 10.0,
        warmup_s: float = 2.0,
        drain: bool = True,
        track_slots: bool = False,
        hot_capacity: int = 1024,
        device=None,
    ):
        if isinstance(proto, str):
            proto = PRESETS[proto]
        self.device = resolve_device(device)
        self.cfg = SimConfig(
            terminals=terminals,
            max_ops=max_ops,
            num_ds=num_ds,
            bank_txns=bank_txns,
            proto=proto,
            hot_capacity=hot_capacity,
            warmup_us=int(warmup_s * 1e6),
            horizon_us=int(horizon_s * 1e6),
            drain=drain,
            track_slots=track_slots,
        )

    @classmethod
    def from_bank(cls, bank: Bank, terminals: int | None = None, **kw) -> "Simulator":
        """Infer shapes from a Bank: key is [T, N, K], num_ds from the Bank."""
        T, N, K = bank.key.shape[-3:]
        return cls(terminals or T, K, bank.num_ds, N, **kw)

    def _check_bank(self, bank: Bank, batched: bool) -> None:
        shape = bank.key.shape[1:] if batched else bank.key.shape
        want = (self.cfg.terminals, self.cfg.bank_txns, self.cfg.max_ops)
        if tuple(shape) != want:
            raise ValueError(
                f"bank.key shape {tuple(shape)} != (terminals, bank_txns, "
                f"max_ops) = {want} of this Simulator"
            )
        if bank.num_ds != self.cfg.num_ds:
            raise ValueError(
                f"bank.num_ds={bank.num_ds} != Simulator num_ds={self.cfg.num_ds}"
            )

    def _run(self, worlds: WorldSpec, bank: Bank, bank_batched: bool, strategy: str):
        bank = bank_to(bank, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        states, metrics, steps = simulate_batch(
            self.cfg, bank, worlds, bank_batched=bank_batched, strategy=strategy,
            device=self.device,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        for i, m in enumerate(metrics):
            if m["noops"] != 0:
                raise RuntimeError(f"cell {i}: {m['noops']} noop events fired")
        return states, metrics, steps, wall, bank

    def run(self, world: WorldSpec, bank: Bank, *, labels: dict | None = None) -> RunResult:
        """Run ONE world (a single lockstep lane)."""
        self._check_bank(bank, batched=False)
        worlds = tree_map(lambda x: x[None], world)
        states, metrics, steps, wall, bank = self._run(worlds, bank, False, "vmap")
        return RunResult(
            cfg=self.cfg, states=states, metrics=metrics, cells=[dict(labels or {})],
            strategy="vmap", wall_s=wall, steps=steps, bank=bank, bank_batched=False, batched=False,
        )

    def run_grid(self, grid: Grid, bank: Bank | None = None, *, strategy: str = "auto",
                 mesh_devices: int | None = None) -> RunResult:
        """Run every cell of a Grid as [B] lockstep lanes on this device."""
        if mesh_devices not in (None, 1):
            raise not_ported("mesh_devices > 1 (multi-GPU grids)", "A7")
        resolved = resolve_strategy(strategy)
        if grid.num_ds != self.cfg.num_ds:
            raise ValueError(
                f"grid num_ds={grid.num_ds} != Simulator num_ds={self.cfg.num_ds}"
            )
        if grid.banks is not None:
            bank = grid.bank_stack()
            bank_batched = True
        elif bank is None:
            raise ValueError("run_grid needs a shared bank or a Grid with banks")
        else:
            bank_batched = False
        self._check_bank(bank, batched=bank_batched)
        states, metrics, steps, wall, bank = self._run(
            grid.worlds(), bank, bank_batched, resolved
        )
        return RunResult(
            cfg=dataclasses.replace(self.cfg, lockstep=True), states=states,
            metrics=metrics, cells=[dict(c) for c in grid.cells], strategy=strategy,
            wall_s=wall, steps=steps, bank=bank,
            bank_batched=bank_batched, batched=True, strategy_resolved=resolved,
        )

    def resume(self, result: RunResult, **kw) -> RunResult:
        raise not_ported("Simulator.resume", "A5")
