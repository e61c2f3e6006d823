"""Public simulation API: `Simulator` + `Grid` + `RunResult` (port of
`repro.core.engine.api`, lockstep lanes).

* **`Grid`** — a validated sweep over the engine axes `preset`, `rtt_ms`,
  `tau_true_us`, `jitter_milli` (default **30**, as the reference),
  `exec_scale_milli`, `seed`, `clock_skew_us`, the fault axes `faults`
  (typed rows or legacy crash triples, validated per cell, one row count
  across cells), `replica_tau` and `repl_lag_us`, plus free-form labels and
  optional per-cell Banks; the reference's validation messages.
* **`Simulator`** — runs a Grid's cells as [B] lockstep lanes on one device
  (`device=None` means CUDA; it raises when no card is present). `drain`
  defaults to True, as the reference: each step is the fused windowed
  drain (`fused._omni_window`); `drain=False` steps `omni._omni_step`.
  `strategy="map"/"mesh"` and `resume` raise. A grid's fault row count
  sets the run's `SimConfig.max_faults`.
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
from repro_torch.core.netmodel import INF_US, PAPER_RTT_MS
from repro_torch.core.protocols import PRESETS, ProtocolConfig
from repro_torch.core.workloads import Bank, bank_to, stack_banks
from repro_torch.core.engine.metrics import drain_stats, world_index
from repro_torch.core.engine.placement import resolve_strategy, simulate_batch
from repro_torch.core.engine.state import (
    FAULT_COLS,
    KIND_CRASH,
    KIND_DEGRADE,
    KIND_PARTITION,
    MW,
    SimConfig,
    WorldSpec,
    make_world,
    stack_worlds,
    tree_map,
)
from repro_torch.unported import not_ported

_VECTOR_AXES = ("rtt_ms", "tau_true_us", "exec_scale_milli", "replica_tau")
_NON_LABEL_AXES = ("tau_true_us", "exec_scale_milli", "faults", "replica_tau")


def _cell_num_ds(cell: dict, default_rtt_ms) -> int:
    if cell.get("tau_true_us") is not None:
        return len(cell["tau_true_us"])
    rtt = cell.get("rtt_ms")
    return len(rtt if rtt is not None else default_rtt_ms)


def _fault_row_resources(kind: int, a: int, b: int) -> tuple:
    """The link/node resources one typed fault row occupies, as hashable
    keys: overlapping intervals on a shared resource are rejected. A CRASH
    claims its node AND its middleware link (the outage accounting
    `down_since`/`down_us` is per-node and cannot track two concurrent
    spells); a middleware-side PARTITION/DEGRADE claims the mw<->b link; a
    mesh row claims the undirected a<->b link."""
    if kind == KIND_CRASH:
        return (("ds", a), ("mw", a))
    if a == MW:
        return (("mw", b),)
    return (("mesh", min(a, b), max(a, b)),)


def _validate_cell_faults(i: int, val, num_ds: int) -> tuple:
    """Normalize + validate one cell's fault schedule at Grid construction.

    Rows are typed 6-tuples ``(t_start_us, kind, endpoint_a, endpoint_b,
    t_end_us, severity)`` with ``kind`` in {KIND_CRASH, KIND_PARTITION,
    KIND_DEGRADE} and ``endpoint_a == MW`` (-1) selecting the middleware
    side of a link; legacy ``(t_crash_us, ds, t_recover_us)`` crash triples
    are accepted and widened. Returns the schedule normalized to a tuple of
    6-tuples. Pad rows (t_start >= INF_US) are kept but skipped by the
    semantic checks. Raises ValueError with the offending cell index for
    malformed rows, unknown kinds, out-of-range endpoints, end-before-start,
    non-positive DEGRADE severity, or overlapping intervals on one
    link/node (see `_fault_row_resources`).
    """
    if not isinstance(val, (list, tuple)):
        raise ValueError(
            f"Grid cell {i}: faults must be a sequence of "
            f"(t_crash_us, ds, t_recover_us) triples or typed "
            f"(t_start_us, kind, endpoint_a, endpoint_b, t_end_us, severity) "
            f"rows, got {type(val).__name__}"
        )
    rows = []
    live = {}  # resource key -> list of ((start, end), row index)
    for j, r in enumerate(val):
        if not isinstance(r, (list, tuple)) or len(r) not in (3, FAULT_COLS):
            raise ValueError(
                f"Grid cell {i}: faults row {j} must be a "
                f"(t_crash_us, ds, t_recover_us) triple or a "
                f"(t_start_us, kind, endpoint_a, endpoint_b, t_end_us, "
                f"severity) 6-tuple, got {r!r}"
            )
        if len(r) == 3:
            crash, ds, rec = (int(x) for x in r)
            start, kind, a, b, end, sev = crash, KIND_CRASH, ds, ds, rec, 0
        else:
            start, kind, a, b, end, sev = (int(x) for x in r)
        rows.append((start, kind, a, b, end, sev))
        if start >= INF_US:
            continue  # pad row — never fires inside the horizon
        if kind not in (KIND_CRASH, KIND_PARTITION, KIND_DEGRADE):
            raise ValueError(
                f"Grid cell {i}: faults row {j} has unknown kind={kind} "
                f"(crash={KIND_CRASH}, partition={KIND_PARTITION}, "
                f"degrade={KIND_DEGRADE})"
            )
        if kind == KIND_CRASH:
            if not 0 <= a < num_ds:
                raise ValueError(
                    f"Grid cell {i}: faults row {j} targets ds={a}, out of "
                    f"range for num_ds={num_ds}"
                )
        else:
            if a != MW and not 0 <= a < num_ds:
                raise ValueError(
                    f"Grid cell {i}: faults row {j} endpoint_a={a} is "
                    f"neither MW (-1) nor a ds in range for num_ds={num_ds}"
                )
            if not 0 <= b < num_ds:
                raise ValueError(
                    f"Grid cell {i}: faults row {j} endpoint_b={b}, out of "
                    f"range for num_ds={num_ds}"
                )
            if a == b:
                raise ValueError(
                    f"Grid cell {i}: faults row {j} links ds={a} to itself"
                )
        if end <= start:
            raise ValueError(
                f"Grid cell {i}: faults row {j} "
                + (
                    f"recovers at {end}us, which is not after its crash "
                    f"at {start}us"
                    if kind == KIND_CRASH
                    else f"ends at {end}us, which is not after its start "
                    f"at {start}us"
                )
            )
        if kind == KIND_DEGRADE and sev <= 0:
            raise ValueError(
                f"Grid cell {i}: faults row {j} is a degrade with "
                f"severity={sev}; need a positive milli-scale RTT "
                f"multiplier (e.g. 3000 = 3x)"
            )
        for res in _fault_row_resources(kind, a, b):
            for (c0, r0), j0 in live.get(res, ()):
                if start < r0 and c0 < end:
                    what = "ds" if res[0] == "ds" else "link"
                    name = res[1] if len(res) == 2 else f"{res[1]}<->{res[2]}"
                    raise ValueError(
                        f"Grid cell {i}: faults rows {j0} and {j} overlap "
                        f"on {what}={name} ([{c0}, {r0}) vs "
                        f"[{start}, {end}) us)"
                    )
            live.setdefault(res, []).append(((start, end), j))
    return tuple(rows)


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
            if c.get("faults") is not None:
                c["faults"] = _validate_cell_faults(i, c["faults"], self.num_ds)
            rt = c.get("replica_tau")
            if rt is not None and len(rt) != self.num_ds:
                raise ValueError(
                    f"Grid cell {i}: replica_tau has {len(rt)} entries, "
                    f"need one per data source (num_ds={self.num_ds}; use "
                    f"INF_US for data sources without a replica)"
                )
            skew = c.get("clock_skew_us")
            if skew is not None and (
                not isinstance(skew, int) or isinstance(skew, bool) or skew < 0
            ):
                raise ValueError(
                    f"Grid cell {i}: clock_skew_us must be a non-negative "
                    f"integer (microseconds of worst-case clock offset), "
                    f"got {skew!r}"
                )
        # the fault axis is static-shaped: every cell must carry the same
        # number of schedule rows (F) so the worlds stack into one batch
        fault_cells = [i for i, c in enumerate(cells) if c.get("faults") is not None]
        if fault_cells:
            i0 = fault_cells[0]
            self.max_faults = len(cells[i0]["faults"])
            for i, c in enumerate(cells):
                f = c.get("faults")
                if f is None:
                    raise ValueError(
                        f"Grid cell {i}: no fault schedule, but cell {i0} "
                        f"has {self.max_faults} rows — fault schedules are a "
                        "static axis; give every cell a schedule (pad "
                        "fault-free cells with (INF_US, 0, INF_US) rows)"
                    )
                if len(f) != self.max_faults:
                    raise ValueError(
                        f"Grid cell {i}: fault schedule has {len(f)} rows "
                        f"but cell {i0} has {self.max_faults} — pad shorter "
                        "schedules with (INF_US, 0, INF_US) rows so every "
                        "cell shares one static shape"
                    )
        else:
            self.max_faults = 0
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
        if key == "faults":
            # one schedule is depth 2 (rows of numbers); a sweep is depth 3
            if len(val) > 0 and isinstance(val[0], (list, tuple)) and (
                len(val[0]) > 0 and isinstance(val[0][0], (list, tuple))
            ):
                return [tuple(tuple(r) for r in sched) for sched in val]
            return [tuple(tuple(r) if isinstance(r, (list, tuple)) else r for r in val)]
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

    def labels(self, i: int) -> dict:
        """Cell i's row labels: every non-vector cell key (preset included)."""
        return _row_labels(self.cells[i])

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
            faults=c.get("faults"),
            max_faults=self.max_faults,
            replica_tau=c.get("replica_tau"),
            repl_lag_us=c.get("repl_lag_us", 0),
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

    def _cfg_for(self, faults) -> SimConfig:
        """The run's config: `max_faults` follows the worlds' schedule
        shape ([..., F, 6]); the Simulator's own config is untouched."""
        F = int(faults.shape[-2])
        if F == self.cfg.max_faults:
            return self.cfg
        return dataclasses.replace(self.cfg, max_faults=F)

    def _run(self, worlds: WorldSpec, bank: Bank, bank_batched: bool, strategy: str):
        cfg = self._cfg_for(worlds.faults)
        bank = bank_to(bank, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        states, metrics, steps = simulate_batch(
            cfg, bank, worlds, bank_batched=bank_batched, strategy=strategy,
            device=self.device,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        for i, m in enumerate(metrics):
            if m["noops"] != 0:
                raise RuntimeError(f"cell {i}: {m['noops']} noop events fired")
        return cfg, states, metrics, steps, wall, bank

    def run(self, world: WorldSpec, bank: Bank, *, labels: dict | None = None) -> RunResult:
        """Run ONE world (a single lockstep lane)."""
        self._check_bank(bank, batched=False)
        worlds = tree_map(lambda x: x[None], world)
        cfg, states, metrics, steps, wall, bank = self._run(worlds, bank, False, "vmap")
        return RunResult(
            cfg=cfg, states=states, metrics=metrics, cells=[dict(labels or {})],
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
        cfg, states, metrics, steps, wall, bank = self._run(
            grid.worlds(), bank, bank_batched, resolved
        )
        return RunResult(
            cfg=dataclasses.replace(cfg, lockstep=True), states=states,
            metrics=metrics, cells=[dict(c) for c in grid.cells], strategy=strategy,
            wall_s=wall, steps=steps, bank=bank,
            bank_batched=bank_batched, batched=True, strategy_resolved=resolved,
        )

    def resume(self, result: RunResult, **kw) -> RunResult:
        raise not_ported("Simulator.resume", "A5")
