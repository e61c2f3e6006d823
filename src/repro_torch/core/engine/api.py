"""Public simulation API: `Simulator` + `Grid` + `RunResult` (port of
`repro.core.engine.api`).

* **`Grid`** — a validated sweep over the engine axes `preset`, `rtt_ms`,
  `tau_true_us`, `jitter_milli` (default **30**, as the reference),
  `exec_scale_milli`, `seed`, `clock_skew_us`, the fault axes `faults`
  (typed rows or legacy crash triples, validated per cell, one row count
  across cells), `replica_tau` and `repl_lag_us`, plus free-form labels and
  optional per-cell Banks; the reference's validation messages.
* **`Simulator`** — runs a Grid's cells on its device type (`device=None`
  means CUDA; it raises when no card is present), as [B] lockstep lanes
  (`strategy="vmap"`, what `auto` picks on one card), as sequential lanes,
  one after another (`strategy="map"`, what `auto` picks on the CPU; the
  slow path on the card), or split over every visible device
  (`strategy="mesh"`, what `auto` picks when the census
  `launch.mesh.local_devices` counts more than one; `mesh_devices` caps
  it), each slice on the lanes `auto` picks for one device. `drain` defaults
  to True, as the reference: each step is the windowed drain
  (`fused._omni_window` on lockstep lanes, `apply._drain_step` on map
  lanes); `drain=False` steps `omni._omni_step` / `step._step`.
  `.resume(result)` continues a result's states to a later horizon (in
  place: the result's states must not be reused), on any placement. A
  grid's fault row count sets the run's
  `SimConfig.max_faults`.
* **`RunResult`** — final states (batched over cells), one metric dict per
  cell, the step count, wall time; `.rows()`, `.world(i)`,
  `.drain`, `.events`, `.with_states(states)`, and `.save(tag)`, which
  records the run under ``sweeps.<tag>`` in the port's own bench file
  (`BENCH_FILE`, the reference's schema, with the torch runtime and the
  card's name and power limit in place of the jax keys).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
import time
from typing import Any

import torch

from repro_torch.device import card_info, resolve_device
from repro_torch.core.netmodel import INF_US, PAPER_RTT_MS
from repro_torch.core.protocols import PRESETS, ProtocolConfig
from repro_torch.core.workloads import Bank, bank_to, stack_banks
from repro_torch.core.engine.metrics import drain_stats, world_index
from repro_torch.core.engine.placement import (
    mesh_device_count, resolve_strategy, simulate_batch,
)
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
    tree_leaves,
    tree_map,
)

# engine-owned axes a Grid cell may set; everything else is a free-form label
GRID_AXES = (
    "preset", "rtt_ms", "tau_true_us", "jitter_milli", "exec_scale_milli",
    "seed", "faults", "replica_tau", "repl_lag_us", "clock_skew_us",
)
_VECTOR_AXES = ("rtt_ms", "tau_true_us", "exec_scale_milli", "replica_tau")
_NON_LABEL_AXES = ("tau_true_us", "exec_scale_milli", "faults", "replica_tau")

# the port's bench file: never the reference's results/bench/BENCH_engine.json
BENCH_DIR = pathlib.Path("results/bench_torch")
BENCH_FILE = BENCH_DIR / "BENCH_engine.json"


# ---------------------------------------------------------------------------
# bench records (the reference's `{"sweeps": {...}, "smoke": {...}}` schema)
# ---------------------------------------------------------------------------


def runtime_env(device=None) -> dict:
    """The runtime a run measured on, recorded in every bench entry: the
    torch and CUDA versions, the device type the run used and the card
    count, and the card's name and power limit as nvidia-smi prints them
    (``"cpu"`` and None on the CPU)."""
    dev = resolve_device(device)
    return {
        "torch_version": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "torch_backend": dev.type,
        "torch_device_count": torch.cuda.device_count() if dev.type == "cuda" else 1,
        **card_info(dev),
    }


def load_bench(path=None) -> dict:
    p = pathlib.Path(path) if path is not None else BENCH_FILE
    if p.exists():
        with open(p) as f:
            return json.load(f)
    return {"sweeps": {}, "smoke": {}}


def _write_bench(bench: dict, path) -> None:
    p = pathlib.Path(path) if path is not None else BENCH_FILE
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(bench, f, indent=1, default=float)


def record_bench(tag: str, entry: dict, path=None, *, device=None) -> dict:
    """Merge one sweep's record into the bench file under ``sweeps.<tag>``,
    with `runtime_env(device)`'s keys."""
    entry = {**entry, **runtime_env(device)}
    bench = load_bench(path)
    bench.setdefault("sweeps", {})[tag] = entry
    _write_bench(bench, path)
    return entry


def record_smoke(entry: dict, path=None, *, device=None) -> dict:
    """Write the smoke's record (``smoke``) into the bench file, with
    `runtime_env(device)`'s keys."""
    entry = {**entry, **runtime_env(device)}
    bench = load_bench(path)
    bench["smoke"] = entry
    _write_bench(bench, path)
    return entry


def _layout(states) -> tuple:
    """(leaf name, shape, dtype, device) of every leaf of `states`."""
    return tuple((n, tuple(x.shape), x.dtype, x.device) for n, x in tree_leaves(states))


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

    def with_banks(self, banks) -> "Grid":
        return Grid(self.cells, banks=banks, default_rtt_ms=self.default_rtt_ms)

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
    wall_s: float  # wall time of the run, synchronised
    # vmap: lockstep steps executed (all lanes together, idle tail
    # included); map: the lanes' sequential steps (loop iterations) summed
    steps: int
    bank: Any = None
    bank_batched: bool = False
    batched: bool = True
    strategy_resolved: str = "vmap"
    mesh_devices: int = 1
    # the states' leaves as the run left them: what `Simulator.resume` holds
    # `states` (perhaps replaced through `with_states`) to
    layout: tuple = dataclasses.field(default=(), repr=False, compare=False)

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

    def with_states(self, states) -> "RunResult":
        """Copy with substituted states (e.g. `tau_true` edited for an online
        re-configuration segment, before `Simulator.resume`). Nothing is
        recomputed from the edited leaves."""
        return dataclasses.replace(self, states=states)

    def save(self, tag: str, path=None) -> dict:
        """Record this run under ``sweeps.<tag>`` in the port's bench file
        (`BENCH_FILE` unless `path`): the reference's keys, its jax runtime
        keys replaced by `runtime_env`'s, plus ``steps`` (`RunResult.steps`)."""
        d = self.drain
        entry = {
            "worlds": len(self.metrics),
            "terminals": self.cfg.terminals,
            "events": self.events,
            "wall_s": round(self.wall_s, 2),
            "events_per_sec": round(self.events / max(self.wall_s, 1e-9), 1),
            "strategy": self.strategy,
            "strategy_resolved": self.strategy_resolved or self.strategy,
            "mesh_devices": self.mesh_devices,
            "horizon_s": self.cfg.horizon_us / 1e6,
            "drain_hit_rate": d["drain_hit_rate"],
            "mean_window_len": d["mean_window_len"],
            "loop_iters": d["loop_iters"],
            "window_stops": d["window_stops"],
            "plan_fused": d["plan_fused"],
            "availability": d["availability"],
            "abort_causes": d["abort_causes"],
            "commits_during_fault": d["commits_during_fault"],
            "link_downtime_us": d["link_downtime_us"],
            "stale_reads": d["stale_reads"],
            "failovers": d["failovers"],
            "max_staleness_us": d["max_staleness_us"],
            "wan_rounds": d["wan_rounds"],
            "fast_commits": d["fast_commits"],
            "steps": self.steps,
        }
        return record_bench(tag, entry, path, device=self.states.now.device)


class Simulator:
    """Facade over the engine, fixed to one set of static shapes.

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

    def _run(self, cfg: SimConfig, bank: Bank, bank_batched: bool, strategy: str, *,
             worlds: WorldSpec | None = None, states=None, mesh_devices: int = 1):
        """One timed, synchronised `simulate_batch` call: fresh from `worlds`,
        or continuing `states` in place. Returns the config that ran (the
        placement's), the final states, the metrics, the steps, the wall
        time and the bank on this device."""
        bank = bank_to(bank, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        cfg, states, metrics, steps = simulate_batch(
            cfg, bank, worlds, bank_batched=bank_batched, states=states, strategy=strategy,
            mesh_devices=mesh_devices, device=self.device,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        for i, m in enumerate(metrics):
            if m["noops"] != 0:
                raise RuntimeError(f"cell {i}: {m['noops']} noop events fired")
        return cfg, states, metrics, steps, wall, bank

    def run(self, world: WorldSpec, bank: Bank, *, labels: dict | None = None) -> RunResult:
        """Run ONE world (a single lockstep lane; its states keep the [1] lane
        axis)."""
        self._check_bank(bank, batched=False)
        worlds = tree_map(lambda x: x[None], world)
        cfg, states, metrics, steps, wall, bank = self._run(
            self._cfg_for(worlds.faults), bank, False, "vmap", worlds=worlds
        )
        return RunResult(
            cfg=cfg, states=states, metrics=metrics, cells=[dict(labels or {})],
            strategy="vmap", wall_s=wall, steps=steps, bank=bank, bank_batched=False,
            batched=False, layout=_layout(states),
        )

    def run_grid(self, grid: Grid, bank: Bank | None = None, *, strategy: str = "auto",
                 mesh_devices: int | None = None) -> RunResult:
        """Run every cell of a Grid on this device type: as [B] lockstep
        lanes (``"vmap"``), as sequential lanes, one after another
        (``"map"``), or split over the worlds mesh (``"mesh"``:
        `mesh_devices` devices, default every one the census counts);
        ``"auto"`` is resolved by `placement.resolve_strategy`. `bank` is
        shared by every cell unless the Grid carries per-cell banks."""
        resolved = resolve_strategy(strategy, device=self.device)
        ndev = mesh_device_count(resolved, mesh_devices, self.device)
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
        worlds = grid.worlds()
        cfg, states, metrics, steps, wall, bank = self._run(
            self._cfg_for(worlds.faults), bank, bank_batched, resolved, worlds=worlds,
            mesh_devices=ndev,
        )
        return RunResult(
            cfg=cfg, states=states, metrics=metrics, cells=[dict(c) for c in grid.cells],
            strategy=strategy, wall_s=wall, steps=steps, bank=bank,
            bank_batched=bank_batched, batched=True, strategy_resolved=resolved,
            mesh_devices=ndev, layout=_layout(states),
        )

    def _check_states(self, result: RunResult) -> None:
        """Every leaf of `result.states` as the last run left it: same
        name, shape, dtype and device, and that device this Simulator's.
        Nothing is broadcast, cast or moved."""
        got = _layout(result.states)
        if [g[0] for g in got] != [w[0] for w in result.layout]:
            raise ValueError("result.states is not the SimState the run left")
        for (name, shape, dtype, dev), (_, w_shape, w_dtype, w_dev) in zip(got, result.layout):
            for what, g, w in (("shape", shape, w_shape), ("dtype", dtype, w_dtype),
                               ("device", dev, w_dev)):
                if g != w:
                    raise ValueError(
                        f"result.states.{name} has {what} {g}, but the run left {w}: a "
                        "state edited through with_states must keep every leaf's shape, "
                        "dtype and device"
                    )
            if dev.type != self.device.type:
                raise ValueError(
                    f"result.states.{name} is on {dev}, but this Simulator runs on "
                    f"{self.device}"
                )

    def resume(self, result: RunResult, *, horizon_s: float | None = None,
               warmup_s: float | None = None, strategy: str | None = None,
               mesh_devices: int | None = None) -> RunResult:
        """Continue a finished run's states (batched or single-world).

        `horizon_s` extends the absolute horizon (a continuation with the
        old horizon is a no-op: every pending event already lies beyond
        it); `warmup_s` re-gates the metric warmup for the continued span.
        Both are rounded to the microsecond, not truncated, as the
        reference does (`horizon_s` often arrives as ``now / 1e6 +
        delta``). The fault shape (`max_faults`) is the result's. The
        placement defaults to the original run's: the same requested
        strategy and, on the mesh, the same device count; a mesh
        continuation re-splits the states onto the mesh's devices and
        copies the result back into them.

        The run steps `result.states`' own tensors in place, the port's
        form of the reference's donated buffers: `result.states` (and any
        result sharing its tensors) holds the continued states afterwards
        and must not be reused as the state it was. Every leaf must still
        have the shape, dtype and device the run left it with (`ValueError`
        otherwise, naming the leaf); a leaf replaced through `with_states`
        is read as it is, and nothing derived from it is recomputed."""
        strategy = strategy if strategy is not None else result.strategy
        resolved = resolve_strategy(strategy, device=self.device)
        if mesh_devices is None and resolved == "mesh" and result.mesh_devices > 1:
            mesh_devices = result.mesh_devices
        ndev = mesh_device_count(resolved, mesh_devices, self.device)
        self._check_states(result)
        cfg = result.cfg
        if horizon_s is not None:
            cfg = dataclasses.replace(cfg, horizon_us=round(horizon_s * 1e6))
        if warmup_s is not None:
            cfg = dataclasses.replace(cfg, warmup_us=round(warmup_s * 1e6))
        cfg, states, metrics, steps, wall, bank = self._run(
            cfg, result.bank, result.bank_batched, resolved, states=result.states,
            mesh_devices=ndev,
        )
        return RunResult(
            cfg=cfg, states=states, metrics=metrics, cells=result.cells, strategy=strategy,
            wall_s=wall, steps=steps, bank=bank, bank_batched=result.bank_batched,
            batched=result.batched, strategy_resolved=resolved, mesh_devices=ndev,
            layout=_layout(states),
        )
