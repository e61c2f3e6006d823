"""Shared benchmark harness, the port's counterpart of the reference's
`benchmarks/common.py`: a thin client of `repro_torch.core.engine`.

`run_sweep` turns a grid of cells into a `Grid` and runs it through a
`Simulator` as [B] lockstep lanes on one device, returning the `RunResult`;
with `record` it saves the run under ``sweeps.<tag>`` in the port's bench
file (`engine.api.BENCH_FILE`, or `path`).
"""

from __future__ import annotations

from repro_torch.core import workloads
from repro_torch.core.engine import Grid, RunResult, Simulator


def run_sweep(
    tag: str,
    cells: list,
    bank,
    terminals: int,
    *,
    banks: list | None = None,
    horizon_s: float = 10.0,
    warmup_s: float = 2.0,
    record: bool = True,
    path=None,
    drain: bool = True,
    device=None,
) -> RunResult:
    """Run a grid of cells as one batched run; returns the RunResult.

    cells: dicts validated by `Grid` (required key ``preset``; engine axes
           rtt_ms, tau_true_us, jitter_milli, exec_scale_milli, seed, faults,
           replica_tau, repl_lag_us, clock_skew_us; any other key is a label).
    bank:  Bank shared by every cell, or None with `banks` (one per cell).
    drain: the windowed drain (the default) or the single-event step.
    """
    grid = Grid(cells, banks=banks)
    b0 = banks[0] if banks is not None else bank
    sim = Simulator.from_bank(b0, terminals=terminals, horizon_s=horizon_s, warmup_s=warmup_s,
                              drain=drain, device=device)
    res = sim.run_grid(grid, bank)
    for c, m in zip(cells, res.metrics):
        m["preset"] = c["preset"]
        # per-cell cost is amortized over the lanes; the grid's wall goes in
        # sweep_wall_s
        m["wall_s"] = round(res.wall_s / len(cells), 2)
        m["sweep_wall_s"] = round(res.wall_s, 1)
    if record:
        res.save(tag, path)
    return res


def ycsb_bank(terminals: int, theta: float = 0.9, dist_ratio: float = 0.2, seed: int = 0):
    """The figures' YCSB bank (4 data sources, 1M records a node, 5 ops a
    transaction, one round): 256 transactions a terminal."""
    cfg = workloads.YCSBConfig(
        num_ds=4,
        records_per_node=1_000_000,
        ops_per_txn=5,
        dist_ratio=dist_ratio,
        theta=theta,
        rounds=1,
        seed=seed,
    )
    return workloads.make_ycsb_bank(cfg, terminals, txns_per_terminal=256)
